"""Port parity for the zinc, cifar and molhiv slices against the JAX
package on the CPU: the synthetic generators, ``ZincNet`` / ``CifarNet``
/ ``HIVNet`` (EGC-M and GATv2, and HIVNet GIN) from the same weights
through the weight port, the configs' loss and metrics, their loaders'
batches, and a dropout-on step's keep rate.

Tolerances: generators and batches array-equal; values rtol = atol =
1e-4, gradients relative L2 <= 1e-4, the loss rtol 1e-5. Parity runs at
dropout 0: the two frameworks draw other dropout masks.
"""

import dataclasses
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from egc_tpu.data import synthetic as jsyn
from egc_tpu.exp import batched as jb
from egc_tpu.exp.weight_port import export_model_state
from egc_tpu.graph.structure import batch_np as jbatch
from egc_tpu.models import nets as jnets

from egc_tpu_torch.data import synthetic as tsyn
from egc_tpu_torch.exp import batched as tb
from egc_tpu_torch.exp.weight_port import batched_state_dict_from_jax
from egc_tpu_torch.graph.structure import batch_np
from egc_tpu_torch.models import nets as tnets
from egc_tpu_torch.train import optim as toptim
from egc_tpu_torch.train.loop import fold_in, train_step

torch.set_num_threads(2)
GENERATORS = ("synthetic_zinc", "synthetic_cifar", "synthetic_molhiv")
GRAPH_FIELDS = ("nodes", "senders", "receivers", "node_mask", "edge_mask",
                "graph_ids", "graph_mask")
# each dataset's EGC-M aggregators (scripts/train_main_table.sh:16,21,32)
AGGRS = {"zinc": ("add", "std", "max"), "cifar": ("symadd", "std", "max"),
         "hiv": ("add", "mean", "max")}
NETS = {"zinc": (jnets.ZincNet, tnets.ZincNet),
        "cifar": (jnets.CifarNet, tnets.CifarNet),
        "hiv": (jnets.HIVNet, tnets.HIVNet)}
CONFIGS = {"zinc": (jb.ZincConfig, tb.ZincConfig),
           "cifar": (jb.CifarConfig, tb.CifarConfig),
           "hiv": (jb.MolConfig, tb.MolConfig)}
CASES = [("zinc", "egc"), ("zinc", "gatv2"), ("cifar", "egc"),
         ("cifar", "gatv2"), ("hiv", "egc"), ("hiv", "gatv2"),
         ("hiv", "gin")]
HIDDEN, LAYERS = 16, 3


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", GENERATORS)
@pytest.mark.parametrize("kw", [dict(num_graphs=30, seed=2),
                                dict(num_graphs=7)])
def test_generators_equal_jax(name, kw):
    got, ref = getattr(tsyn, name)(**kw), getattr(jsyn, name)(**kw)
    assert list(got) == ["train", "val", "test"]
    for split in got:
        assert len(got[split]) == len(ref[split])
        for a, b in zip(got[split], ref[split]):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                assert a[k].dtype == b[k].dtype, k


def _splits(dataset):
    gen = {"zinc": "synthetic_zinc", "cifar": "synthetic_cifar",
           "hiv": "synthetic_molhiv"}[dataset]
    return getattr(tsyn, gen)(num_graphs=24, seed=5)


def _batches(dataset, n_graphs=6):
    graphs = _splits(dataset)["train"][:n_graphs]
    kw = dict(num_nodes=sum(len(g["nodes"]) for g in graphs) + 8,
              num_edges=sum(len(g["senders"]) for g in graphs) + 16,
              num_graphs=n_graphs + 2)
    return batch_np(graphs, **kw), jbatch(graphs, **kw)


def _spec(dataset, kind):
    if kind == "egc":
        return dict(kind="egc", heads=2, bases=2, aggrs=AGGRS[dataset])
    if kind == "gatv2":
        return dict(kind="gatv2", heads=2)
    return dict(kind=kind)


def nets_of(dataset, kind):
    jcls, tcls = NETS[dataset]
    spec = _spec(dataset, kind)
    jm = jcls(conv=jnets.ConvSpec(**spec), hidden_dim=HIDDEN,
              num_layers=LAYERS)
    tm = tcls(tnets.ConvSpec(**spec), HIDDEN, num_layers=LAYERS)
    return jm, tm


def _init(jm, jg, seed=1):
    return to_np(jm.init(jax.random.PRNGKey(seed),
                         jax.tree.map(jnp.asarray, jg), train=False))


@pytest.mark.parametrize("dataset,kind", CASES)
def test_weight_port_equals_export_model_state(dataset, kind):
    """The rules give ``export_model_state``'s dict, key for key and in
    order, and it loads strictly (cifar's conv and BN at ``.1`` / ``.2``;
    the readout MLP at the reference's Sequential indices)."""
    _, (jg, _) = _batches(dataset)
    jm, tm = nets_of(dataset, kind)
    variables = _init(jm, jg)
    spec = dict(bases=2) if kind == "egc" else {}
    ref = export_model_state(dataset, kind, variables, **spec)
    got = batched_state_dict_from_jax(dataset, variables, bases=2)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    tm.load_state_dict(got, strict=True)
    assert set(tm.state_dict()) == set(ref)
    slot = 1 if dataset == "cifar" else 0
    assert f"graph_layers.0.{slot + 1}.running_var" in ref
    assert "mlp.8.weight" in ref and "mlp.5.running_mean" in ref


def _zero_grad_names(dataset):
    """Parameters whose true gradient is 0: a bias right before a
    BatchNorm (each conv's, GIN's net's, the readout's first two
    Linears')."""
    slot = 1 if dataset == "cifar" else 0
    return rf"graph_layers\.\d+\.{slot}\.(nn\.)?bias|mlp\.[04]\.bias"


def _jax_step(dataset, jm, variables, jg, jy):
    params, bstats = variables["params"], variables["batch_stats"]
    jcfg = CONFIGS[dataset][0]

    def loss_fn(p):
        out, mutated = jm.apply({"params": p, "batch_stats": bstats}, jg,
                                train=True,
                                rngs={"dropout": jax.random.PRNGKey(0)},
                                mutable=["batch_stats"])
        return jcfg.loss_fn(None, out, jy, jg), \
            (out, mutated["batch_stats"])

    (loss, (out, new_bs)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    return float(loss), np.asarray(out), to_np(grads), to_np(new_bs)


@pytest.mark.parametrize("dataset,kind", CASES)
def test_net_forward_and_step_match_jax(dataset, kind):
    """Eval and training-mode outputs, the loss and every gradient of one
    step, and the BN running stats after it, against the JAX net with the
    same weights on the same padded batch (dropout 0)."""
    (tg, ty), (jg, jy) = _batches(dataset)
    jg = jax.tree.map(jnp.asarray, jg)
    jm, tm = nets_of(dataset, kind)
    variables = _init(jm, jg, seed=3)
    sd = batched_state_dict_from_jax(dataset, variables, bases=2)
    tm.load_state_dict(sd, strict=True)
    real = tg.graph_mask.numpy()

    tm.eval()
    with torch.no_grad():
        got = tm(tg).numpy()
    ref = np.asarray(jm.apply(variables, jg, train=False))
    np.testing.assert_allclose(got[real], ref[real], rtol=1e-4, atol=1e-4)

    loss_j, out_j, grads, new_bs = _jax_step(dataset, jm, variables, jg,
                                             jnp.asarray(jy))
    tcfg = CONFIGS[dataset][1](kind, HIDDEN, device="cpu")
    opt = toptim.make_optimizer(tm.parameters(), 1e-3)
    tm.train()
    with torch.no_grad():
        out_t = tm(tg).numpy()
    np.testing.assert_allclose(out_t[real], out_j[real], rtol=1e-4,
                               atol=1e-4)
    tm.load_state_dict(sd, strict=True)     # undo the BN stats update
    loss_t = train_step(tm, opt, tcfg.loss_fn, tg, torch.as_tensor(ty))
    assert loss_t.item() == pytest.approx(loss_j, rel=1e-5)

    g_sd = batched_state_dict_from_jax(
        dataset, {"params": grads, "batch_stats": new_bs}, bases=2)
    names = dict(tm.named_parameters())
    scale = max(float(np.abs(g_sd[k].numpy()).max()) for k in names)
    zero = _zero_grad_names(dataset)
    for name, p in names.items():
        if re.fullmatch(zero, name):
            for g in (p.grad.numpy(), g_sd[name].numpy()):
                assert np.abs(g).max() <= 1e-5 * scale, name
            continue
        assert rel_l2(p.grad.numpy(), g_sd[name]) <= 1e-4, name
    for name, buf in tm.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), g_sd[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


class _G:
    def __init__(self, mask, framework):
        self.graph_mask = framework(mask)


@pytest.mark.parametrize("dataset", ["zinc", "cifar", "hiv"])
def test_loss_and_eval_metrics_equal_jax(dataset):
    """The same outputs through both configs' ``loss_fn`` and
    ``eval_metrics`` (hiv with unlabelled graphs, label -1)."""
    rng = np.random.default_rng(11)
    g = 9
    mask = np.array([1] * 7 + [0] * 2, bool)
    if dataset == "cifar":
        out = rng.normal(size=(g, 10)).astype(np.float32)
        y = rng.integers(0, 10, (g, 1)).astype(np.int32)
    else:
        out = rng.normal(size=(g, 1)).astype(np.float32)
        y = (rng.normal(size=(g, 1)).astype(np.float32) if dataset == "zinc"
             else rng.integers(0, 2, (g, 1)).astype(np.int32))
        if dataset == "hiv":
            y[3, 0] = -1
    jcls, tcls = CONFIGS[dataset]
    jcfg, tcfg = jcls("egc", 16, aggrs=("sum",)), \
        tcls("egc", 16, aggrs=("sum",), device="cpu")
    ref = float(jcfg.loss_fn(jnp.asarray(out), jnp.asarray(y),
                             _G(mask, jnp.asarray)))
    got = tcfg.loss_fn(torch.as_tensor(out), torch.as_tensor(y),
                       _G(mask, torch.as_tensor))
    assert got.item() == pytest.approx(ref, rel=1e-6)
    if dataset == "hiv":
        y[3, 0] = 0        # the metric reads the real graphs' labels
    collected = [(out, y, mask), (out[::-1].copy(), y, ~mask)]
    got, ref = tcfg.eval_metrics(collected, "val"), \
        jcfg.eval_metrics(collected, "val")
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-6), k


@pytest.mark.parametrize("dataset", ["zinc", "cifar", "hiv"])
def test_config_surface_equals_jax(dataset):
    """Settings, stopper, trial metric, search space defaults and the
    search strategy and pruner of each config."""
    jcls, tcls = CONFIGS[dataset]
    jcfg, tcfg = jcls("egc", 16, aggrs=("sum",)), \
        tcls("egc", 16, aggrs=("sum",), device="cpu")
    assert dataclasses.asdict(tcfg.settings()) == \
        dataclasses.asdict(jcfg.settings())
    assert dataclasses.asdict(tcfg.stoppers()) == \
        dataclasses.asdict(jcfg.stoppers())
    assert (tcfg.trial_metric().name, tcfg.trial_metric().mode) == \
        (jcfg.trial_metric().name, jcfg.trial_metric().mode)
    assert tcfg.default_hparams() == jcfg.default_hparams()
    assert type(tcfg.search_strategy()).__name__ == \
        type(jcfg.search_strategy()).__name__
    assert getattr(tcfg.search_strategy(), "points", None) == \
        getattr(jcfg.search_strategy(), "points", None)
    tp, jp = tcfg.trial_scheduler(), jcfg.trial_scheduler()
    assert (tp.rungs, tp.reduction, tp.sign) == \
        (jp.rungs, jp.reduction, jp.sign)
    assert tcfg.conv.avg_log_deg == jcfg.conv.avg_log_deg == 1.0


@pytest.mark.parametrize("dataset", ["zinc", "cifar", "hiv"])
def test_config_data_equals_jax_loaders(dataset, monkeypatch):
    """``data`` gives each split's loader the JAX config's batches, array
    for array, the shuffled train split over two epochs."""
    splits = _splits(dataset)
    jcls, tcls = CONFIGS[dataset]
    jcfg, tcfg = jcls("egc", 16, aggrs=("sum",)), \
        tcls("egc", 16, aggrs=("sum",), device="cpu")
    monkeypatch.setattr(jcls, "load_graphs", lambda self: splits)
    monkeypatch.setattr(tcls, "load_graphs", lambda self: splits)
    hp = {"batch_size": 5}
    jd, td = jcfg.data(hp), tcfg.data(hp)
    assert list(jd) == list(td) == ["train", "val", "test"]
    for name in jd:
        assert td[name].budget == jd[name].budget
        for _ in range(2):
            got, ref = list(td[name]), list(jd[name])
            assert len(got) == len(ref)
            for (tg, ty), (jg, jy) in zip(got, ref):
                for f in GRAPH_FIELDS:
                    np.testing.assert_array_equal(
                        getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                        err_msg=f"{name} {f}")
                np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("dataset,p", [("cifar", 0.3), ("hiv", 0.2)])
def test_dropout_step_keeps_the_configured_rate(dataset, p, monkeypatch):
    """One ``train`` iteration with dropout on: every dropout site keeps
    its entries at rate 1 - p (cifar before each conv, hiv once on the
    input); the iteration's generator is a fold of the trial's, so the
    same iteration redraws the same masks and the next one others."""
    splits = _splits(dataset)
    cls = CONFIGS[dataset][1]
    monkeypatch.setattr(cls, "load_graphs", lambda self: splits)
    cfg = cls("egc", HIDDEN, heads=2, bases=2, aggrs=AGGRS[dataset],
              num_layers=2, device="cpu")
    hp = {**cfg.default_hparams(), "dropout": p, "batch_size": 8}
    data = cfg.data(hp)
    model = cfg.model(hp, seed=0)
    state = cfg.init_state(model, hp, data, 0)
    rates, masks = [], []
    dropout = tnets.dropout

    def recording(x, q, training, generator=None):
        out = dropout(x, q, training, generator)
        if training and q > 0:
            kept = (out != 0)[x != 0]
            rates.append((float(kept.float().mean()), kept.numel()))
            masks.append(out == 0)
        return out

    monkeypatch.setattr(tnets, "dropout", recording)
    rng = cfg.rng(0)
    state, row = cfg.train(model, state, data, rng, 0)
    assert np.isfinite(row["train_loss"])
    sites = 2 if dataset == "cifar" else 1
    assert len(rates) == sites * len(data["train"])
    kept = sum(r * n for r, n in rates) / sum(n for _, n in rates)
    total = sum(n for _, n in rates)
    assert abs(kept - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / total)
    first = [m.clone() for m in masks]
    model.load_state_dict(cfg.model(hp, seed=0).state_dict())
    masks.clear()
    # the same order of batches: a fresh loader with the train seed
    cfg.train(model, state, cfg.data(hp), rng, 0)
    assert all(torch.equal(a, b) for a, b in zip(first, masks))
    masks.clear()
    cfg.train(model, state, cfg.data(hp), rng, 1)
    assert not all(torch.equal(a, b) for a, b in zip(first, masks))
    g0, g1 = fold_in(rng, 0), fold_in(rng, 1)
    assert g0.initial_seed() != g1.initial_seed()
    assert fold_in(rng, 0).initial_seed() == g0.initial_seed()
