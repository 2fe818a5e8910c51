"""Port parity for homogeneous ogbn-mag against the JAX package on the
CPU: ``MagNet`` (optimized EGConv names, self-loops for every aggregator,
352 columns cut to 349) at one and two aggregators from the same weights,
the mag weight port with its comb column permutation, and ``MagConfig``'s
hooks.

Tolerances: values rtol = atol = 1e-4, gradients relative L2 <= 1e-4,
the loss rtol 1e-5; the state dict equal to ``export_model_state``.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from egc_tpu.data import synthetic as jsyn
from egc_tpu.exp import fullgraph as jfg
from egc_tpu.exp.weight_port import _comb_perm, export_model_state
from egc_tpu.models.nets import MagNet as JMagNet

from egc_tpu_torch.exp import fullgraph as tfg
from egc_tpu_torch.exp.runner import check_config
from egc_tpu_torch.exp.weight_port import mag_state_dict_from_jax
from egc_tpu_torch.models.nets import MagNet
from egc_tpu_torch.nn.conv.egc import comb_perm

torch.set_num_threads(2)
HIDDEN, HEADS, BASES = 16, 2, 2
AGGRS = {1: ("symnorm",), 2: ("symnorm", "max")}


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def both():
    raw = jsyn.synthetic_full_graph(num_nodes=300, avg_degree=8,
                                    num_classes=349, num_features=24,
                                    seed=4)
    return (raw, jfg.full_graph_to_device_dict(raw, use_kernel=False),
            tfg.full_graph_to_device_dict(raw, device="cpu"))


def nets(a):
    jm = JMagNet(hidden_dim=HIDDEN, num_layers=2, dropout=0.0, heads=HEADS,
                 bases=BASES, aggrs=AGGRS[a])
    tm = MagNet(HIDDEN, num_layers=2, dropout=0.0, heads=HEADS, bases=BASES,
                aggrs=AGGRS[a], num_features=24)
    return jm, tm


@pytest.mark.parametrize("shape", [(2, 2, 1), (2, 2, 2), (4, 3, 2),
                                   (8, 4, 1), (3, 2, 3)])
def test_comb_perm_equals_jax(shape):
    np.testing.assert_array_equal(comb_perm(*shape), _comb_perm(*shape))


@pytest.mark.parametrize("a", [1, 2])
def test_weight_port_equals_export_model_state(both, a):
    """``mag_state_dict_from_jax`` gives ``export_model_state``'s dict key
    for key and in order, and it loads strictly; at A = 2 the comb rows
    are really permuted (at A = 1 the permutation is the identity)."""
    _, jd, _ = both
    jm, tm = nets(a)
    variables = to_np(jm.init(jax.random.PRNGKey(0), jd["graph"],
                              train=False))
    ref = export_model_state("mag", "egc", variables, heads=HEADS,
                             bases=BASES, aggrs=AGGRS[a])
    got = mag_state_dict_from_jax(variables, heads=HEADS, bases=BASES,
                                  num_aggrs=a)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    tm.load_state_dict(got, strict=True)
    assert set(tm.state_dict()) == set(ref)
    w = np.asarray(variables["params"]["EGConv_0"]["comb"]["kernel"]).T
    same = np.array_equal(got["convs.0.comb_weight.weight"].numpy(), w)
    assert same == (a == 1)


@pytest.mark.parametrize("a", [1, 2])
def test_magnet_forward_and_step_match_jax(both, a):
    """Eval output and, at dropout 0, the NLL on the train split and every
    gradient of one step, against the JAX MagNet with the same weights."""
    raw, jd, td = both
    jm, tm = nets(a)
    variables = to_np(jm.init(jax.random.PRNGKey(1), jd["graph"],
                              train=False))
    tm.load_state_dict(mag_state_dict_from_jax(
        variables, heads=HEADS, bases=BASES, num_aggrs=a), strict=True)
    n = raw["x"].shape[0]
    ref = np.asarray(jm.apply(variables, jd["graph"], train=False))
    tm.eval()
    with torch.no_grad():
        got = tm(td["graph"]).numpy()
    assert got.shape[1] == ref.shape[1] == 349
    np.testing.assert_allclose(got[:n], ref[:n], rtol=1e-4, atol=1e-4)

    def loss_j(p):
        out = jm.apply({"params": p}, jd["graph"], train=True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return jfg.FullGraphConfig.loss_fn(
            None, out, (jd["y"], jd["masks"]["train"]), jd["graph"])

    lj, grads = jax.value_and_grad(loss_j)(variables["params"])
    tm.train()
    out = tm(td["graph"])
    lt = tfg.masked_nll(out, td["y"], td["masks"]["train"])
    lt.backward()
    assert lt.item() == pytest.approx(float(lj), rel=1e-5)
    g_sd = mag_state_dict_from_jax({"params": to_np(grads)}, heads=HEADS,
                                   bases=BASES, num_aggrs=a)
    for name, p in tm.named_parameters():
        assert rel_l2(p.grad.numpy(), g_sd[name]) <= 1e-4, name


def test_mag_config_surface_equals_jax():
    jcfg = jfg.MagConfig("egc", 16, heads=2, bases=2)
    tcfg = tfg.MagConfig("egc", 16, heads=2, bases=2, device="cpu")
    assert dataclasses.asdict(tcfg.settings()) == \
        dataclasses.asdict(jcfg.settings())
    assert not tcfg.settings().checkpoint_at_end
    assert dataclasses.asdict(tcfg.stoppers()) == \
        dataclasses.asdict(jcfg.stoppers())
    assert (tcfg.trial_metric().name, tcfg.trial_metric().mode) == \
        (jcfg.trial_metric().name, jcfg.trial_metric().mode)
    assert tcfg.default_hparams() == jcfg.default_hparams()
    assert tcfg.search_strategy().points == jcfg.search_strategy().points \
        == {}
    hp = tcfg.default_hparams()
    assert tuple(tcfg.plateau(hp)) == tuple(jcfg.plateau(hp))
    assert tcfg.num_layers == jcfg.num_layers == 2
    raw_t, raw_j = tcfg.load_full_graph(), jcfg.load_full_graph()
    for k in raw_j:
        np.testing.assert_array_equal(np.asarray(raw_t[k]),
                                      np.asarray(raw_j[k]), err_msg=k)
    assert raw_t["x"].shape == (6000, 128) and raw_t["num_classes"] == 349


def test_mag_config_hooks_run_a_trial(monkeypatch):
    """``check_config`` through MagConfig's hooks on a smaller synthetic
    mag graph: MagNet h16 H2 B2 symnorm, two iterations, finite loss and
    accuracies; the softmax keyword reaches the conv spec."""
    small = jsyn.synthetic_full_graph(num_nodes=400, avg_degree=6,
                                      num_classes=349, num_features=128,
                                      seed=2)
    monkeypatch.setattr(tfg.MagConfig, "load_full_graph",
                        lambda self: small)
    cfg = tfg.MagConfig("egc", 16, heads=2, bases=2, device="cpu")
    res = check_config(cfg, 2, verbose=False)
    assert len(res["history"]) == 2
    for row in res["history"]:
        assert np.isfinite(row["train_loss"])
        assert 0.0 <= row["val_acc"] <= 1.0
    assert isinstance(res["model"], MagNet)
    assert res["model"].convs[0].self_loop_mode == "all"
    assert set(res["test"]) == {"train_acc", "val_acc", "test_acc"}
    soft = tfg.MagConfig("egc", 16, softmax=True, device="cpu")
    assert soft.conv_spec().softmax and not cfg.conv_spec().softmax
