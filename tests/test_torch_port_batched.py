"""Port parity for the batched ogbg-code2 slice: the data side (the
synthetic code2 generator, ``batch_np``, ``padding_budget``,
``GraphLoader`` and ``prefetched``), ``segment_mean`` and the pools, the
encoders, the metrics and the plateau schedule, the code weight port, and
``CodeNet`` GAT and GATv2 forward and one training step, each against the
JAX package on the CPU from the same inputs and weights."""

import re

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from egc_tpu.data import synthetic as jsyn
from egc_tpu.data.loaders import GraphLoader as JLoader
from egc_tpu.data.loaders import padding_budget as jbudget
from egc_tpu.exp.batched import CodeConfig as JCodeConfig
from egc_tpu.exp.weight_port import export_model_state
from egc_tpu.graph.structure import batch_np as jbatch
from egc_tpu.models.encoders import ASTNodeEncoder as JAST
from egc_tpu.models.encoders import AtomEncoder as JAtom
from egc_tpu.models.nets import CodeNet as JCodeNet, ConvSpec as JSpec
from egc_tpu.nn import pool as jpool
from egc_tpu.ops.segment import segment_mean as jsegment_mean
from egc_tpu.train import metrics as jmetrics
from egc_tpu.train import optim as joptim

from egc_tpu_torch.data import synthetic as tsyn
from egc_tpu_torch.data.loaders import GraphLoader, padding_budget
from egc_tpu_torch.data.prefetch import prefetched
from egc_tpu_torch.exp.batched import CodeConfig, train_batched
from egc_tpu_torch.exp.weight_port import code_state_dict_from_jax
from egc_tpu_torch.graph.structure import batch_np
from egc_tpu_torch.models.encoders import ASTNodeEncoder, AtomEncoder
from egc_tpu_torch.models.nets import CodeNet, ConvSpec
from egc_tpu_torch.nn import pool as tpool
from egc_tpu_torch.nn.conv.attention import (
    fused_softmax_sum, segment_softmax_sum,
)
from egc_tpu_torch.ops.segment import segment_mean
from egc_tpu_torch.train import metrics as tmetrics
from egc_tpu_torch.train import optim as toptim
from egc_tpu_torch.train.loop import train_step

torch.set_num_threads(2)
GRAPH_FIELDS = ("nodes", "senders", "receivers", "node_mask", "edge_mask",
                "graph_ids", "graph_mask")


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def assert_batch_equal(tg, ty, jg, jy):
    for name in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)),
                                      err_msg=name)
        assert getattr(tg, name).numpy().dtype == \
            np.asarray(getattr(jg, name)).dtype, name
    np.testing.assert_array_equal(np.asarray(ty), np.asarray(jy))


@pytest.fixture(scope="module")
def code_splits():
    """Both packages' synthetic code2 at a small size (vocab 20, 30
    attributes), and the check that they are equal array for array."""
    kw = dict(num_graphs=40, seed=3, vocab_size=20, num_attrs=30)
    return tsyn.synthetic_code(**kw), jsyn.synthetic_code(**kw)


@pytest.mark.parametrize("kw", [
    dict(num_graphs=40, seed=3, vocab_size=20, num_attrs=30),
    dict(num_graphs=12, seed=0),
    dict(num_graphs=7, seed=5, vocab_size=5000, num_attrs=10030,
         max_depth=4)])
def test_synthetic_code_equals_jax(kw):
    got, ref = tsyn.synthetic_code(**kw), jsyn.synthetic_code(**kw)
    assert list(got) == ["train", "val", "test"]
    for split in got:
        assert len(got[split]) == len(ref[split])
        for a, b in zip(got[split], ref[split]):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                assert a[k].dtype == b[k].dtype, k


def test_batch_np_equals_jax():
    """With edge features and labels, and with neither."""
    rng = np.random.default_rng(1)
    graphs = []
    for n in (3, 7, 5):
        e = 2 * n
        graphs.append({"nodes": rng.normal(size=(n, 4)).astype(np.float32),
                       "senders": rng.integers(0, n, e).astype(np.int32),
                       "receivers": rng.integers(0, n, e).astype(np.int32),
                       "edges": rng.normal(size=(e, 2)).astype(np.float32),
                       "y": rng.normal(size=(3,)).astype(np.float32)})
    kw = dict(num_nodes=24, num_edges=40, num_graphs=5)
    tg, ty = batch_np(graphs, **kw)
    jg, jy = jbatch(graphs, **kw)
    assert_batch_equal(tg, ty, jg, jy)
    np.testing.assert_array_equal(tg.edges.numpy(), jg.edges)
    bare = [{k: g[k] for k in ("nodes", "senders", "receivers")}
            for g in graphs]
    tg, ty = batch_np(bare, **kw)
    jg, jy = jbatch(bare, **kw)
    assert ty is None and jy is None and tg.edges is None
    assert_batch_equal(tg, None, jg, None)
    with pytest.raises(ValueError, match="padding graph slot"):
        batch_np(graphs, num_nodes=24, num_edges=40, num_graphs=3)


@pytest.mark.parametrize("bs", [4, 7, 128])
def test_padding_budget_equals_jax(code_splits, bs):
    graphs = sum(code_splits[0].values(), [])
    assert padding_budget(graphs, bs) == jbudget(graphs, bs)
    assert padding_budget(graphs, bs, node_multiple=16, edge_multiple=64) \
        == jbudget(graphs, bs, node_multiple=16, edge_multiple=64)


def test_graph_loader_batches_equal_jax(code_splits):
    """The shuffled train loader over two epochs (its last batch padded
    with empty graph slots) and the cached eval loader read twice give the
    JAX loader's batches, array for array."""
    tsplits, jsplits = code_splits
    budget = jbudget(sum(jsplits.values(), []), 8)
    for name, shuffle in (("train", True), ("val", False)):
        jl = JLoader(jsplits[name], 8, shuffle=shuffle, seed=11,
                     budget=budget)
        tl = GraphLoader(tsplits[name], 8, shuffle=shuffle, seed=11,
                         budget=budget, device="cpu")
        assert len(tl) == len(jl) and not tl.kernel_plans
        for _ in range(2):
            got, ref = list(tl), list(jl)
            assert len(got) == len(ref) == len(jl)
            for (tg, ty), (jg, jy) in zip(got, ref):
                assert_batch_equal(tg, ty, jg, jy)
                assert tg.kernel_plan is None
        last_real = len(jsplits[name]) - 8 * (len(jl) - 1)
        assert int(got[-1][0].graph_mask.sum()) == last_real < 8
    val = GraphLoader(tsplits["val"], 8, budget=budget, device="cpu")
    first = list(val)
    assert val._cache_complete and all(
        a[0] is b[0] for a, b in zip(first, list(val)))


def test_graph_loader_prefetch_keeps_the_batches(code_splits):
    """Three prefetch threads give the batches of none, in order, over two
    shuffled epochs, and count their build time."""
    tsplits = code_splits[0]
    a = GraphLoader(tsplits["train"], 5, shuffle=True, seed=2,
                    device="cpu")
    b = GraphLoader(tsplits["train"], 5, shuffle=True, seed=2, prefetch=3,
                    device="cpu")
    for _ in range(2):
        got, ref = list(b), list(a)
        assert len(got) == len(ref) == len(a)
        for (ga, ya), (gb, yb) in zip(ref, got):
            assert_batch_equal(gb, yb, ga, ya.numpy())
    assert b.build_seconds > 0


def test_graph_loader_needs_a_card_by_default(code_splits):
    if torch.cuda.is_available():
        pytest.skip("the default device is the card here")
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphLoader(code_splits[0]["train"], 4)


def test_graph_loader_plan_leaves_padding_out(code_splits, monkeypatch):
    """A batch bound for the card carries a KernelPlan of its real edges
    only: the GAT softmax through the plan (the kernels' plain versions on
    the CPU) equals the masked segment path on the padded batch."""
    tsplits = code_splits[0]
    loader = GraphLoader(tsplits["train"], 6, device="cpu")
    loader.kernel_plans = True          # as on the card, minus the copy
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    g, _ = next(iter(loader))
    plan = g.kernel_plan
    real = int(g.edge_mask.sum())
    assert plan.num_edges == real < g.num_edges
    assert plan.num_nodes == g.num_nodes
    rng = np.random.default_rng(0)
    n = g.num_nodes
    h = torch.as_tensor(rng.normal(size=(n, 2, 3)).astype(np.float32))
    a_src = torch.as_tensor(rng.normal(size=(n, 2)).astype(np.float32))
    a_dst = torch.as_tensor(rng.normal(size=(n, 2)).astype(np.float32))
    got = fused_softmax_sum(h, a_src, a_dst, plan)
    ref = segment_softmax_sum(h, a_src, a_dst, g.senders, g.receivers,
                              g.edge_mask)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


def test_prefetched_keeps_order():
    def build(i):
        return i * i

    for workers in (0, 1, 3):
        assert list(prefetched(build, ((i,) for i in range(10)), workers)) \
            == [i * i for i in range(10)]


def _segments(rng):
    n, g = 30, 7
    ids = np.sort(rng.integers(0, g - 2, n)).astype(np.int32)  # 2 empty
    mask = rng.random(n) > 0.25
    x = rng.normal(size=(n, 5)).astype(np.float32)
    return x, ids, mask, g


def test_segment_mean_matches_jax():
    x, ids, mask, g = _segments(np.random.default_rng(3))
    for m in (None, mask):
        got = segment_mean(torch.as_tensor(x), torch.as_tensor(ids), g,
                           mask=None if m is None else torch.as_tensor(m))
        ref = jsegment_mean(jnp.asarray(x), jnp.asarray(ids), g,
                            mask=None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)
        assert np.all(got.numpy()[g - 2:] == 0)


@pytest.mark.parametrize("name", ["mean", "sum", "add", "max"])
def test_pools_match_jax(name):
    """Values and the gradient of a fixed projection, with masked rows and
    empty graph slots (0 for max too)."""
    rng = np.random.default_rng(4)
    x, ids, mask, g = _segments(rng)
    proj = rng.normal(size=(g, 5)).astype(np.float32)

    def jf(xx):
        out = jpool.get_pool(name)(xx, jnp.asarray(ids), g,
                                   jnp.asarray(mask))
        return jnp.sum(out * proj), out

    (_, jout), jgrad = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = tpool.get_pool(name)(xt, torch.as_tensor(ids), g,
                               torch.as_tensor(mask))
    (out * torch.as_tensor(proj)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-7)
    assert np.all(out.detach().numpy()[g - 2:] == 0)
    assert rel_l2(xt.grad.numpy(), jgrad) <= 1e-6
    with pytest.raises(ValueError, match="readout"):
        tpool.get_pool("median")


def test_ast_node_encoder_matches_jax():
    rng = np.random.default_rng(5)
    n = 40
    x = np.stack([rng.integers(0, 98, n), rng.integers(0, 50, n)],
                 1).astype(np.int32)
    depth = rng.integers(0, 30, n).astype(np.int32)     # some past 20
    jm = JAST(16, num_nodeattributes=50)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(depth))
    ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(depth))
    tm = ASTNodeEncoder(16, num_nodeattributes=50,
                        generator=torch.Generator().manual_seed(0))
    p = to_np(variables)["params"]
    tm.load_state_dict({f"{t}.weight": torch.as_tensor(p[j]["embedding"])
                        for j, t in (("type", "type_encoder"),
                                     ("attr", "attribute_encoder"),
                                     ("depth", "depth_encoder"))},
                       strict=True)
    got = tm(torch.as_tensor(x), torch.as_tensor(depth))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    fresh = ASTNodeEncoder(64, generator=torch.Generator().manual_seed(1))
    w = fresh.attribute_encoder.weight.detach().numpy()
    assert w.shape == (10030, 64) and abs(w.mean()) < 0.01 \
        and abs(w.std() - 1.0) < 0.01     # N(0, 1), torch's default


def test_atom_encoder_matches_jax():
    rng = np.random.default_rng(6)
    x = np.stack([rng.integers(0, d, 25) for d in
                  (119, 4, 12, 12, 10, 6, 6, 2, 2)], 1).astype(np.int32)
    jm = JAtom(8)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    p = to_np(variables)["params"]
    tm = AtomEncoder(8)
    tm.load_state_dict({f"atom_embedding_list.{i}.weight":
                        torch.as_tensor(p[f"atom_emb_{i}"]["embedding"])
                        for i in range(9)}, strict=True)
    np.testing.assert_allclose(
        tm(torch.as_tensor(x)).detach().numpy(),
        np.asarray(jm.apply(variables, jnp.asarray(x))), rtol=1e-6,
        atol=1e-6)


def test_metrics_equal_jax():
    rng = np.random.default_rng(7)
    preds = [list(rng.integers(0, 6, rng.integers(0, 5))) for _ in range(30)]
    refs = [list(rng.integers(0, 6, rng.integers(0, 5))) for _ in range(30)]
    assert tmetrics.sequence_f1(preds, refs) == \
        jmetrics.sequence_f1(preds, refs)
    assert tmetrics.sequence_f1([], []) == jmetrics.sequence_f1([], [])
    a, b = rng.integers(0, 3, 50), rng.integers(0, 3, 50)
    assert tmetrics.accuracy(a, b) == jmetrics.accuracy(a, b)
    scores = np.round(rng.normal(size=60), 1)      # ties
    labels = rng.integers(0, 2, 60)
    assert tmetrics.roc_auc(scores, labels) == \
        jmetrics.roc_auc(scores, labels)
    assert np.isnan(tmetrics.roc_auc(scores, np.zeros(60)))


@pytest.mark.parametrize("mode", ["max", "min"])
def test_plateau_sequence_equals_jax(mode):
    """A fixed metric series through 40 updates (improvements, plateaus
    past the patience, the min_lr floor): every state equals JAX's."""
    series = [0.1, 0.2, 0.2, 0.19] + [0.2] * 14 + [0.3, 0.30001] + \
        [0.25] * 20
    t = toptim.plateau_init(1e-3, mode=mode, factor=0.2, patience=3,
                            min_lr=1e-5)
    j = joptim.plateau_init(1e-3, mode=mode, factor=0.2, patience=3,
                            min_lr=1e-5)
    lrs = set()
    for v in series:
        t, j = toptim.plateau_update(t, v), joptim.plateau_update(j, v)
        assert tuple(t) == tuple(j)
        lrs.add(t.lr)
    assert len(lrs) >= 3 and min(lrs) == 1e-5
    opt = toptim.make_optimizer([torch.nn.Parameter(torch.zeros(2))], 1e-3)
    toptim.set_lr(opt, t.lr)
    assert [g["lr"] for g in opt.param_groups] == [t.lr]


def test_make_optimizer_matches_optax():
    """Three Adam steps with L2 weight decay, from the same gradients."""
    rng = np.random.default_rng(8)
    w0 = rng.normal(size=(4, 3)).astype(np.float32)
    grads = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(3)]
    tx = joptim.make_optimizer(1e-2, 5e-4)
    wj, state = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    p = torch.nn.Parameter(torch.tensor(w0))
    opt = toptim.make_optimizer([p], 1e-2, 5e-4)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, wj)
        wj = optax.apply_updates(wj, upd)
        p.grad = torch.tensor(g)
        opt.step()
    # the two Adams round their bias corrections in another order
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(wj),
                               rtol=1e-5, atol=1e-6)


def _batch(splits, split, bs):
    graphs = splits[split][:bs]
    kw = dict(num_nodes=sum(len(g["nodes"]) for g in graphs) + 8,
              num_edges=sum(len(g["senders"]) for g in graphs) + 16,
              num_graphs=bs + 2)
    return batch_np(graphs, **kw), jbatch(graphs, **kw)


def code_nets(kind, hidden=16, heads=2, layers=3, vocab=20, attrs=30):
    jm = JCodeNet(conv=JSpec(kind=kind, heads=heads), hidden_dim=hidden,
                  num_layers=layers, vocab_size=vocab,
                  num_nodeattributes=attrs)
    tm = CodeNet(ConvSpec(kind=kind, heads=heads), hidden, num_layers=layers,
                 vocab_size=vocab, num_nodeattributes=attrs)
    return jm, tm


@pytest.mark.parametrize("kind", ["gat", "gatv2"])
def test_code_weight_port_equals_export_model_state(code_splits, kind):
    """The code rules give ``export_model_state``'s dict, key for key, and
    it loads strictly into the port's CodeNet (H2, the last layer 1)."""
    _, (jg, _) = _batch(code_splits[0], "train", 4)
    jm, tm = code_nets(kind)
    variables = jm.init(jax.random.PRNGKey(2), jax.tree.map(jnp.asarray, jg),
                        train=False)
    ref = export_model_state("code", kind, to_np(variables))
    got = code_state_dict_from_jax(to_np(variables))
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    tm.load_state_dict(got, strict=True)
    assert set(tm.state_dict()) == set(ref)
    assert tuple(tm.token_predictors[4].weight.shape) == (22, 16)
    conv = tm.graph_layers[2][0]
    assert conv.heads == 1 and conv.out_channels == 16


def _jax_step(jm, variables, jg, jy):
    params, bstats = variables["params"], variables["batch_stats"]

    def loss_fn(p):
        out, mutated = jm.apply({"params": p, "batch_stats": bstats}, jg,
                                train=True,
                                rngs={"dropout": jax.random.PRNGKey(0)},
                                mutable=["batch_stats"])
        return JCodeConfig.loss_fn(None, out, jy, jg), \
            (out, mutated["batch_stats"])

    (loss, (out, new_bs)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    return float(loss), np.asarray(out), grads, new_bs


@pytest.mark.parametrize("kind", ["gat", "gatv2"])
def test_codenet_training_step_matches_jax(code_splits, kind):
    """A small CodeNet (3 layers, H2 C8 then H1 C16, vocab 20): logits in
    eval and training mode, the loss and every gradient of one step, and
    the BN running stats after it, against the JAX CodeNet with the same
    weights on the same padded batch."""
    (tg, ty), (jg, jy) = _batch(code_splits[0], "train", 6)
    jg = jax.tree.map(jnp.asarray, jg)
    jm, tm = code_nets(kind)
    variables = jm.init(jax.random.PRNGKey(3), jg, train=False)
    tm.load_state_dict(code_state_dict_from_jax(to_np(variables)),
                       strict=True)
    real = tg.graph_mask.numpy()

    tm.eval()
    with torch.no_grad():
        got = tm(tg).numpy()
    ref = np.asarray(jm.apply(variables, jg, train=False))
    assert got.shape == (tg.num_graphs, 5, 22)
    np.testing.assert_allclose(got[real], ref[real], rtol=1e-4, atol=1e-4)

    loss_j, out_j, grads, new_bs = _jax_step(jm, variables, jg,
                                             jnp.asarray(jy))
    cfg = CodeConfig(kind, 16, heads=2, num_layers=3, vocab_size=20,
                     num_nodeattributes=30)
    opt = toptim.make_optimizer(tm.parameters(), 1e-3)
    tm.train()
    with torch.no_grad():
        out_t = tm(tg).numpy()
    np.testing.assert_allclose(out_t[real], out_j[real], rtol=1e-4,
                               atol=1e-4)
    tm.load_state_dict(code_state_dict_from_jax(to_np(variables)),
                       strict=True)     # undo the BN stats update
    loss_t = train_step(tm, opt, cfg.loss_fn, tg, torch.as_tensor(ty))
    assert loss_t.item() == pytest.approx(loss_j, rel=1e-5)

    g_sd = code_state_dict_from_jax({"params": to_np(grads),
                                     "batch_stats": to_np(new_bs)})
    names = dict(tm.named_parameters())
    assert len(names) == len([k for k in g_sd if "running" not in k
                              and "num_batches" not in k])
    scale = max(float(np.abs(g_sd[k].numpy()).max()) for k in names)
    for name, p in names.items():
        if re.fullmatch(r"graph_layers\.\d+\.0\.bias", name):
            # BatchNorm follows each conv and cancels any constant shift:
            # the conv bias's true gradient is 0, rounding noise on both
            # sides
            for g in (p.grad.numpy(), g_sd[name].numpy()):
                assert np.abs(g).max() <= 1e-6 * scale, name
            continue
        assert rel_l2(p.grad.numpy(), g_sd[name]) <= 1e-4, name
    for name, buf in tm.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), g_sd[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("kind", ["gat", "gatv2"])
def test_codenet_padding_does_not_change_valid_outputs(code_splits, kind):
    """The same graphs padded to two budgets (more padding nodes, edges
    and graph slots in the second) give the same logits for every real
    graph, in training mode (masked BN statistics) and in eval mode."""
    graphs = code_splits[0]["train"][:5]
    n = sum(len(g["nodes"]) for g in graphs)
    e = sum(len(g["senders"]) for g in graphs)
    a, _ = batch_np(graphs, num_nodes=n + 1, num_edges=e, num_graphs=6)
    b, _ = batch_np(graphs, num_nodes=n + 40, num_edges=e + 90,
                    num_graphs=11)
    _, tm = code_nets(kind)
    for train in (True, False):
        tm.train(train)
        with torch.no_grad():
            oa, ob = tm(a), tm(b)
        torch.testing.assert_close(oa[:5], ob[:5], rtol=1e-5, atol=1e-5)


def test_code_loss_and_eval_metrics_equal_jax():
    rng = np.random.default_rng(9)
    g, s, v = 6, 5, 12
    out = rng.normal(size=(g, s, v)).astype(np.float32)
    y = rng.integers(0, v, (g, s)).astype(np.int32)
    y[1, 2] = v - 1                     # __EOS__ = vocab_size + 1
    out[2, 1, v - 1] = 50.0             # an EOS in a prediction
    mask = np.array([1, 1, 1, 1, 0, 0], bool)
    jcfg = JCodeConfig("gat", 16, vocab_size=v - 2)
    tcfg = CodeConfig("gat", 16, vocab_size=v - 2)

    class G:
        graph_mask = mask

    class TG:
        graph_mask = torch.as_tensor(mask)

    ref = float(jcfg.loss_fn(jnp.asarray(out), jnp.asarray(y), G))
    got = tcfg.loss_fn(torch.as_tensor(out), torch.as_tensor(y), TG)
    assert got.item() == pytest.approx(ref, rel=1e-6)
    collected = [(out, y, mask), (out[::-1].copy(), y, ~mask)]
    assert tcfg.eval_metrics(collected, "val") == \
        jcfg.eval_metrics(collected, "val")


def test_code_config_defaults_follow_jax(tmp_path, monkeypatch):
    for synthetic, vocab, attrs in ((True, 120, 500), (False, 5000, 10030)):
        cfg = CodeConfig("gat", 304, synthetic=synthetic)
        assert (cfg.vocab_size, cfg.num_nodeattributes) == (vocab, attrs)
    cfg = CodeConfig("gat", 304, vocab_size=5000, num_nodeattributes=10030)
    assert (cfg.vocab_size, cfg.num_nodeattributes) == (5000, 10030)
    cfg = CodeConfig("gat", 304, synthetic=False, use_old_code_dataset=True)
    assert cfg.num_nodeattributes == 10003
    # the real data comes from the ogbg-code2 reader, which names the
    # file it misses under an empty $DATASET_LOC
    monkeypatch.setenv("DATASET_LOC", str(tmp_path))
    with pytest.raises(FileNotFoundError,
                       match=r"ogbg_code2/raw/num-node-list\.csv\.gz"):
        CodeConfig("gat", 304, synthetic=False).load_graphs()


def test_train_batched_on_the_cpu():
    """Two epochs (the val F1 steps the plateau) and a 4-step run that
    crosses an epoch; no card unless asked."""
    cfg = CodeConfig("gat", 16, heads=2, num_layers=3, vocab_size=20,
                     num_nodeattributes=30, num_graphs=40)
    hp = {"lr": 1e-3, "batch_size": 8}
    run = train_batched(cfg, hp, epochs=2, device="cpu")
    assert [r["iteration"] for r in run.history] == [0, 1]
    assert len(run.step_losses) == len(run.step_seconds) == 2 * 4
    for row in run.history:
        assert 0.0 <= row["val_metric"] <= 1.0 and row["lr"] == 1e-3
        assert np.isfinite(row["train_loss"])
    run = train_batched(cfg, hp, steps=6, device="cpu")
    assert len(run.step_losses) == len(run.step_seconds) == 6
    assert run.history == []
    with pytest.raises(ValueError, match="exactly one"):
        train_batched(cfg, hp, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_batched(cfg, hp, steps=1)
