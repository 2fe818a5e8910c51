"""Port parity for heterogeneous ogbn-mag (rmag) against the JAX package
on the CPU: the hetero container and its padding, the bipartite kernel
plan and ``bipartite_multi_aggregate`` (against the JAX fused path in
Pallas interpret mode and against its segment path), ``RGCNConv`` and
``REGConv`` with the JAX weights, ``REGCNet``'s forward and one Adam step
of ``RMagConfig``, the synthetic set and the on-disk reader, the weight
port, the config surface and a trial that learns.

Tolerances: values rtol = atol = 1e-4, gradients relative L2 <= 1e-4,
the loss rtol 1e-5; the state dict equal to ``export_model_state`` key
for key; data arrays equal.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from egc_tpu.data import ondisk as jod
from egc_tpu.data import synthetic as jsyn
from egc_tpu.exp import hetero as jhet
from egc_tpu.exp.weight_port import export_model_state
from egc_tpu.graph import hetero as jhg
from egc_tpu.nn.conv import hetero as jconv
from egc_tpu.ops import dispatch as jdisp
from egc_tpu.ops import segment as jseg

from egc_tpu_torch.data import ondisk as tod
from egc_tpu_torch.data import synthetic as tsyn
from egc_tpu_torch.exp import hetero as thet
from egc_tpu_torch.exp.runner import run_trial
from egc_tpu_torch.exp.weight_port import rmag_state_dict_from_jax
from egc_tpu_torch.graph import hetero as thg
from egc_tpu_torch.nn.conv import hetero as tconv
from egc_tpu_torch.ops.dispatch import (
    bipartite_multi_aggregate, build_bipartite_kernel_plan,
    build_kernel_plan,
)

torch.set_num_threads(2)
AGGRS = ("sum", "mean", "max", "min")
SMALL_GEOM = dict(fwd_block_rows=128, fwd_window_rows=256,
                  bwd_block_rows=256, bwd_window_rows=128)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture
def interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl
    import egc_tpu.ops.pallas.gather_reduce as gr

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(gr.pl, "pallas_call", patched)


def bipartite_graph(seed=0, n_src=150, n_dst=90, e=600, f=72):
    """``tests/test_hetero.py``'s bipartite graph: coalesced random edges,
    30% of them masked."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n_src, e).astype(np.int32)
    r = rng.integers(0, n_dst, e).astype(np.int32)
    s, r = np.unique(np.stack([s, r]), axis=1)
    mask = rng.random(len(s)) > 0.3
    x = rng.normal(size=(n_src, f)).astype(np.float32)
    return x, s, r, mask


def tiny_hetero(seed=0, featureless_b=False):
    """Two types and two relations (``tests/test_hetero.py``'s), ``b``
    featureless when asked."""
    rng = np.random.default_rng(seed)
    nodes = {"a": rng.normal(size=(5, 6)).astype(np.float32),
             "b": (np.zeros((4, 0), np.float32) if featureless_b
                   else rng.normal(size=(4, 6)).astype(np.float32))}
    edges = {
        jhg.rel_key("a", "to", "b"): (np.array([0, 1, 2, 0], np.int32),
                                      np.array([0, 0, 1, 3], np.int32)),
        jhg.rel_key("b", "back", "a"): (np.array([0, 1], np.int32),
                                        np.array([2, 4], np.int32)),
    }
    return nodes, edges


# ---------------------------------------------------------------------------
# the container and the plan
# ---------------------------------------------------------------------------

def test_rel_keys_equal_jax():
    key = thg.rel_key("paper", "has_topic", "field_of_study")
    assert key == jhg.rel_key("paper", "has_topic", "field_of_study")
    assert thg.split_rel_key(key) == jhg.split_rel_key(key)
    assert tconv.torch_rel_key(key) == "paper_has_topic_field_of_study"


def test_hetero_from_numpy_equals_jax():
    """Padding (``n + 1`` rows rounded to 8, edges to 128, pad edges
    masked at the last row of each side), types and relations sorted."""
    raw = tsyn.synthetic_rmag(num_paper=90, num_author=45, num_inst=7,
                              num_fos=11, num_classes=5, num_features=12,
                              seed=3)
    got = thg.hetero_from_numpy(raw["nodes"], raw["edges"])
    ref = jhg.hetero_from_numpy(raw["nodes"], raw["edges"])
    assert got.node_types == ref.node_types
    assert got.relations == ref.relations
    for field in ("nodes", "node_mask", "senders", "receivers", "edge_mask"):
        a, b = getattr(got, field), getattr(ref, field)
        assert list(a) == list(b), field
        for k in b:
            assert a[k].numpy().dtype == np.asarray(b[k]).dtype, (field, k)
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]),
                                          err_msg=f"{field}[{k}]")
    for t in got.node_types:
        assert got.num_nodes(t) == ref.num_nodes(t)
    assert got.kernel_plans is None
    moved = thg.attach_hetero_kernel_plans(got).to("cpu")
    assert sorted(moved.kernel_plans) == got.relations


def test_bipartite_plan_layout():
    """CSR over the destination rows and CSC over the source rows of the
    unmasked edges, ``fwd_to_bwd`` the CSC position of each CSR edge,
    ``deg`` over the destination rows, the original edge of each."""
    x, s, r, mask = bipartite_graph()
    n_src, n_dst = x.shape[0], 90
    plan = build_bipartite_kernel_plan(s, r, n_src, n_dst, edge_mask=mask)
    assert (plan.num_nodes, plan.num_src, plan.src_rows) == \
        (n_dst, n_src, n_src)
    kept = np.nonzero(mask)[0]
    assert plan.num_edges == len(kept) < len(s)
    assert plan.rowptr.shape == (n_dst + 1,)
    assert plan.colptr.shape == (n_src + 1,)
    np.testing.assert_array_equal(
        plan.rowptr.numpy(),
        np.concatenate([[0], np.cumsum(np.bincount(r[kept],
                                                   minlength=n_dst))]))
    np.testing.assert_array_equal(
        plan.colptr.numpy(),
        np.concatenate([[0], np.cumsum(np.bincount(s[kept],
                                                   minlength=n_src))]))
    np.testing.assert_array_equal(
        plan.deg.numpy(), np.bincount(r[kept], minlength=n_dst))
    fp, bp = plan.fwd_perm.numpy(), plan.bwd_perm.numpy()
    assert set(fp) == set(bp) == set(kept)      # masked edges dropped
    np.testing.assert_array_equal(plan.fwd_senders.numpy(), s[fp])
    np.testing.assert_array_equal(plan.bwd_receivers.numpy(), r[bp])
    assert np.all(np.diff(r[fp]) >= 0) and np.all(np.diff(s[bp]) >= 0)
    np.testing.assert_array_equal(bp[plan.fwd_to_bwd.numpy()], fp)


def test_bipartite_plan_rejects_out_of_range_endpoints():
    x, s, r, mask = bipartite_graph()
    n_src = x.shape[0]
    for bad_s, bad_r, n_dst in ((s, np.where(r == 3, 90, r), 90),
                                (np.where(s == 5, n_src, s), r, 90),
                                (s, r, 60), (s, np.where(r == 3, -1, r), 90)):
        with pytest.raises(ValueError, match="out of range"):
            build_bipartite_kernel_plan(bad_s, bad_r, n_src, n_dst)
    # a masked edge may point anywhere: it never enters the plan
    far = np.where(mask, r, 10_000)
    plan = build_bipartite_kernel_plan(s, far, n_src, 90, edge_mask=mask)
    assert plan.num_edges == int(mask.sum())


def test_homogeneous_plan_is_unchanged():
    """``build_kernel_plan`` keeps its one row count and its check."""
    _, s, r, mask = bipartite_graph(n_src=90)
    plan = build_kernel_plan(s, r, 90, edge_mask=mask)
    assert plan.num_src is None and plan.src_rows == plan.num_nodes == 90
    with pytest.raises(ValueError, match=r"out of range.*\[0, 60\)"):
        build_kernel_plan(s, r, 60)


# ---------------------------------------------------------------------------
# the bipartite aggregate
# ---------------------------------------------------------------------------

def _port_aggregate(x, s, r, mask, n_dst, proj):
    n_src = x.shape[0]
    plan = build_bipartite_kernel_plan(s, r, n_src, n_dst, edge_mask=mask)
    xt = torch.tensor(x, requires_grad=True)
    out = bipartite_multi_aggregate(xt, plan, AGGRS)
    (out * torch.from_numpy(proj)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_bipartite_aggregate_equals_jax_fused(seed, interpret_pallas):
    """sum / mean / max / min and the gradient against the JAX fused
    bipartite path (Pallas in interpret mode, small geometry)."""
    x, s, r, mask = bipartite_graph(seed)
    n_src, f = x.shape
    n_dst = 90
    proj = np.random.default_rng(seed + 10).normal(
        size=(n_dst, len(AGGRS), f)).astype(np.float32)
    plan = jdisp.build_bipartite_kernel_plan(s, r, n_src, n_dst,
                                             edge_mask=mask, **SMALL_GEOM)

    def fused(v):
        return jdisp.bipartite_multi_aggregate(v, plan, AGGRS)[:n_dst]

    xj = jnp.asarray(x)
    ref = np.asarray(fused(xj))
    g_ref = np.asarray(jax.grad(lambda v: jnp.sum(fused(v) * proj))(xj))
    got, g_got = _port_aggregate(x, s, r, mask, n_dst, proj)
    assert got.shape == ref.shape == (n_dst, len(AGGRS), f)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert rel_l2(g_got, g_ref) <= 1e-4


@pytest.mark.parametrize("seed", [0, 1])
def test_bipartite_aggregate_equals_jax_segment_path(seed):
    """The same against the JAX masked segment ops (the path every CPU
    run of the JAX package takes), empty destination rows included."""
    x, s, r, mask = bipartite_graph(seed, n_dst=200)
    n_src, f = x.shape
    n_dst = 200
    proj = np.random.default_rng(seed + 20).normal(
        size=(n_dst, len(AGGRS), f)).astype(np.float32)
    fns = {"sum": jseg.segment_sum, "mean": jseg.segment_mean,
           "max": jseg.segment_max, "min": jseg.segment_min}

    def xla(v):
        gathered = jnp.take(v, jnp.asarray(s), axis=0)
        return jnp.stack([fns[a](gathered, jnp.asarray(r), n_dst,
                                 mask=jnp.asarray(mask)) for a in AGGRS],
                         axis=1)

    xj = jnp.asarray(x)
    ref = np.asarray(xla(xj))
    g_ref = np.asarray(jax.grad(lambda v: jnp.sum(xla(v) * proj))(xj))
    got, g_got = _port_aggregate(x, s, r, mask, n_dst, proj)
    assert (np.bincount(r[mask], minlength=n_dst) == 0).any()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert rel_l2(g_got, g_ref) <= 1e-4


def test_bipartite_aggregate_checks_its_input():
    x, s, r, mask = bipartite_graph()
    plan = build_bipartite_kernel_plan(s, r, x.shape[0], 90, edge_mask=mask)
    with pytest.raises(ValueError, match="rows"):
        bipartite_multi_aggregate(torch.zeros(90, 4), plan, ("sum",))
    with pytest.raises(ValueError, match="does not support"):
        bipartite_multi_aggregate(torch.from_numpy(x), plan, ("std",))


# ---------------------------------------------------------------------------
# the convs
# ---------------------------------------------------------------------------

def _conv_pair(kind, seed, featureless_b=False):
    nodes, edges = tiny_hetero(seed, featureless_b)
    hg_j = jax.tree.map(jnp.asarray, jhg.hetero_from_numpy(nodes, edges))
    hg_t = thg.hetero_from_numpy(nodes, edges)
    x_j = {t: hg_j.nodes[t] for t in hg_j.node_types}
    if kind == "regc":
        jc = jconv.REGConv(8, num_heads=2, num_bases=2)
        tc = tconv.REGConv(6, 8, hg_t.node_types, hg_t.relations,
                           num_heads=2, num_bases=2)
        module = "REGConv_0"
    else:
        jc = jconv.RGCNConv(3)
        tc = tconv.RGCNConv({t: 6 for t in hg_t.node_types}, 3,
                            hg_t.relations)
        module = "RGCNConv_0"
    params = to_np(jc.init(jax.random.PRNGKey(seed), hg_j, x_j)["params"])
    sd = rmag_state_dict_from_jax(
        {"params": {module: params}}, relations=hg_t.relations,
        node_types=hg_t.node_types, model_kind="rgcn")
    tc.load_state_dict({k[len("convs.0."):]: v for k, v in sd.items()},
                       strict=True)
    return jc, tc, params, hg_j, hg_t, module


@pytest.mark.parametrize("kind", ["rgcn", "regc"])
@pytest.mark.parametrize("seed", [0, 1])
def test_conv_equals_jax(kind, seed):
    """Every output type's rows (padding included) and the gradients of
    every weight and input of sum(out ** 2 * proj), the JAX weights
    carried across."""
    jc, tc, params, hg_j, hg_t, module = _conv_pair(kind, seed)
    rng = np.random.default_rng(seed + 30)
    x_np = {t: np.asarray(hg_j.nodes[t]) for t in hg_j.node_types}
    width = 8 if kind == "regc" else 3
    proj = {t: rng.normal(size=(hg_t.num_nodes(t), width)).astype(np.float32)
            for t in hg_t.node_types}

    def loss_j(p, x):
        out = jc.apply({"params": p}, hg_j, x)
        return sum(jnp.sum(out[t] ** 2 * proj[t]) for t in out), out

    (lj, out_j), (gp, gx) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(
        params, {t: jnp.asarray(v) for t, v in x_np.items()})
    x_t = {t: torch.tensor(v, requires_grad=True) for t, v in x_np.items()}
    out_t = tc(hg_t, x_t)
    lt = sum((out_t[t] ** 2 * torch.from_numpy(proj[t])).sum()
             for t in out_t)
    lt.backward()
    assert sorted(out_t) == sorted(out_j)
    for t in out_j:
        np.testing.assert_allclose(out_t[t].detach().numpy(),
                                   np.asarray(out_j[t]), rtol=1e-4,
                                   atol=1e-4)
    assert lt.item() == pytest.approx(float(lj), rel=1e-5)
    g_sd = rmag_state_dict_from_jax(
        {"params": {module: to_np(gp)}}, relations=hg_t.relations,
        node_types=hg_t.node_types, model_kind="rgcn")
    for name, p in tc.named_parameters():
        assert rel_l2(p.grad.numpy(), g_sd["convs.0." + name]) <= 1e-4, name
    for t in x_t:
        assert rel_l2(x_t[t].grad.numpy(), np.asarray(gx[t])) <= 1e-4, t


@pytest.mark.parametrize("kind", ["rgcn", "regc"])
def test_conv_out_types_compute_only_those(kind):
    """``out_types`` gives those types' rows as the full conv does."""
    _, tc, _, _, hg_t, _ = _conv_pair(kind, 2)
    x = {t: hg_t.nodes[t] for t in hg_t.node_types}
    full = tc(hg_t, x)
    part = tc(hg_t, x, out_types=["b"])
    assert list(part) == ["b"]
    torch.testing.assert_close(part["b"], full["b"], rtol=0, atol=0)


def test_regconv_through_the_plans_equals_the_segment_path(monkeypatch):
    """REGConv with each relation through its bipartite plan (the path a
    CUDA tensor takes; here the kernels' plain versions) against the
    masked segment ops: values and gradients."""
    _, tc, _, _, hg_t, _ = _conv_pair("regc", 3)
    hg_p = thg.attach_hetero_kernel_plans(hg_t)

    def run(hg):
        x = {t: hg.nodes[t].clone().requires_grad_(True)
             for t in hg.node_types}
        tc.zero_grad(set_to_none=True)
        out = tc(hg, x)
        sum((o ** 3).sum() for o in out.values()).backward()
        return out, x, {n: p.grad.clone() for n, p in tc.named_parameters()}

    ref = run(hg_t)
    monkeypatch.setattr(
        tconv, "_rel_multi_aggregate",
        lambda hg, key, x_src, n_dst, aggrs: bipartite_multi_aggregate(
            x_src, hg.kernel_plans[key], aggrs))
    got = run(hg_p)
    for t in ref[0]:
        np.testing.assert_allclose(got[0][t].detach().numpy(),
                                   ref[0][t].detach().numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert rel_l2(got[1][t].grad, ref[1][t].grad) <= 1e-5
    for n in ref[2]:
        assert rel_l2(got[2][n], ref[2][n]) <= 1e-5, n


def test_a_device_tensor_without_a_plan_raises():
    """Off the CPU a relation needs its plan: no fallback to the segment
    ops (a meta tensor stands in for a CUDA one here)."""
    _, _, _, _, hg_t, _ = _conv_pair("regc", 0)
    with pytest.raises(RuntimeError, match="kernel plan"):
        tconv._rel_multi_aggregate(hg_t, hg_t.relations[0],
                                   torch.empty(8, 4, device="meta"), 8,
                                   ("mean",))


# ---------------------------------------------------------------------------
# the net, the config and one step
# ---------------------------------------------------------------------------

SMALL_RMAG = dict(num_paper=300, num_author=150, num_inst=20, num_fos=30,
                  num_classes=6, num_features=32, seed=4)
HP = {"lr": 0.01, "wd": 1e-3, "dropout": 0.0}


@pytest.fixture(scope="module")
def rmag_pair():
    """The JAX and the port's RMagConfig (h16 H4 B2) on the same
    ``synthetic_rmag`` of 300 papers, their data and the JAX state."""
    jcfg = jhet.RMagConfig(16, heads=4, bases=2)
    jcfg.load_hetero = lambda: jsyn.synthetic_rmag(**SMALL_RMAG)
    tcfg = thet.RMagConfig(16, heads=4, bases=2, device="cpu")
    tcfg.load_hetero = lambda: tsyn.synthetic_rmag(**SMALL_RMAG)
    jd, td = jcfg.data(HP), tcfg.data(HP)
    jmodel = jcfg.model(HP)
    jstate = jcfg.init_state(jmodel, HP, jd, 0)
    return jcfg, tcfg, jd, td, jmodel, jstate


def _spec(td):
    hg = td["hetero"]
    return dict(relations=hg.relations, node_types=hg.node_types,
                featureless_types=td["featureless"])


def _ported_model(tcfg, td, params):
    model = tcfg.model(HP)
    model.load_state_dict(rmag_state_dict_from_jax(
        {"params": to_np(params)}, **_spec(td)), strict=True)
    return model


def test_rmag_forward_equals_jax(rmag_pair):
    """Eval log-probabilities of every paper row from the same weights."""
    jcfg, tcfg, jd, td, jmodel, jstate = rmag_pair
    ref = np.asarray(jmodel.apply({"params": jstate.params}, jd["hetero"],
                                  train=False))
    model = _ported_model(tcfg, td, jstate.params).eval()
    with torch.no_grad():
        got = model(td["hetero"]).numpy()
    assert got.shape == ref.shape == (td["hetero"].num_nodes("paper"), 6)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_rmag_step_equals_jax(rmag_pair):
    """One ``RMagConfig.train`` step at dropout 0: the loss, every
    gradient (zeros where the loss does not reach, as JAX gives them) and
    every parameter after the Adam step with L2 decay."""
    jcfg, tcfg, jd, td, jmodel, jstate = rmag_pair
    hg, (y, m) = jd["hetero"], (jd["y"], jd["masks"]["train"])

    def loss_j(p):
        out = jmodel.apply({"params": p}, hg, train=True,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        nll = -jnp.take_along_axis(out, y[:, None], axis=1)[:, 0]
        mf = m.astype(out.dtype)
        return jnp.sum(nll * mf) / jnp.maximum(jnp.sum(mf), 1.0)

    lj, grads = jax.value_and_grad(loss_j)(jstate.params)
    new_state, row_j = jcfg.train(jmodel, jstate, jd, jax.random.PRNGKey(0),
                                  0)
    assert row_j["train_loss"] == pytest.approx(float(lj), rel=1e-6)

    model = _ported_model(tcfg, td, jstate.params)
    opt = tcfg.init_state(model, HP, td, 0)
    _, row_t = tcfg.train(model, opt, td, tcfg.rng(0), 0)
    assert row_t["train_loss"] == pytest.approx(float(lj), rel=1e-5)
    g_sd = rmag_state_dict_from_jax({"params": to_np(grads)}, **_spec(td))
    new_sd = rmag_state_dict_from_jax({"params": to_np(new_state.params)},
                                      **_spec(td))
    zero = 0
    for name, p in model.named_parameters():
        ref = g_sd[name].numpy()
        if not ref.any():
            zero += 1
            assert not p.grad.any(), name
        else:
            assert rel_l2(p.grad.numpy(), ref) <= 1e-4, name
        assert rel_l2(p.detach().numpy(), new_sd[name]) <= 1e-4, name
    # the loss reaches no output of institution's in the last layer and
    # none of its root or relation mix in the first
    assert zero > 0


def test_rmag_layers_compute_what_the_target_reads(rmag_pair):
    _, tcfg, _, td, _, _ = rmag_pair
    model = tcfg.model(HP)
    assert model.layer_out_types() == [
        ["author", "field_of_study", "paper"], ["paper"]]


def test_rmag_config_surface_equals_jax(rmag_pair):
    jcfg, tcfg, jd, td, _, _ = rmag_pair
    for a, b in ((tcfg.settings(), jcfg.settings()),
                 (tcfg.stoppers(), jcfg.stoppers())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (tcfg.trial_metric().name, tcfg.trial_metric().mode) == \
        (jcfg.trial_metric().name, jcfg.trial_metric().mode)
    assert tcfg.default_hparams() == jcfg.default_hparams()
    tspace, jspace = tcfg.hyperparams(), jcfg.hyperparams()
    assert {k: v.choices for k, v in tspace.items()} == \
        {k: v.choices for k, v in jspace.items()}
    assert tcfg.search_strategy().points == jcfg.search_strategy().points \
        == {}
    hp = tcfg.default_hparams()
    assert tuple(tcfg.plateau(hp)) == tuple(jcfg.plateau(hp))
    assert tcfg.num_layers == jcfg.num_layers == 2
    assert td["featureless"] == jd["featureless"]
    assert (td["num_classes"], td["in_features"]) == \
        (jd["num_classes"], jd["in_features"])
    np.testing.assert_array_equal(td["y"].numpy(), np.asarray(jd["y"]))
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(td["masks"][split].numpy(),
                                      np.asarray(jd["masks"][split]))
    # a CPU config runs the plain path: no plans
    assert td["hetero"].kernel_plans is None


def test_rmag_trains():
    """``run_trial`` on RMagConfig learns (``tests/test_hetero.py``'s
    trial): 6 classes on a homophilous paper graph."""
    cfg = thet.RMagConfig(32, heads=4, bases=2, device="cpu")
    cfg.load_hetero = lambda: tsyn.synthetic_rmag(**SMALL_RMAG)
    hp = {"lr": 0.01, "wd": 0.0, "dropout": 0.2}
    res = run_trial(cfg, hp, seed=0, max_iterations=25, patience=50,
                    verbose=False)
    accs = [h["val_acc"] for h in res["history"]]
    assert max(accs) > 0.4, accs


# ---------------------------------------------------------------------------
# data and the weight port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(SMALL_RMAG),
                                dict(num_paper=50, num_author=9, seed=7)])
def test_synthetic_rmag_equals_jax(kw):
    got, ref = tsyn.synthetic_rmag(**kw), jsyn.synthetic_rmag(**kw)
    assert list(got) == list(ref)
    for k in ("nodes", "edges"):
        assert list(got[k]) == list(ref[k]), k
        for name in ref[k]:
            a, b = got[k][name], ref[k][name]
            pairs = zip(a, b) if k == "edges" else [(a, b)]
            for x, y in pairs:
                assert x.dtype == y.dtype and x.shape == y.shape, name
                np.testing.assert_array_equal(x, y, err_msg=name)
    for k in ("y", "train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got[k].dtype == ref[k].dtype, k
    assert got["num_classes"] == ref["num_classes"]


def _write_mag_hetero(root, with_counts):
    import gzip
    import json

    def write(path, arr, fmt="%d"):
        path.parent.mkdir(parents=True, exist_ok=True)
        with gzip.open(path, "wt") as f:
            np.savetxt(f, np.asarray(arr), delimiter=",", fmt=fmt)

    rng = np.random.default_rng(5)
    raw = root / "ogbn_mag" / "raw"
    n_paper = 12
    write(raw / "node-feat" / "paper" / "node-feat.csv.gz",
          rng.normal(size=(n_paper, 4)), fmt="%.7g")
    write(raw / "node-label" / "paper" / "node-label.csv.gz",
          (np.arange(n_paper) % 5).reshape(-1, 1))
    sizes = {"author": 9, "institution": 3, "field_of_study": 6,
             "paper": n_paper}
    for src, rel, dst, e in (("author", "affiliated_with", "institution", 7),
                             ("author", "writes", "paper", 20),
                             ("paper", "cites", "paper", 15),
                             ("paper", "has_topic", "field_of_study", 18)):
        edges = np.stack([rng.integers(0, sizes[src] - 1, e),
                          rng.integers(0, sizes[dst] - 1, e)], axis=1)
        write(raw / "relations" / f"{src}___{rel}___{dst}" / "edge.csv.gz",
              edges)
    if with_counts:
        (raw / "num-node-dict.json").write_text(json.dumps(sizes))
    split = root / "ogbn_mag" / "split" / "time" / "paper"
    for name, idx in (("train", range(0, 7)), ("valid", range(7, 10)),
                      ("test", range(10, 12))):
        write(split / f"{name}.csv.gz", np.asarray(list(idx)).reshape(-1, 1))


@pytest.mark.parametrize("with_counts", [True, False])
def test_load_ogbn_mag_hetero_equals_jax(tmp_path, with_counts):
    """The reader on tiny files in ogbn-mag's layout, each package on its
    own copy: every array equal, dtypes included, with and without
    ``num-node-dict.json``."""
    roots = tmp_path / "port", tmp_path / "jax"
    for root in roots:
        _write_mag_hetero(root, with_counts)
    got = tod.load_ogbn_mag_hetero(roots[0])
    ref = jod.load_ogbn_mag_hetero(roots[1])
    assert list(got) == list(ref)
    for k in ("nodes", "edges"):
        assert list(got[k]) == list(ref[k]), k
        for name in ref[k]:
            a, b = got[k][name], ref[k][name]
            for x, y in (zip(a, b) if k == "edges" else [(a, b)]):
                assert x.dtype == y.dtype and x.shape == y.shape, name
                np.testing.assert_array_equal(x, y, err_msg=name)
    for k in ("y", "train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got[k].dtype == ref[k].dtype, k
    assert got["num_classes"] == ref["num_classes"]
    assert len(got["edges"]) == 7


@pytest.mark.parametrize("use_egc", [True, False])
def test_weight_port_equals_export_model_state(use_egc):
    """``rmag_state_dict_from_jax`` gives ``export_model_state``'s dict
    key for key and in order, and the port's REGCNet (the padded
    embedding rows) takes it strictly."""
    nodes, edges = tiny_hetero(0, featureless_b=True)
    nodes["a"] = nodes["a"][:, :6]
    hg_j = jax.tree.map(jnp.asarray, jhg.hetero_from_numpy(nodes, edges))
    jm = jconv.REGCNet(hidden_dim=8, num_layers=2, use_egc=use_egc, heads=2,
                       bases=2, num_classes=5, in_features=6,
                       featureless_types=("b",), target_type="a")
    variables = to_np(jm.init(jax.random.PRNGKey(0), hg_j, train=False))
    kind = "regc" if use_egc else "rgcn"
    spec = dict(relations=tuple(sorted(edges)), node_types=("a", "b"),
                featureless_types=("b",))
    ref = export_model_state("rmag", kind, variables, **spec)
    got = rmag_state_dict_from_jax(variables, model_kind=kind, **spec)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    hg_t = thg.hetero_from_numpy(nodes, edges)
    tm = tconv.REGCNet(8, node_types=hg_t.node_types,
                       relations=hg_t.relations,
                       num_nodes={t: hg_t.num_nodes(t)
                                  for t in hg_t.node_types},
                       use_egc=use_egc, heads=2, bases=2, num_classes=5,
                       in_features=6, featureless_types=("b",),
                       target_type="a")
    tm.load_state_dict(got, strict=True)
    assert list(tm.state_dict()) == list(ref)
    assert got["embs.b"].shape == (hg_t.num_nodes("b"), 6) == (8, 6)
    tm.eval()
    with torch.no_grad():
        out = tm(hg_t).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jm.apply(variables, hg_j, train=False)), rtol=1e-4,
        atol=1e-4)
