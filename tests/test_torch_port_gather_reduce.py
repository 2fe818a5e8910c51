"""Port parity: the fused multi-aggregate (kernel 1 forward, kernel 2
backward, through their plain versions on the CPU) against the JAX fused
path with its Pallas kernels in interpret mode."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import jax.experimental.pallas as pl
import egc_tpu.ops.pallas.gather_reduce as jgr
from egc_tpu.graph.transforms import coalesce_np, symnorm_weight as jsymw
from egc_tpu.ops import dispatch as jdsp

from egc_tpu_torch.ops import dispatch as tdsp
from egc_tpu_torch.ops.cuda import gather_reduce as tgr

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jgr.pl, "pallas_call", patched)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def small_graph(seed=0, n=300, e=1500, isolated=0):
    """Coalesced random graph; the last ``isolated`` nodes receive no
    edge (their max/min must come out 0)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n - isolated, e).astype(np.int32)
    s, r, _ = coalesce_np(s, r, n)
    return s, r, n


def jax_plan(s, r, n):
    return jdsp.build_kernel_plan(s, r, n, fwd_block_rows=128,
                                  fwd_window_rows=256, bwd_block_rows=256,
                                  bwd_window_rows=128)


def run_both(vals, s, r, n, aggrs, include_self):
    """Values and d(sum(out * proj))/d(vals) from both packages."""
    f = vals.shape[1]
    jp = jax_plan(s, r, n)
    tp = tdsp.build_kernel_plan(s, r, n)
    kw_j, kw_t = {}, {}
    if "symnorm" in aggrs:
        ew, sw = jsymw(jnp.asarray(s), jnp.asarray(r), n)
        kw_j = dict(symnorm_edge_w=ew,
                    symnorm_self_w=jnp.zeros(jp.n_pad).at[:n].set(sw))
        kw_t = dict(symnorm_edge_w=torch.tensor(np.asarray(ew)),
                    symnorm_self_w=torch.tensor(np.asarray(sw)))
    proj = np.random.default_rng(1).normal(
        size=(n, len(aggrs), f)).astype(np.float32)

    vpad = jnp.zeros((jp.n_pad, f)).at[:n].set(vals)

    def fj(v):
        return jdsp.fused_multi_aggregate(v, jp, aggrs,
                                          include_self=include_self, **kw_j)

    ref, vjp = jax.vjp(fj, vpad)
    ct = jnp.zeros(ref.shape).at[:n].set(proj)
    (g_ref,) = vjp(ct)

    vt = torch.tensor(vals, requires_grad=True)
    got = tdsp.fused_multi_aggregate(vt, tp, aggrs, include_self=include_self,
                                     **kw_t)
    (got * torch.as_tensor(proj)).sum().backward()
    return (got.detach().numpy(), np.asarray(ref)[:n],
            vt.grad.numpy(), np.asarray(g_ref)[:n])


@pytest.mark.parametrize("aggrs,include_self", [
    (("sum", "mean", "max", "min"), False),
    (("sum", "mean", "max", "min", "var", "std"), True),
    (("symnorm", "max", "mean"), False),
])
def test_fused_matches_jax_fused(aggrs, include_self):
    s, r, n = small_graph()
    vals = np.random.default_rng(2).normal(size=(n, 128)).astype(np.float32)
    got, ref, g_got, g_ref = run_both(vals, s, r, n, aggrs, include_self)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert rel_l2(g_got, g_ref) <= 1e-4


def test_isolated_receivers_give_zero():
    s, r, n = small_graph(seed=3, n=200, e=900, isolated=20)
    vals = np.random.default_rng(4).normal(size=(n, 128)).astype(np.float32)
    aggrs = ("symnorm", "max", "min", "mean")
    got, ref, g_got, g_ref = run_both(vals, s, r, n, aggrs, False)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert rel_l2(g_got, g_ref) <= 1e-4
    # isolated rows: no symnorm self weight is passed here, so every
    # aggregator is exactly 0
    assert np.all(got[n - 20:, 1:] == 0)


def test_ties_route_the_full_cotangent():
    """Integer-valued features make many tied maxima and minima; every
    tied edge gets the whole cotangent on both sides."""
    s, r, n = small_graph(seed=5, n=200, e=1200)
    vals = np.random.default_rng(6).integers(
        -2, 3, size=(n, 128)).astype(np.float32)
    got, ref, g_got, g_ref = run_both(vals, s, r, n, ("max", "min"), False)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(g_got, g_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("segs", [
    ("c_sum", "c_wsum", "mx", "c_max"),
    ("c_sum", "c_wsum", "c_sumsq2", "mx", "c_max", "mn", "c_min"),
])
def test_plain_bwd_matches_jax_windowed_bwd(segs):
    s, r, n = small_graph(seed=7)
    f = 128
    rng = np.random.default_rng(8)
    vals = rng.normal(size=(n, f)).astype(np.float32)
    coeff = rng.normal(size=(n, len(segs) * f)).astype(np.float32)
    w = rng.random(len(s)).astype(np.float32)
    jp = jdsp.build_kernel_plan(s, r, n, fwd_block_rows=128,
                                fwd_window_rows=256, bwd_block_rows=256,
                                bwd_window_rows=128, edge_weight=w)
    b = jp.bwd
    cpad = jnp.zeros((jp.n_pad, coeff.shape[1])).at[:n].set(coeff)
    vpad = jnp.zeros((jp.n_pad, f)).at[:n].set(vals)
    ref = jgr.windowed_gather_reduce_bwd(
        cpad, vpad, b.senders, b.receivers, b.cell_ptr, segs=segs,
        r_blocks=b.r_blocks, s_blocks=b.s_blocks, block_rows=b.block_rows,
        window_rows=b.window_rows, edge_w=b.edge_w)
    tp = tdsp.build_kernel_plan(s, r, n, edge_weight=w)
    got = tgr.gather_reduce_bwd(torch.as_tensor(coeff), torch.as_tensor(vals),
                                tp.colptr, tp.bwd_receivers, tp.bwd_w, segs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:n], rtol=1e-4,
                               atol=1e-4)


def test_plan_weights_win_over_symnorm_edge_w():
    """A plan built with edge weights aggregates with them, whatever
    ``symnorm_edge_w`` says (the JAX package's rule)."""
    s, r, n = small_graph(seed=11)
    rng = np.random.default_rng(12)
    vals = torch.as_tensor(rng.normal(size=(n, 16)).astype(np.float32))
    w_plan = rng.random(len(s)).astype(np.float32)
    w_other = torch.as_tensor(rng.random(len(s)).astype(np.float32))
    weighted = tdsp.build_kernel_plan(s, r, n, edge_weight=w_plan)
    bare = tdsp.build_kernel_plan(s, r, n)
    got = tdsp.fused_multi_aggregate(vals, weighted, ("symnorm",),
                                     symnorm_edge_w=w_other)
    ref = tdsp.fused_multi_aggregate(vals, bare, ("symnorm",),
                                     symnorm_edge_w=torch.as_tensor(w_plan))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_conv_aggregate_refuses_weights_other_than_the_plans():
    from egc_tpu_torch.graph.structure import Graph
    s, r, n = small_graph(seed=13)
    rng = np.random.default_rng(14)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    w = rng.random(len(s)).astype(np.float32)
    g = Graph.from_coo(x, s, r, edge_weight=w)
    g = g.replace(kernel_plan=tdsp.build_kernel_plan(s, r, n, edge_weight=w))
    with pytest.raises(ValueError, match="edge_weight"):
        tdsp.conv_aggregate(g, g.nodes, ("symnorm",),
                            symnorm_edge_w=g.edge_weight.clone())
    got = tdsp.conv_aggregate(g, g.nodes, ("symnorm",),
                              symnorm_edge_w=g.edge_weight)
    ref = tdsp.fused_multi_aggregate(g.nodes, g.kernel_plan, ("symnorm",))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_conv_aggregate_takes_any_weights_when_the_plan_has_none():
    """The refusal above is about a plan that carries weights: a plan built
    without them aggregates with whatever ``symnorm_edge_w`` says, on the
    CPU path and the plan path alike."""
    from egc_tpu_torch.graph.structure import Graph
    s, r, n = small_graph(15)
    rng = np.random.default_rng(16)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    w = torch.as_tensor(rng.random(len(s)).astype(np.float32))
    g = Graph.from_coo(x, s, r, edge_weight=w)
    g = g.replace(kernel_plan=tdsp.build_kernel_plan(s, r, n))
    other = w * 2.0
    got = tdsp.conv_aggregate(g, g.nodes, ("symnorm",), symnorm_edge_w=other)
    ref = tdsp.fused_multi_aggregate(g.nodes, g.kernel_plan, ("symnorm",),
                                     symnorm_edge_w=other)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_plain_fwd_matches_jax_windowed_fwd():
    s, r, n = small_graph(seed=9, isolated=10)
    f = 128
    rng = np.random.default_rng(10)
    vals = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.random(len(s)).astype(np.float32)
    prims = ("sum", "wsum", "sumsq", "max", "min")
    jp = jdsp.build_kernel_plan(s, r, n, fwd_block_rows=128,
                                fwd_window_rows=256, bwd_block_rows=256,
                                bwd_window_rows=128, edge_weight=w)
    fw = jp.fwd
    vpad = jnp.zeros((jp.n_pad, f)).at[:n].set(vals)
    ref = jgr.windowed_gather_reduce(
        vpad, fw.senders, fw.receivers, fw.cell_ptr, r_blocks=fw.r_blocks,
        s_blocks=fw.s_blocks, block_rows=fw.block_rows,
        window_rows=fw.window_rows, ops=prims, edge_w=fw.edge_w)
    tp = tdsp.build_kernel_plan(s, r, n, edge_weight=w)
    got = tgr.gather_reduce_fwd(torch.as_tensor(vals), tp.rowptr,
                                tp.fwd_senders, tp.fwd_w, prims)
    for p, a, b_ in zip(prims, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_)[:n], rtol=1e-4,
                                   atol=1e-4, err_msg=p)
