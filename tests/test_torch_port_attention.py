"""Port parity for the GAT edge softmax: ``gat_attention`` (kernels 5-7
through their plain versions on the CPU) against the JAX ``gat_attention``
with its Pallas kernels in interpret mode, ``GATConv`` against the JAX
``GATConv`` (its XLA path on the CPU), and ``segment_gather_reduce``
against the JAX function of that name in interpret mode."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import jax.experimental.pallas as pl
import egc_tpu.ops.pallas.attention as jattn
import egc_tpu.ops.pallas.gather_reduce as jgr
from egc_tpu.graph.structure import Graph as JGraph, pad_graph as jpad
from egc_tpu.graph.transforms import coalesce_np
from egc_tpu.nn.conv.attention import GATConv as JGATConv
from egc_tpu.ops.dispatch import GraphKernelPlan, WindowPlanDev

from egc_tpu_torch.exp.weight_port import arxiv_state_dict_from_jax
from egc_tpu_torch.graph.structure import Graph as TGraph, pad_graph as tpad
from egc_tpu_torch.nn.conv.attention import (
    GATConv, fused_softmax_sum, segment_softmax_sum,
)
from egc_tpu_torch.ops.cuda import attention as tat
from egc_tpu_torch.ops.cuda import gather_reduce as tgr
from egc_tpu_torch.ops.dispatch import build_kernel_plan

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jattn.pl, "pallas_call", patched)
    # the JAX gat_attention's max pass rides the gather-reduce kernels
    monkeypatch.setattr(jgr.pl, "pallas_call", patched)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def small_graph(seed, n, e, isolated=0, silent=0):
    """Coalesced random graph: the last ``isolated`` nodes receive no edge,
    the last ``silent`` send none."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n - silent, e).astype(np.int32)
    r = rng.integers(0, n - isolated, e).astype(np.int32)
    s, r, _ = coalesce_np(s, r, n)
    return s, r


def jax_mini_plan(s, r, n):
    """The JAX GraphKernelPlan with small window layouts, built as
    ``tests/test_attention_kernel.py::_mini_plan`` builds it."""
    npad = ((n + 256) // 256) * 256

    def dev(p):
        return WindowPlanDev(
            senders=jnp.asarray(p["senders"]),
            receivers=jnp.asarray(p["receivers"]),
            cell_ptr=jnp.asarray(p["cell_ptr"]),
            edge_perm=jnp.asarray(p["perm"].astype(np.int32)),
            r_blocks=p["R"], s_blocks=p["S"],
            block_rows=p["block_rows"], window_rows=p["window_rows"])

    f = jgr.make_window_plan_np(s, r, npad, block_rows=128, window_rows=256)
    b = jgr.make_window_plan_np(r, s, npad, block_rows=256, window_rows=128)
    deg = np.zeros(npad, np.float32)
    np.add.at(deg, r, 1.0)
    return GraphKernelPlan(fwd=dev(f), bwd=dev(b), fwd_attn=dev(f),
                           bwd_attn=dev(b), fwd_v2=None, bwd_v2=None,
                           deg=jnp.asarray(deg), n_pad=npad)


def jax_gat_attention(plan, heads, c, with_m=False):
    """(wh [N, H, C], a_src [N, H], a_dst [N, H]) -> (o [N, H, C], d [N, H])
    through the JAX ``gat_attention``, packing its TPU layout as
    ``_fused_gat_softmax_sum`` does; with ``with_m`` also its stationary
    max m [N, H] (-3e38 for an empty receiver)."""
    cp = 1
    while cp < c or (heads * cp) % 128:
        cp *= 2
    hcp, npad = heads * cp, plan.n_pad

    def f(wh, a_src, a_dst):
        xt = wh.transpose(0, 2, 1)
        if cp > c:                       # ones-channel denominator
            xt = jnp.concatenate([xt, jnp.ones((npad, 1, heads)),
                                  jnp.zeros((npad, cp - c - 1, heads))], 1)
        src_pack = jnp.concatenate(
            [xt.reshape(npad, hcp), jnp.tile(a_src, (1, cp))], axis=1)
        adst = jnp.pad(a_dst, ((0, 0), (0, 128 - heads)))
        o, md = jattn.gat_attention(src_pack, adst, plan, heads=heads,
                                    cp=cp, dchan=c if cp > c else None)
        o = o.reshape(npad, cp, heads).transpose(0, 2, 1)[:, :, :c]
        if with_m:
            return o, md[:, 64:64 + heads], md[:, :heads]
        return o, md[:, 64:64 + heads]

    return f, cp


@pytest.mark.parametrize("heads,c", [(4, 16), (4, 32), (1, 12)])
def test_gat_attention_matches_jax(heads, c):
    """Normalised outputs and the gradients of a fixed projection of them,
    in both JAX denominator modes (C < cp: ones channel; C == cp: separate
    accumulator) and single-head, with isolated receivers and silent
    senders."""
    n = 150
    s, r = small_graph(3, n, 700, isolated=12, silent=9)
    jplan = jax_mini_plan(s, r, n)
    f, cp = jax_gat_attention(jplan, heads, c)
    assert (cp > c) == (c != 32)
    npad = jplan.n_pad
    has = np.bincount(r, minlength=n) > 0
    rng = np.random.default_rng(4)
    wh = rng.normal(size=(n, heads, c)).astype(np.float32)
    a_src = rng.normal(size=(n, heads)).astype(np.float32)
    a_dst = rng.normal(size=(n, heads)).astype(np.float32)
    proj = rng.normal(size=(n, heads, c)).astype(np.float32) \
        * has[:, None, None]

    def pad(x):
        return jnp.zeros((npad,) + x.shape[1:]).at[:n].set(x)

    def jloss(wh, a_src, a_dst):
        o, d = f(wh, a_src, a_dst)
        out = o[:n] / jnp.maximum(d[:n], 1e-16)[:, :, None]
        return jnp.sum(out * proj), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        pad(wh), pad(a_src), pad(a_dst))

    tplan = build_kernel_plan(s, r, n)
    tw = [torch.tensor(x, requires_grad=True) for x in (wh, a_src, a_dst)]
    o, d, m = tat.gat_attention(*tw, tplan)
    assert not m.requires_grad
    assert torch.all(o[~torch.as_tensor(has)] == 0)
    assert torch.all(m[~torch.as_tensor(has)] == tat.EMPTY_MAX)
    out = o / torch.clamp(d, min=1e-16)[:, :, None]
    (out * torch.as_tensor(proj)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy()[has],
                               np.asarray(jout)[has], rtol=1e-4, atol=1e-4)
    for t, g, name in zip(tw, jg, ("wh", "a_src", "a_dst")):
        assert rel_l2(t.grad.numpy(), np.asarray(g)[:n]) <= 1e-4, name


def test_plain_kernels_empty_rows_are_exact_zeros():
    """Kernels 5-7 (plain versions) on a graph with isolated receivers and
    silent senders: empty rows are exact zeros (m = -1e30), not NaN."""
    n, heads, c = 60, 3, 7
    s, r = small_graph(5, n, 250, isolated=6, silent=5)
    plan = build_kernel_plan(s, r, n)
    rng = np.random.default_rng(6)

    def rand(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32))

    wh, a_src, a_dst = rand(n, heads * c), rand(n, heads), rand(n, heads)
    o, d, m = tat.gat_fwd(wh, a_src, a_dst, plan.rowptr, plan.fwd_senders)
    g_o, g_d = rand(n, heads * c), rand(n, heads)
    d_wh, d_asrc = tat.gat_bwd_t(wh, a_src, a_dst, m, g_o, g_d, plan.colptr,
                                 plan.bwd_receivers)
    d_adst = tat.gat_bwd_f(wh, a_src, a_dst, m, g_o, g_d, plan.rowptr,
                           plan.fwd_senders)
    for t in (o, d, m, d_wh, d_asrc, d_adst):
        assert torch.isfinite(t).all()
    empty = torch.as_tensor(np.bincount(r, minlength=n) == 0)
    silent = torch.as_tensor(np.bincount(s, minlength=n) == 0)
    assert empty[-6:].all() and silent[-5:].all()
    assert torch.all(o[empty] == 0) and torch.all(d[empty] == 0)
    assert torch.all(m[empty] == tat.EMPTY_MAX)
    assert torch.all(d_adst[empty] == 0)
    assert torch.all(d_wh[silent] == 0) and torch.all(d_asrc[silent] == 0)
    assert torch.all(d[~empty] > 0)


@pytest.mark.parametrize("heads,c", [(8, 5), (1, 37)])
def test_fused_path_matches_segment_path(heads, c):
    """The kernel path's node-level merge of the self term (``gat_attention``
    + ``fused_softmax_sum``) against the plain segment softmax, values and
    gradients, with isolated receivers."""
    n = 120
    s, r = small_graph(7, n, 600, isolated=10, silent=4)
    plan = build_kernel_plan(s, r, n)
    rng = np.random.default_rng(8)
    inputs = [rng.normal(size=shape).astype(np.float32) * 3
              for shape in ((n, heads, c), (n, heads), (n, heads))]
    proj = torch.as_tensor(rng.normal(size=(n, heads, c)).astype(np.float32))

    def run(fn):
        ts = [torch.tensor(x, requires_grad=True) for x in inputs]
        out = fn(*ts)
        (out * proj).sum().backward()
        return out.detach(), [t.grad for t in ts]

    got, g_got = run(lambda h, a, b: fused_softmax_sum(h, a, b, plan))
    ref, g_ref = run(lambda h, a, b: segment_softmax_sum(
        h, a, b, torch.as_tensor(s), torch.as_tensor(r)))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(g_got, g_ref):
        assert rel_l2(a.numpy(), b.numpy()) <= 1e-5


@pytest.mark.parametrize("heads,c", [(4, 6), (1, 24)])
def test_gatconv_matches_jax(heads, c):
    """GATConv values and the gradients of a fixed projection w.r.t. its
    input and every parameter, on a padded graph with isolated receivers;
    weights carried by ``arxiv_state_dict_from_jax``."""
    n, fin = 90, 20
    s, r = small_graph(9, n, 420, isolated=8)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(n + 3, fin)).astype(np.float32)
    proj = rng.normal(size=(n + 3, heads * c)).astype(np.float32)
    gj = jax.tree.map(jnp.asarray, jpad(JGraph.from_coo(x[:n], s, r),
                                        num_nodes=n + 3,
                                        num_edges=len(s) + 5))
    gt = tpad(TGraph.from_coo(x[:n], s, r), num_nodes=n + 3,
              num_edges=len(s) + 5)

    conv = JGATConv(out_channels=c, heads=heads)
    params = conv.init(jax.random.PRNGKey(2), gj, jnp.asarray(x))["params"]
    # a nonzero bias, so its gradient path is exercised too
    params = {**params, "bias": jnp.asarray(
        rng.normal(size=(heads * c,)).astype(np.float32))}

    def fj(p, xx):
        out = conv.apply({"params": p}, gj, xx)
        return jnp.sum(out * proj), out

    (_, jout), (gp, gx) = jax.value_and_grad(fj, argnums=(0, 1),
                                             has_aux=True)(
        params, jnp.asarray(x))

    def port(tree):
        sd = arxiv_state_dict_from_jax({"params": {
            "GATConv_0": jax.tree.map(np.asarray, tree),
            "embed": _dense(1, 1), "out": _dense(1, 1)}})
        return {k[len("convs.0."):]: v for k, v in sd.items()
                if k.startswith("convs.0.")}

    tconv = GATConv(fin, c, heads=heads)
    tconv.load_state_dict(port(params), strict=True)
    xt = torch.tensor(x, requires_grad=True)
    out = tconv(gt, xt)
    (out * torch.as_tensor(proj)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy()[:n],
                               np.asarray(jout)[:n], rtol=1e-4, atol=1e-4)
    assert rel_l2(xt.grad.numpy()[:n], np.asarray(gx)[:n]) <= 1e-4
    gsd = port(gp)
    for name, p in tconv.named_parameters():
        assert rel_l2(p.grad.numpy(), gsd[name].numpy()) <= 1e-4, name


def _dense(i, o):
    return {"kernel": np.zeros((i, o), np.float32),
            "bias": np.zeros((o,), np.float32)}


@pytest.mark.parametrize("ops", [("sum", "wsum", "max"),
                                 ("sumsq", "min")])
def test_segment_gather_reduce_matches_jax(ops):
    n, f = 200, 128
    s, r = small_graph(11, n, 900, isolated=15)       # receiver-sorted
    rng = np.random.default_rng(12)
    vals = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.random(len(s)).astype(np.float32)
    rows = 512
    rowptr = jgr.csr_rowptr_np(r, rows)
    ref = jgr.segment_gather_reduce(
        jnp.asarray(vals), jnp.asarray(s), jnp.asarray(r),
        jnp.asarray(jgr.block_ptr_np(rowptr, rows, 512)),
        num_out_rows=rows, ops=ops, edge_w=jnp.asarray(w))
    got = tgr.segment_gather_reduce(
        torch.as_tensor(vals), torch.as_tensor(s), torch.as_tensor(r),
        num_out_rows=rows, ops=ops, edge_w=torch.as_tensor(w))
    for op, a, b in zip(ops, got, ref):
        assert a.shape == (rows, f)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4, err_msg=op)


def test_segment_gather_reduce_refuses_unsorted_receivers():
    vals = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="sorted"):
        tgr.segment_gather_reduce(vals, torch.tensor([0, 1, 2]),
                                  torch.tensor([2, 1, 3]), num_out_rows=4)


def test_gat_launchers_refuse_cpu_tensors():
    z = torch.zeros(4, 2)
    ptr = torch.zeros(5, dtype=torch.int32)
    idx = torch.zeros(0, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        tat._launch_fwd(torch.zeros(4, 6), z, z, ptr, idx)
    for name in ("gat_bwd_t", "gat_bwd_f"):
        with pytest.raises(RuntimeError, match="CUDA tensor"):
            tat._launch_bwd(name, torch.zeros(4, 6), z, z, z,
                            torch.zeros(4, 6), z, ptr, idx)


def test_gat_bwd_t_geometry_covers_every_column():
    """For every (H, C) the GAT kernels take (``shape_ok``: H <= 32 and an
    edge group of at most 32 lanes, 1,792 shapes), their lane geometry
    (``gat_edge_geometry``, at most ``MAX_CHANS`` channels per lane): P
    divides the warp, each column of a row is owned by exactly one lane of
    an edge group, and each head's lanes are an aligned power-of-two run
    holding at most ``MAX_CHANS`` columns each, an even number when C is
    even (float2 loads). The arxiv shapes get 16 lanes per edge, 2 edges
    per warp step; the code2 shapes 32 lanes, 1 edge."""
    shapes = 0
    for heads, c in tat.accepted_shapes():
        p, lh, k = tat.gat_edge_geometry(heads, c)
        assert p & (p - 1) == 0 and lh & (lh - 1) == 0 and p <= 32
        assert 1 <= k <= tat.MAX_CHANS and (c % 2 or k % 2 == 0)
        owner = {}
        for j in range(p):                 # the kernel's formulas
            h, c0 = j // lh, (j % lh) * k
            nk = max(0, min(k, c - c0)) if h < heads else 0
            for col in range(h * c + c0, h * c + c0 + nk):
                assert col not in owner, (heads, c, col)
                owner[col] = j
        assert sorted(owner) == list(range(heads * c)), (heads, c)
        for h in range(heads):
            lanes = {owner[h * c + cc] for cc in range(c)}
            run = range(h * lh, (h + 1) * lh)
            assert lanes <= set(run) and run.start % lh == 0
            assert owner[h * c] == h * lh    # it writes d_asrc, d_adst
        shapes += 1
    assert shapes == 1792
    assert all(h * c <= tat.MAX_WIDTH for h, c in tat.accepted_shapes())
    assert tat.gat_edge_geometry(8, 19) == (16, 2, 10)
    assert tat.gat_edge_geometry(1, 152) == (16, 16, 10)
    assert tat.gat_edge_geometry(8, 38) == (32, 4, 10)
    assert tat.gat_edge_geometry(1, 304) == (32, 32, 10)


@pytest.mark.parametrize("heads,c", [(1, 513), (33, 1), (3, 129), (8, 65),
                                     (2, 257), (16, 33)])
def test_gat_kernels_refuse_shapes_past_the_rule(heads, c):
    """A shape whose edge group would not fit a warp, or H > 32, is
    refused with the rule in the message, before any launch."""
    assert not tat.shape_ok(heads, c)
    assert tat.shape_ok(heads, c - 1) or heads > tat.MAX_HEADS
    wh = torch.zeros(4, heads * c)
    z = torch.zeros(4, heads)
    with pytest.raises(ValueError, match="edge group of at most 32 lanes"):
        tat._check(wh, [("a_src", z)], torch.zeros(5, dtype=torch.int32),
                   torch.zeros(0, dtype=torch.int32))


def wide_hub_graph(seed, n=64):
    """A graph of 64 nodes with a hub receiver (node 0) and a hub sender
    (node 1) of 48 edges each (more than one warp step's 32 lanes hold),
    receivers with exactly 1 and 2 in-edges, 6 isolated receivers and 8
    silent senders; returns (s, r) coalesced."""
    rng = np.random.default_rng(seed)
    s = [rng.integers(2, n - 8, 160)]
    r = [rng.integers(5, n - 6, 160)]
    s += [rng.choice(np.arange(2, n - 8), 48, replace=False), np.full(48, 1),
          np.array([9, 10, 11])]
    r += [np.zeros(48, np.int64), rng.choice(np.arange(5, n - 6), 48,
                                             replace=False),
          np.array([2, 3, 3])]
    s, r = np.concatenate(s), np.concatenate(r)
    keep = ~np.isin(r, (2, 3)) | (np.arange(len(r)) >= len(r) - 3)
    s, r, _ = coalesce_np(s[keep].astype(np.int32), r[keep].astype(np.int32),
                          n)
    in_deg, out_deg = np.bincount(r, minlength=n), np.bincount(s, minlength=n)
    assert in_deg[0] == 48 and out_deg[1] == 48
    assert in_deg[2] == 1 and in_deg[3] == 2
    assert (in_deg[n - 6:] == 0).all() and (out_deg[n - 8:] == 0).all()
    return s, r


@pytest.mark.parametrize("heads,c", [(8, 38), (1, 304)])
def test_gat_attention_matches_jax_wide(heads, c):
    """The ogbg-code2 GAT widths (H8 C38, and the single-head H1 C304
    last layer; one edge per warp step in the kernels): the plain
    versions against the JAX kernels in interpret mode on a 64-node graph
    with hub rows, at rtol = atol = 1e-5 for the normalised outputs, m
    bitwise on receivers with in-edges, gradients at relative L2 <=
    1e-5."""
    n = 64
    s, r = wide_hub_graph(8)
    jplan = jax_mini_plan(s, r, n)
    f, cp = jax_gat_attention(jplan, heads, c, with_m=True)
    assert cp > c
    npad = jplan.n_pad
    has = np.bincount(r, minlength=n) > 0
    rng = np.random.default_rng(9)
    wh = rng.normal(size=(n, heads, c)).astype(np.float32)
    a_src = rng.normal(size=(n, heads)).astype(np.float32)
    a_dst = rng.normal(size=(n, heads)).astype(np.float32)
    proj = (rng.normal(size=(n, heads, c)) / np.sqrt(c)).astype(np.float32) \
        * has[:, None, None]

    def pad(x):
        return jnp.zeros((npad,) + x.shape[1:]).at[:n].set(x)

    def jloss(wh, a_src, a_dst):
        o, d, m = f(wh, a_src, a_dst)
        out = o[:n] / jnp.maximum(d[:n], 1e-16)[:, :, None]
        return jnp.sum(out * proj), (out, m[:n])

    (_, (jout, jm)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(pad(wh), pad(a_src),
                                                pad(a_dst))
    tw = [torch.tensor(x, requires_grad=True) for x in (wh, a_src, a_dst)]
    o, d, m = tat.gat_attention(*tw, build_kernel_plan(s, r, n))
    out = o / torch.clamp(d, min=1e-16)[:, :, None]
    (out * torch.as_tensor(proj)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy()[has],
                               np.asarray(jout)[has], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(m.numpy()[has], np.asarray(jm)[has])
    assert torch.all(o[~torch.as_tensor(has)] == 0)
    for t, g, name in zip(tw, jg, ("wh", "a_src", "a_dst")):
        assert rel_l2(t.grad.numpy(), np.asarray(g)[:n]) <= 1e-5, name


def hub_sender_graph(n, seed):
    """Random graph with two hub senders (nodes 0 and 1, > 64 out-edges),
    senders with exactly 1, 2 and 3 out-edges, silent senders and isolated
    receivers; returns (s, r) coalesced."""
    rng = np.random.default_rng(seed)
    s = [rng.integers(0, n - 20, 4 * n)]
    r = [rng.integers(0, n - 10, 4 * n)]    # the last 10 receive nothing
    few = [(0, 80), (1, 70)] + [
        (node, 1 + i % 3) for i, node in enumerate(range(n - 20, n - 14))]
    for node, k in few:                     # n-14 .. n-1 send nothing
        s.append(np.full(k, node))
        r.append(rng.choice(n - 10, k, replace=False))
    s, r, _ = coalesce_np(np.concatenate(s).astype(np.int32),
                          np.concatenate(r).astype(np.int32), n)
    deg = np.bincount(s, minlength=n)
    assert deg[:2].min() > 64 and all(deg[node] == k for node, k in few[2:])
    assert (deg[n - 14:] == 0).all()
    return s, r


def _deal_edges(ptr, idx, groups):
    """The kernels' order over each row of a CSR or CSC ``(ptr, idx)``:
    yields ``(g, live, nb)`` for t = 0, 1, ...: group g takes edge
    start + g + t G of the rows ``live`` that have one, to the neighbours
    ``nb``."""
    deg = ptr[1:] - ptr[:-1]
    rows = torch.arange(deg.shape[0])
    for t in range(-(-int(deg.max()) // groups)):
        for g in range(groups):
            pos = g + t * groups
            live = rows[deg > pos]
            yield g, live, idx[ptr[live] + pos].long()


def _xor_offsets(groups):
    """The groups' xor partners at offsets 1, 2, ..., G / 2 (the kernels'
    lane offsets P, 2P, ..., 16), in that order."""
    off = 1
    while off < groups:
        yield torch.arange(groups) ^ off
        off *= 2


def grouped_gat_bwd_t(wh, a_src, a_dst, m, g_o, g_d, colptr, receivers,
                      groups):
    """A pure-torch emulation of the ``gat_bwd_t`` kernel's order: out-edge
    start + g + t G of a sender goes to group g, each group sums its own
    d_wh and d_asrc over its edges in order, and the groups meet by xor
    partner at offsets 1, 2, ..., G / 2 (the kernel's lane offsets P, 2P,
    ..., 16), group 0's sums being the sender's. Returns ``(d_wh [N, H*C],
    d_asrc [N, H])``."""
    n, hc = wh.shape
    heads = a_src.shape[1]
    c = hc // heads
    acc = torch.zeros(n, groups, heads, c)
    hsum = torch.zeros(n, groups, heads)
    wh3, go3 = wh.view(n, heads, c), g_o.view(n, heads, c)
    for g, live, r in _deal_edges(colptr, receivers, groups):
        z = a_src[live] + a_dst[r]
        a = torch.exp(tat._leaky(z) - m[r])
        q = (go3[r] * wh3[live]).sum(-1)
        de = a * (q + g_d[r])
        hsum[live, g] += torch.where(z >= 0, de, tat.SLOPE * de)
        acc[live, g] += a[..., None] * go3[r]
    for partner in _xor_offsets(groups):
        acc = acc + acc[:, partner]
        hsum = hsum + hsum[:, partner]
    assert torch.equal(hsum, hsum[:, :1].expand_as(hsum))
    return acc[:, 0].reshape(n, hc), hsum[:, 0]


def jax_gat_backward_packing(npad, heads, c, wh, a_src, a_dst, m, g_o,
                             g_d):
    """The packing ``gat_attention``'s backward builds for ``_edge_pass``
    with the denominator cotangent as the fourth coefficient field (the
    mode for C == cp): ``src_pack`` = [wh | a_src] and ``coeff`` =
    [g_o | a_dst | m | g_d / cp], channels padded to cp and heads
    interleaved (column c' H + h); returns ``(src_pack, coeff, cp)``."""
    n = wh.shape[0]
    cp = 1
    while cp < c or (heads * cp) % 128:
        cp *= 2
    hcp = heads * cp

    def interleave(x):          # [n, H, C] -> [npad, cp * H]
        xt = np.zeros((npad, cp, heads), np.float32)
        xt[:n, :c] = x.transpose(0, 2, 1)
        return xt.reshape(npad, hcp)

    def tiled(x):               # [n, H] -> [npad, cp * H]
        xp = np.zeros((npad, heads), np.float32)
        xp[:n] = x
        return np.tile(xp, (1, cp))

    src_pack = jnp.asarray(np.concatenate([interleave(wh), tiled(a_src)], 1))
    coeff = jnp.asarray(np.concatenate(
        [interleave(g_o), tiled(a_dst), tiled(m), tiled(g_d / cp)], 1))
    return src_pack, coeff, cp


def jax_gat_bwd_t(jplan, heads, c, wh, a_src, a_dst, m, g_o, g_d):
    """``(d_wh [n, H, C], d_asrc [n, H])`` from the JAX
    ``_edge_pass(_bwd_t_kernel)`` in interpret mode, fed
    ``jax_gat_backward_packing``; d_asrc is the sum of the dz copy lanes,
    as the consumer's tile VJP takes it."""
    n, npad = wh.shape[0], jplan.n_pad
    src_pack, coeff, cp = jax_gat_backward_packing(
        npad, heads, c, wh, a_src, a_dst, m, g_o, g_d)
    hcp = heads * cp
    d_src = np.asarray(jattn._edge_pass(
        jattn._bwd_t_kernel, coeff, src_pack, jplan.bwd_attn, 2 * hcp,
        heads=heads, cp=cp, slope=tat.SLOPE))
    d_wh = d_src[:, :hcp].reshape(npad, cp, heads).transpose(0, 2, 1)
    d_asrc = d_src[:, hcp:].reshape(npad, cp, heads).sum(1)
    return d_wh[:n, :, :c], d_asrc[:n]


@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("heads,c", [(8, 19), (1, 37), (4, 6)])
def test_grouped_gat_bwd_t_matches_plain_and_jax(heads, c, groups):
    """The ``gat_bwd_t`` kernel's order (a sender's out-edges dealt over G
    edge groups, merged in the fixed xor order) equals ``gat_bwd_t_plain``
    and the JAX ``_edge_pass(_bwd_t_kernel)`` in interpret mode at rtol =
    atol = 1e-5 (d_asrc also at relative L2 <= 1e-4), on a graph with hub
    senders, senders with 1-3 out-edges and silent senders, whose rows
    are exact zeros."""
    n = 160
    s, r = hub_sender_graph(n, 21)
    rng = np.random.default_rng(22)
    wh = rng.normal(size=(n, heads, c)).astype(np.float32)
    a_src = rng.normal(size=(n, heads)).astype(np.float32)
    a_dst = rng.normal(size=(n, heads)).astype(np.float32)
    g_o = (rng.normal(size=(n, heads, c)) / np.sqrt(c)).astype(np.float32)
    g_d = rng.normal(size=(n, heads)).astype(np.float32)

    tplan = build_kernel_plan(s, r, n)
    t = [torch.as_tensor(x) for x in (wh.reshape(n, -1), a_src, a_dst)]
    m = tat.gat_fwd_plain(*t, tplan.rowptr, tplan.fwd_senders)[2]
    args = (*t, m, torch.as_tensor(g_o.reshape(n, -1)),
            torch.as_tensor(g_d), tplan.colptr, tplan.bwd_receivers)
    d_wh, d_asrc = grouped_gat_bwd_t(*args, groups)
    ref_wh, ref_asrc = tat.gat_bwd_t_plain(*args)
    torch.testing.assert_close(d_wh, ref_wh, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d_asrc, ref_asrc, rtol=1e-5, atol=1e-5)
    assert rel_l2(d_asrc.numpy(), ref_asrc.numpy()) <= 1e-4
    silent = torch.as_tensor(np.bincount(s, minlength=n) == 0)
    assert silent.sum() >= 14
    assert torch.all(d_wh[silent] == 0) and torch.all(d_asrc[silent] == 0)
    assert d_wh[:2].abs().min(dim=1).values.min() > 0     # the hubs' rows

    j_wh, j_asrc = jax_gat_bwd_t(jax_mini_plan(s, r, n), heads, c, wh, a_src,
                                 a_dst, m.numpy(), g_o, g_d)
    np.testing.assert_allclose(d_wh.numpy(), j_wh.reshape(n, -1), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(d_asrc.numpy(), j_asrc, rtol=1e-5, atol=1e-5)
    assert rel_l2(d_asrc.numpy(), j_asrc) <= 1e-4


def hub_receiver_graph(n, seed):
    """The receiver-side twin of ``hub_sender_graph`` (its edges reversed):
    two hub receivers (nodes 0 and 1, > 64 in-edges), receivers with
    exactly 1, 2 and 3 in-edges, receivers without in-edges (n-14 .. n-1)
    and silent senders; returns (s, r) coalesced."""
    s, r = hub_sender_graph(n, seed)
    s, r, _ = coalesce_np(r, s, n)
    deg = np.bincount(r, minlength=n)
    assert deg[:2].min() > 64 and set(deg[n - 20:n - 14]) == {1, 2, 3}
    assert (deg[n - 14:] == 0).all()
    return s, r


def grouped_gat_fwd(wh, a_src, a_dst, rowptr, senders, groups):
    """A pure-torch emulation of the ``gat_fwd`` kernel's order: in-edge
    start + g + t G of a receiver goes to group g, each group keeps its own
    online softmax state per head (m from -1e30, d, o) over its edges in
    order, and the groups merge by the flash rescale with their xor
    partner at offsets 1, 2, ..., G / 2 (the kernel's lane offsets P, 2P,
    ..., 16), group 0's state being the receiver's. Returns ``(o [N, H*C],
    d [N, H], m [N, H])``."""
    n, hc = wh.shape
    heads = a_src.shape[1]
    wh3 = wh.view(n, heads, hc // heads)
    m = torch.full((n, groups, heads), tat.EMPTY_MAX)
    d = torch.zeros(n, groups, heads)
    acc = torch.zeros(n, groups, heads, hc // heads)
    for g, live, s in _deal_edges(rowptr, senders, groups):
        e = tat._leaky(a_src[s] + a_dst[live])
        m_new = torch.maximum(m[live, g], e)
        c = torch.exp(m[live, g] - m_new)
        p = torch.exp(e - m_new)
        d[live, g] = d[live, g] * c + p
        acc[live, g] = acc[live, g] * c[..., None] + p[..., None] * wh3[s]
        m[live, g] = m_new
    for partner in _xor_offsets(groups):
        m_new = torch.maximum(m, m[:, partner])
        ca, cb = torch.exp(m - m_new), torch.exp(m[:, partner] - m_new)
        d = d * ca + d[:, partner] * cb
        acc = acc * ca[..., None] + acc[:, partner] * cb[..., None]
        m = m_new
    return acc[:, 0].reshape(n, hc), d[:, 0], m[:, 0]


def grouped_gat_bwd_f(wh, a_src, a_dst, m, g_o, g_d, rowptr, senders,
                      groups):
    """A pure-torch emulation of the ``gat_bwd_f`` kernel's order: in-edge
    start + g + t G of a receiver goes to group g, each group sums its dz
    over its edges in order, and the groups meet by xor partner at offsets
    1, 2, ..., G / 2, group 0's sum being the receiver's. Returns
    ``d_adst [N, H]``."""
    n, hc = wh.shape
    heads = a_src.shape[1]
    wh3, go3 = wh.view(n, heads, -1), g_o.view(n, heads, -1)
    hsum = torch.zeros(n, groups, heads)
    for g, live, s in _deal_edges(rowptr, senders, groups):
        z = a_src[s] + a_dst[live]
        a = torch.exp(tat._leaky(z) - m[live])
        de = a * ((go3[live] * wh3[s]).sum(-1) + g_d[live])
        hsum[live, g] += torch.where(z >= 0, de, tat.SLOPE * de)
    for partner in _xor_offsets(groups):
        hsum = hsum + hsum[:, partner]
    assert torch.equal(hsum, hsum[:, :1].expand_as(hsum))
    return hsum[:, 0]


def _gat_case(n, heads, c, seed):
    """wh [n, H, C], a_src, a_dst, g_o (scaled so q is O(1)), g_d as
    numpy."""
    rng = np.random.default_rng(seed)
    wh = rng.normal(size=(n, heads, c)).astype(np.float32)
    a_src = rng.normal(size=(n, heads)).astype(np.float32)
    a_dst = rng.normal(size=(n, heads)).astype(np.float32)
    g_o = (rng.normal(size=(n, heads, c)) / np.sqrt(c)).astype(np.float32)
    g_d = rng.normal(size=(n, heads)).astype(np.float32)
    return wh, a_src, a_dst, g_o, g_d


@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("heads,c", [(8, 19), (1, 37), (4, 6)])
def test_grouped_gat_fwd_matches_plain_and_jax(heads, c, groups):
    """The ``gat_fwd`` kernel's order (a receiver's in-edges dealt over G
    edge groups, each with its own online max, merged by the flash rescale
    in the fixed xor order) equals ``gat_fwd_plain`` and the JAX
    ``gat_fwd`` (with its max pass) in interpret mode at rtol = atol =
    1e-5, on a graph with hub receivers, receivers with 1-3 in-edges and
    receivers without any; m equals the plain version's and the JAX max
    pass's bit for bit, and an empty receiver gets o = 0, d = 0 and
    m = -1e30 exactly."""
    n = 160
    s, r = hub_receiver_graph(n, 23)
    wh, a_src, a_dst, _, _ = _gat_case(n, heads, c, 24)
    tplan = build_kernel_plan(s, r, n)
    args = (torch.as_tensor(wh.reshape(n, -1)), torch.as_tensor(a_src),
            torch.as_tensor(a_dst), tplan.rowptr, tplan.fwd_senders)
    o, d, m = grouped_gat_fwd(*args, groups)
    ref_o, ref_d, ref_m = tat.gat_fwd_plain(*args)
    torch.testing.assert_close(o, ref_o, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d, ref_d, rtol=1e-5, atol=1e-5)
    assert torch.equal(m, ref_m)
    empty = torch.as_tensor(np.bincount(r, minlength=n) == 0)
    assert empty.sum() >= 14
    assert torch.all(o[empty] == 0) and torch.all(d[empty] == 0)
    assert torch.all(m[empty] == tat.EMPTY_MAX)
    assert o[:2].abs().min(dim=1).values.min() > 0        # the hubs' rows

    jplan = jax_mini_plan(s, r, n)
    f, _ = jax_gat_attention(jplan, heads, c, with_m=True)

    def pad(x):
        return jnp.zeros((jplan.n_pad,) + x.shape[1:]).at[:n].set(x)

    j_o, j_d, j_m = (np.asarray(x)[:n]
                     for x in f(pad(wh), pad(a_src), pad(a_dst)))
    np.testing.assert_allclose(o.numpy(), j_o.reshape(n, -1), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(d.numpy(), j_d, rtol=1e-5, atol=1e-5)
    has = ~empty.numpy()      # the JAX m of an empty receiver is -3e38
    np.testing.assert_array_equal(m.numpy()[has], j_m[has])


@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("heads,c", [(8, 19), (1, 37), (4, 6)])
def test_grouped_gat_bwd_f_matches_plain_and_jax(heads, c, groups):
    """The ``gat_bwd_f`` kernel's order (a receiver's in-edges dealt over G
    edge groups, merged in the fixed xor order) equals ``gat_bwd_f_plain``
    and the JAX ``_edge_pass(_bwd_f_kernel)`` in interpret mode at rtol =
    atol = 1e-5 and relative L2 <= 1e-4, on a graph with hub receivers,
    receivers with 1-3 in-edges and receivers without any, whose rows are
    exact zeros."""
    n = 160
    s, r = hub_receiver_graph(n, 25)
    wh, a_src, a_dst, g_o, g_d = _gat_case(n, heads, c, 26)
    tplan = build_kernel_plan(s, r, n)
    t = [torch.as_tensor(x) for x in (wh.reshape(n, -1), a_src, a_dst)]
    m = tat.gat_fwd_plain(*t, tplan.rowptr, tplan.fwd_senders)[2]
    args = (*t, m, torch.as_tensor(g_o.reshape(n, -1)),
            torch.as_tensor(g_d), tplan.rowptr, tplan.fwd_senders)
    d_adst = grouped_gat_bwd_f(*args, groups)
    ref = tat.gat_bwd_f_plain(*args)
    torch.testing.assert_close(d_adst, ref, rtol=1e-5, atol=1e-5)
    assert rel_l2(d_adst.numpy(), ref.numpy()) <= 1e-4
    empty = torch.as_tensor(np.bincount(r, minlength=n) == 0)
    assert empty.sum() >= 14 and torch.all(d_adst[empty] == 0)
    assert d_adst[:2].abs().min() > 0                     # the hubs' rows

    jplan = jax_mini_plan(s, r, n)
    src_pack, coeff, cp = jax_gat_backward_packing(
        jplan.n_pad, heads, c, wh, a_src, a_dst, m.numpy(), g_o, g_d)
    dz = np.asarray(jattn._edge_pass(
        jattn._bwd_f_kernel, src_pack, coeff, jplan.fwd_attn, heads * cp,
        heads=heads, cp=cp, slope=tat.SLOPE))
    j_adst = dz.reshape(-1, cp, heads).sum(1)[:n]
    np.testing.assert_allclose(d_adst.numpy(), j_adst, rtol=1e-5, atol=1e-5)
    assert rel_l2(d_adst.numpy(), j_adst) <= 1e-4
