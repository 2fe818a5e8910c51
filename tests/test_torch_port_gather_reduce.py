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


def _jax_bwd_vs_plain(s, r, n, vals, prims, seed):
    """``windowed_gather_reduce_bwd`` in interpret mode, fed the packed
    coefficient rows with the forward's mx / mn, against the plain
    backward fed one tensor per coefficient and the forward's masks."""
    f = vals.shape[1]
    rng = np.random.default_rng(seed)
    w = rng.random(len(s)).astype(np.float32)
    tp = tdsp.build_kernel_plan(s, r, n, edge_weight=w)
    masks = tuple(m for m in tgr.EXTREMA if m in prims)
    res = tgr.gather_reduce_fwd(torch.as_tensor(vals), tp.rowptr,
                                tp.fwd_senders, tp.fwd_w, prims, masks=masks,
                                fwd_to_bwd=tp.fwd_to_bwd)
    ext = dict(zip(prims, res))
    words = dict(zip(masks, res[len(prims):]))
    names = {"sum": "c_sum", "wsum": "c_wsum", "sumsq": "c_sumsq2",
             "max": "c_max", "min": "c_min"}
    coeffs = {names[p]: torch.as_tensor(
        rng.normal(size=(n, f)).astype(np.float32)) for p in prims}
    segs, cols = [], []
    for p in prims:
        if p in ("max", "min"):
            segs.append("mx" if p == "max" else "mn")
            cols.append(ext[p])
        segs.append(names[p])
        cols.append(coeffs[names[p]])
    jp = jdsp.build_kernel_plan(s, r, n, fwd_block_rows=128,
                                fwd_window_rows=256, bwd_block_rows=256,
                                bwd_window_rows=128, edge_weight=w)
    b = jp.bwd
    packed = torch.cat(cols, 1).numpy()
    cpad = jnp.zeros((jp.n_pad, packed.shape[1])).at[:n].set(packed)
    vpad = jnp.zeros((jp.n_pad, f)).at[:n].set(vals)
    ref = jgr.windowed_gather_reduce_bwd(
        cpad, vpad, b.senders, b.receivers, b.cell_ptr, segs=tuple(segs),
        r_blocks=b.r_blocks, s_blocks=b.s_blocks, block_rows=b.block_rows,
        window_rows=b.window_rows, edge_w=b.edge_w)
    got = tgr.gather_reduce_bwd(
        tp.colptr, tp.bwd_receivers, edge_w=tp.bwd_w,
        vals=torch.as_tensor(vals), max_mask=words.get("max"),
        min_mask=words.get("min"), **coeffs)
    return got.numpy(), np.asarray(ref)[:n]


@pytest.mark.parametrize("segs", [
    ("sum", "wsum", "max"),
    ("sum", "wsum", "sumsq", "max", "min"),
    ("max",),
    ("min",),
    ("max", "min"),
])
def test_plain_bwd_matches_jax_windowed_bwd(segs):
    """The plain backward from masks equals the JAX windowed backward from
    the packed rows with mx / mn, over the primitive sets ``segs``."""
    s, r, n = small_graph(seed=7)
    vals = np.random.default_rng(8).normal(size=(n, 128)).astype(np.float32)
    got, ref = _jax_bwd_vs_plain(s, r, n, vals, segs, seed=9)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f", [128, 40])
def test_plain_bwd_matches_jax_windowed_bwd_on_ties(f):
    """Integer values tie everywhere: every tied edge gets the whole
    cotangent from the mask, as from the JAX ``v >= mx`` test."""
    s, r, n = small_graph(seed=17, n=200, e=1200, isolated=5)
    vals = np.random.default_rng(18).integers(
        -2, 3, size=(n, f)).astype(np.float32)
    got, ref = _jax_bwd_vs_plain(s, r, n, vals, tgr.PRIMS, seed=19)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


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


# ---------------------------------------------------------------------------
# the extremum masks and the plan's fwd_to_bwd
# ---------------------------------------------------------------------------

def hub_graph(seed, n=400, e=2400, hub_degree=300, isolated=20):
    """Coalesced graph with a hub receiver (node 0) of ``hub_degree`` > 255
    in-edges and ``isolated`` receivers without any."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = rng.integers(1, n - isolated, e)
    hub_s = rng.choice(n, hub_degree, replace=False)
    s = np.concatenate([s, hub_s]).astype(np.int32)
    r = np.concatenate([r, np.zeros(hub_degree, np.int64)]).astype(np.int32)
    s, r, _ = coalesce_np(s, r, n)
    assert (r == 0).sum() == hub_degree
    return s, r, n


def tie_vals(seed, n, f):
    """Integer values in [-2, 2] (ties everywhere), with a signed zero
    wherever a value is 0: -0 and +0 must tie."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-2, 3, size=(n, f)).astype(np.float32)
    neg = (v == 0) & (rng.random((n, f)) < 0.5)
    v[neg] = -0.0
    assert np.signbit(v[v == 0]).any() and (~np.signbit(v[v == 0])).any()
    return v


def numpy_mask_words(bits):
    """``[E, F]`` bool -> the kernel's words, bit by bit: bit l of word
    chunk * vec + i is column chunk * 32 * vec + l * vec + i."""
    e, f = bits.shape
    vec = 4 if f % 4 == 0 else 1
    words = np.zeros((e, tgr.mask_words(f)), np.uint64)
    for col in range(f):
        chunk, rest = divmod(col, 32 * vec)
        lane, i = divmod(rest, vec)
        words[:, chunk * vec + i] |= bits[:, col].astype(np.uint64) << lane
    return words.astype(np.uint32).view(np.int32)


def csc_edges(plan):
    senders = np.repeat(np.arange(plan.num_nodes),
                        np.diff(plan.colptr.numpy()))
    return senders, plan.bwd_receivers.numpy()


@pytest.mark.parametrize("f", [128, 136, 40, 37])
def test_plain_mask_is_the_exact_predicate(f):
    """Bit (edge s -> r in CSC order, f) is vals[s, f] == max[r, f] (and
    == min[r, f]) with ties, signed zeros, empty receivers and a hub of
    300 in-edges; the words follow the kernel's lane layout."""
    s, r, n = hub_graph(seed=f)
    vals = tie_vals(f + 1, n, f)
    plan = tdsp.build_kernel_plan(s, r, n)
    mx, mn, w_mx, w_mn = tgr.gather_reduce_fwd(
        torch.as_tensor(vals), plan.rowptr, plan.fwd_senders, None,
        ("max", "min"), masks=("max", "min"), fwd_to_bwd=plan.fwd_to_bwd)
    assert w_mx.dtype == torch.int32
    assert tuple(w_mx.shape) == (plan.num_edges, tgr.mask_words(f))
    ref_mx = np.full((n, f), -np.inf, np.float32)
    ref_mn = np.full((n, f), np.inf, np.float32)
    np.maximum.at(ref_mx, r, vals[s])
    np.minimum.at(ref_mn, r, vals[s])
    cs, cr = csc_edges(plan)
    for words, ref in ((w_mx, ref_mx), (w_mn, ref_mn)):
        bits = vals[cs] == ref[cr]
        np.testing.assert_array_equal(words.numpy(), numpy_mask_words(bits))
        np.testing.assert_array_equal(
            tgr.unpack_mask(words, f).numpy(), bits)
    # ties happen, and the hub's 300 in-edges share its maxima
    hub = cr == 0
    assert (vals[cs[hub]] == ref_mx[0]).sum(0).min() > 1
    assert np.all(mx.numpy()[n - 20:] == 0) and np.all(mn.numpy()[n - 20:]
                                                        == 0)


def test_mask_words_layout():
    assert [tgr.mask_words(f) for f in (128, 136, 40, 37, 32, 1, 256)] \
        == [4, 8, 4, 2, 4, 1, 8]
    assert [tgr.lane_vec(f) for f in (128, 136, 40, 37)] == [4, 4, 4, 1]


def emulate_kernel_record(vals, plan, op):
    """The forward kernel's record, in torch: one pass over each row's
    in-edges in CSR order keeping, per feature, the first edge at the
    running extremum and a tie flag (set by an equal value, cleared by a
    strictly better one); then each in-edge's bit is ``arg == e`` where no
    tie flag is left, else a re-sweep's ``v == extremum``. Returns the
    words in CSC order."""
    better = torch.gt if op == "max" else torch.lt
    pick = torch.fmax if op == "max" else torch.fmin
    rowptr = plan.rowptr.tolist()
    senders = plan.fwd_senders.long()
    e_total, f = plan.num_edges, vals.shape[1]
    bits = torch.zeros(e_total, f, dtype=torch.bool)
    resweeps = 0
    for row in range(plan.num_nodes):
        start, end = rowptr[row], rowptr[row + 1]
        ext = torch.full((f,), -np.inf if op == "max" else np.inf)
        arg = torch.full((f,), -1, dtype=torch.int64)
        tie = torch.zeros(f, dtype=torch.bool)
        for e in range(start, end):
            v = vals[senders[e]]
            gt = better(v, ext)
            arg = torch.where(gt, e, arg)
            tie = (tie & ~gt) | (~gt & (v == ext))
            ext = pick(ext, v)
        resweeps += bool(tie.any())
        for e in range(start, end):
            bits[e] = torch.where(tie, vals[senders[e]] == ext, arg == e)
    words = tgr.pack_mask(bits)
    csc = torch.empty_like(words)
    csc[plan.fwd_to_bwd.long()] = words
    return csc, resweeps


@pytest.mark.parametrize("f,ties", [(128, True), (37, True), (40, False)])
def test_kernel_record_emulation_equals_plain_mask(f, ties):
    """The kernel's one-pass offset-and-tie-flag record with its re-sweep
    gives the plain mask, on tied integer values (re-sweeps on most rows)
    and on float values (none)."""
    s, r, n = hub_graph(seed=30 + f, n=300, e=1500, hub_degree=260)
    vals = tie_vals(f, n, f) if ties else np.random.default_rng(f).normal(
        size=(n, f)).astype(np.float32)
    plan = tdsp.build_kernel_plan(s, r, n)
    vt = torch.as_tensor(vals)
    _, _, w_mx, w_mn = tgr.gather_reduce_fwd(
        vt, plan.rowptr, plan.fwd_senders, None, ("max", "min"),
        masks=("max", "min"), fwd_to_bwd=plan.fwd_to_bwd)
    for op, words in (("max", w_mx), ("min", w_mn)):
        got, resweeps = emulate_kernel_record(vt, plan, op)
        torch.testing.assert_close(got, words, rtol=0, atol=0)
        assert (resweeps > n // 2) if ties else resweeps == 0


def test_fwd_to_bwd_is_the_plans_permutation():
    """fwd_to_bwd[i] is the CSC position of CSR edge i: bwd_perm
    [fwd_to_bwd] == fwd_perm, masked edges left out; to() carries it."""
    rng = np.random.default_rng(40)
    n = 120
    s = rng.integers(0, n, 700).astype(np.int32)
    r = rng.integers(0, n - 10, 700).astype(np.int32)
    mask = rng.random(700) < 0.8
    plan = tdsp.build_kernel_plan(s, r, n, edge_mask=mask)
    pos = plan.fwd_to_bwd
    assert pos.dtype == torch.int32 and pos.shape == (int(mask.sum()),)
    assert torch.equal(torch.sort(pos.long()).values,
                       torch.arange(plan.num_edges))
    assert torch.equal(plan.bwd_perm[pos.long()], plan.fwd_perm)
    assert torch.equal(plan.bwd_receivers[pos.long()],
                       tgr._row_ids(plan.rowptr).int())
    assert torch.equal(plan.to("cpu").fwd_to_bwd, pos)


def test_no_mask_without_grad_or_extremum_or_through_segment_reduce(
        monkeypatch):
    """The forward writes masks only for a vals that needs a gradient and
    a primitive set with max or min; ``segment_gather_reduce`` never."""
    calls = []
    orig = tgr.gather_reduce_fwd

    def spy(*a, **k):
        calls.append(tuple(k.get("masks", ())))
        return orig(*a, **k)

    monkeypatch.setattr(tdsp, "gather_reduce_fwd", spy)
    monkeypatch.setattr(tgr, "gather_reduce_fwd", spy)
    s, r, n = small_graph(seed=41)
    plan = tdsp.build_kernel_plan(s, r, n)
    x = torch.as_tensor(np.random.default_rng(42).normal(
        size=(n, 8)).astype(np.float32))
    tdsp.fused_multi_aggregate(x, plan, ("max", "min", "mean"))
    with torch.no_grad():
        tdsp.fused_multi_aggregate(x.clone().requires_grad_(True), plan,
                                   ("max",))
    xg = x.clone().requires_grad_(True)
    tdsp.fused_multi_aggregate(xg, plan, ("sum", "mean"))
    out = tdsp.fused_multi_aggregate(xg, plan, ("min", "sum", "max"))
    out.sum().backward()
    outs = tgr.segment_gather_reduce(
        x, torch.as_tensor(s[np.argsort(r, kind="stable")]),
        torch.as_tensor(np.sort(r)), num_out_rows=n, ops=("max", "min"))
    assert len(outs) == 2
    assert calls == [(), (), (), ("max", "min"), ()]


def test_bwd_takes_coefficient_rows_apart_from_sender_rows():
    """A bipartite transpose (50 senders, 80 receivers): the coefficient
    rows come from the coefficients, not from the senders."""
    rng = np.random.default_rng(43)
    n_src, n_dst, e, f = 50, 80, 400, 12
    s = np.sort(rng.integers(0, n_src, e))
    r = rng.integers(0, n_dst, e)
    colptr = torch.as_tensor(np.searchsorted(s, np.arange(n_src + 1)),
                             dtype=torch.int32)
    c_sum = rng.normal(size=(n_dst, f)).astype(np.float32)
    c_max = rng.normal(size=(n_dst, f)).astype(np.float32)
    bits = rng.random((e, f)) < 0.3
    got = tgr.gather_reduce_bwd(
        colptr, torch.as_tensor(r, dtype=torch.int32),
        c_sum=torch.as_tensor(c_sum), c_max=torch.as_tensor(c_max),
        max_mask=tgr.pack_mask(torch.as_tensor(bits)))
    ref = np.zeros((n_src, f), np.float32)
    np.add.at(ref, s, c_sum[r] + np.where(bits, c_max[r], 0))
    assert got.shape == (n_src, f)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="differ in shape"):
        tgr.gather_reduce_bwd(colptr, torch.as_tensor(r, dtype=torch.int32),
                              c_sum=torch.as_tensor(c_sum),
                              c_wsum=torch.as_tensor(c_sum[:40]),
                              edge_w=torch.ones(e))
