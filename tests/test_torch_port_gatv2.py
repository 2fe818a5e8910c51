"""Port parity for the GATv2 edge softmax: ``gatv2_attention`` (its three
kernels through their plain versions on the CPU) against the JAX
``gatv2_attention`` with its Pallas kernels in interpret mode, on the
one-phase and the two-phase layouts; the kernel path against the segment
path; and ``GATv2Conv`` against the JAX ``GATv2Conv`` (its XLA path on the
CPU)."""

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
from egc_tpu.nn.conv.attention import GATv2Conv as JGATv2Conv
from egc_tpu.ops.dispatch import GraphKernelPlan, WindowPlanDev

from egc_tpu_torch.exp.weight_port import arxiv_state_dict_from_jax
from egc_tpu_torch.graph.structure import Graph as TGraph, pad_graph as tpad
from egc_tpu_torch.nn.conv.attention import (
    GATv2Conv, fused_softmax_sum_v2, segment_softmax_sum_v2,
)
from egc_tpu_torch.ops.cuda import attention as tat
from egc_tpu_torch.ops.dispatch import build_kernel_plan

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jattn.pl, "pallas_call", patched)
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


def jax_plan(s, r, n, two_phase):
    """The JAX GraphKernelPlan with small window layouts, built as
    ``tests/test_attention_kernel.py::_mini_plan`` builds it; with
    ``two_phase`` it carries the two-phase layouts as well."""
    npad = ((n + 256) // 256) * 256

    def dev(p):
        return WindowPlanDev(
            senders=jnp.asarray(p["senders"]),
            receivers=jnp.asarray(p["receivers"]),
            cell_ptr=jnp.asarray(p["cell_ptr"]),
            edge_perm=jnp.asarray(p["perm"].astype(np.int32)),
            r_blocks=p["R"], s_blocks=p["S"],
            block_rows=p["block_rows"], window_rows=p["window_rows"])

    f = dev(jgr.make_window_plan_np(s, r, npad, block_rows=128,
                                    window_rows=256))
    b = dev(jgr.make_window_plan_np(r, s, npad, block_rows=256,
                                    window_rows=128))
    deg = np.zeros(npad, np.float32)
    np.add.at(deg, r, 1.0)
    return GraphKernelPlan(fwd=f, bwd=b, fwd_attn=f, bwd_attn=b,
                           fwd_v2=f if two_phase else None,
                           bwd_v2=b if two_phase else None,
                           deg=jnp.asarray(deg), n_pad=npad)


def jax_gatv2_attention(plan, heads, c):
    """(hl [N, H, C], hr [N, H, C], att [H, C]) -> (o [N, H, C], d [N, H])
    through the JAX ``gatv2_attention``, packing its TPU layout as
    ``_fused_gatv2_softmax_sum`` does (head interleave, ones channel)."""
    cp = 1
    while cp < c or (heads * cp) % 128:
        cp *= 2
    hcp, npad = heads * cp, plan.n_pad

    def interleave(x, ones_chan=False):
        xt = x.transpose(0, 2, 1)
        if ones_chan:
            xt = jnp.concatenate([xt, jnp.ones((npad, 1, heads)),
                                  jnp.zeros((npad, cp - c - 1, heads))], 1)
        else:
            xt = jnp.pad(xt, ((0, 0), (0, cp - c), (0, 0)))
        return xt.reshape(npad, hcp)

    def f(hl, hr, att):
        att_i = jnp.pad(att.T, ((0, cp - c), (0, 0))).reshape(1, hcp)
        o, md = jattn.gatv2_attention(
            interleave(hl, ones_chan=True), interleave(hr),
            jnp.broadcast_to(att_i, (8, hcp)), plan, heads=heads, cp=cp,
            dchan=c)
        o = o.reshape(npad, cp, heads).transpose(0, 2, 1)[:, :, :c]
        return o, md[:, 64:64 + heads]

    return f, cp


@pytest.mark.parametrize("two_phase", [False, True])
@pytest.mark.parametrize("heads,c,graph", [
    pytest.param(4, 12, "random", id="4-12"),
    pytest.param(1, 24, "random", id="1-24"),
    pytest.param(8, 6, "hub_receivers", id="8-6-hub_receivers")])
def test_gatv2_attention_matches_jax(heads, c, graph, two_phase):
    """Normalised outputs, d, and the gradients of a fixed projection of
    the outputs with respect to hl, hr and att, against the JAX kernels on
    the one-phase and two-phase layouts, with isolated receivers and
    silent senders; on a random graph, and on one with a hub receiver and
    receivers with 1-3 in-edges."""
    n = 150
    if graph == "random":
        s, r = small_graph(3, n, 700, isolated=12, silent=9)
    else:
        s, r = hub_receiver_graph(n, 3)
    jplan = jax_plan(s, r, n, two_phase)
    f, cp = jax_gatv2_attention(jplan, heads, c)
    assert cp > c
    npad = jplan.n_pad
    has = np.bincount(r, minlength=n) > 0
    rng = np.random.default_rng(4)
    hl = rng.normal(size=(n, heads, c)).astype(np.float32)
    hr = rng.normal(size=(n, heads, c)).astype(np.float32)
    att = (rng.normal(size=(heads, c)) / np.sqrt(c)).astype(np.float32)
    proj = rng.normal(size=(n, heads, c)).astype(np.float32) \
        * has[:, None, None]

    def pad(x):
        return jnp.zeros((npad,) + x.shape[1:]).at[:n].set(x)

    def jloss(hl, hr, att):
        o, d = f(pad(hl), pad(hr), att)
        out = o[:n] / jnp.maximum(d[:n], 1e-16)[:, :, None]
        return jnp.sum(out * proj), (out, d[:n])

    (_, (jout, jd)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(hl, hr, att)

    tplan = build_kernel_plan(s, r, n)
    tw = [torch.tensor(x, requires_grad=True) for x in (hl, hr, att)]
    o, d, m = tat.gatv2_attention(*tw, tplan)
    assert not m.requires_grad
    empty = torch.as_tensor(~has)
    assert torch.all(o[empty] == 0) and torch.all(d[empty] == 0)
    assert torch.all(m[empty] == tat.EMPTY_MAX)
    out = o / torch.clamp(d, min=1e-16)[:, :, None]
    (out * torch.as_tensor(proj)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy()[has],
                               np.asarray(jout)[has], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(d.detach().numpy()[has], np.asarray(jd)[has],
                               rtol=1e-4, atol=1e-4)
    for t, g, name in zip(tw, jg, ("hl", "hr", "att")):
        assert rel_l2(t.grad.numpy(), np.asarray(g)) <= 1e-4, name


def test_gatv2_plain_kernels_empty_rows_are_exact_zeros():
    """The three GATv2 kernels (plain versions) on a graph with isolated
    receivers and silent senders: empty rows are exact zeros (m = -1e30),
    not NaN."""
    n, heads, c = 60, 3, 7
    s, r = small_graph(5, n, 250, isolated=6, silent=5)
    plan = build_kernel_plan(s, r, n)
    rng = np.random.default_rng(6)

    def rand(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32))

    hl, hr, att = rand(n, heads * c), rand(n, heads * c), rand(heads, c)
    o, d, m = tat.gatv2_fwd(hl, hr, att, plan.rowptr, plan.fwd_senders)
    g_o, g_d = rand(n, heads * c), rand(n, heads)
    d_hl = tat.gatv2_bwd_t(hl, hr, att, m, g_o, g_d, plan.colptr,
                           plan.bwd_receivers)
    d_hr, d_att = tat.gatv2_bwd_f(hl, hr, att, m, g_o, g_d, plan.rowptr,
                                  plan.fwd_senders)
    for t in (o, d, m, d_hl, d_hr, d_att):
        assert torch.isfinite(t).all()
    assert d_att.shape == (heads, c)
    empty = torch.as_tensor(np.bincount(r, minlength=n) == 0)
    silent = torch.as_tensor(np.bincount(s, minlength=n) == 0)
    assert empty[-6:].all() and silent[-5:].all()
    assert torch.all(o[empty] == 0) and torch.all(d[empty] == 0)
    assert torch.all(m[empty] == tat.EMPTY_MAX)
    assert torch.all(d_hr[empty] == 0) and torch.all(d_hl[silent] == 0)
    assert torch.all(d[~empty] > 0)


@pytest.mark.parametrize("heads,c", [(8, 5), (1, 37), (4, 32)])
def test_fused_path_matches_segment_path_v2(heads, c):
    """The kernel path's self-term merge (``gatv2_attention`` +
    ``fused_softmax_sum_v2``) against the plain segment softmax, values and
    gradients, with isolated receivers and silent senders; C = 32 has no
    free channel, which the JAX kernel would need."""
    n = 120
    s, r = small_graph(7, n, 600, isolated=10, silent=4)
    plan = build_kernel_plan(s, r, n)
    rng = np.random.default_rng(8)
    inputs = [rng.normal(size=(n, heads, c)).astype(np.float32) * 2,
              rng.normal(size=(n, heads, c)).astype(np.float32) * 2,
              (rng.normal(size=(heads, c)) / np.sqrt(c)).astype(np.float32)]
    proj = torch.as_tensor(rng.normal(size=(n, heads, c)).astype(np.float32))

    def run(fn):
        ts = [torch.tensor(x, requires_grad=True) for x in inputs]
        out = fn(*ts)
        (out * proj).sum().backward()
        return out.detach(), [t.grad for t in ts]

    got, g_got = run(lambda hl, hr, att: fused_softmax_sum_v2(hl, hr, att,
                                                              plan))
    ref, g_ref = run(lambda hl, hr, att: segment_softmax_sum_v2(
        hl, hr, att, torch.as_tensor(s), torch.as_tensor(r)))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    for a, b, name in zip(g_got, g_ref, ("hl", "hr", "att")):
        assert rel_l2(a.numpy(), b.numpy()) <= 1e-5, name


def _dense(i, o):
    return {"kernel": np.zeros((i, o), np.float32),
            "bias": np.zeros((o,), np.float32)}


@pytest.mark.parametrize("heads,c,share", [(4, 6, False), (4, 6, True),
                                           (1, 24, False)])
def test_gatv2conv_matches_jax(heads, c, share):
    """GATv2Conv values and the gradients of a fixed projection w.r.t. its
    input and every parameter, on a padded graph with isolated receivers,
    with and without ``share_weights``; weights carried by
    ``arxiv_state_dict_from_jax``."""
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

    conv = JGATv2Conv(out_channels=c, heads=heads, share_weights=share)
    params = conv.init(jax.random.PRNGKey(2), gj, jnp.asarray(x))["params"]
    assert ("lin_r" in params) != share
    # nonzero biases, so their gradient paths are exercised too
    params = jax.tree.map(
        lambda v: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
        if v.ndim == 1 else v, params)

    def fj(p, xx):
        out = conv.apply({"params": p}, gj, xx)
        return jnp.sum(out * proj), out

    (_, jout), (gp, gx) = jax.value_and_grad(fj, argnums=(0, 1),
                                             has_aux=True)(
        params, jnp.asarray(x))

    def port(tree):
        sd = arxiv_state_dict_from_jax({"params": {
            "GATv2Conv_0": jax.tree.map(np.asarray, tree),
            "embed": _dense(1, 1), "out": _dense(1, 1)}})
        return {k[len("convs.0."):]: v for k, v in sd.items()
                if k.startswith("convs.0.")}

    tconv = GATv2Conv(fin, c, heads=heads, share_weights=share)
    assert (tconv.lin_r is tconv.lin_l) == share
    tconv.load_state_dict(port(params), strict=True)
    xt = torch.tensor(x, requires_grad=True)
    out = tconv(gt, xt)
    (out * torch.as_tensor(proj)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy()[:n],
                               np.asarray(jout)[:n], rtol=1e-4, atol=1e-4)
    assert rel_l2(xt.grad.numpy()[:n], np.asarray(gx)[:n]) <= 1e-4
    gsd = port(gp)
    names = [name for name, _ in tconv.named_parameters()]
    assert ("lin_r.weight" in names) != share
    for name, p in tconv.named_parameters():
        assert rel_l2(p.grad.numpy(), gsd[name].numpy()) <= 1e-4, name


def test_gatv2_attention_refuses_mismatched_shapes():
    plan = build_kernel_plan(np.array([0], np.int32), np.array([1], np.int32),
                             4)
    hl = torch.zeros(4, 2, 3)
    with pytest.raises(ValueError, match="do not match"):
        tat.gatv2_attention(hl, hl, torch.zeros(2, 4), plan)
    with pytest.raises(ValueError, match="rows"):
        tat.gatv2_attention(hl[:3], hl[:3], torch.zeros(2, 3), plan)


def test_bwd_t_geometry_covers_every_column():
    """For every (H, C) the kernels take (``shape_ok``: H <= 32 and an edge
    group of at most 32 lanes, 1,792 shapes), the lane geometry that
    ``gatv2_fwd``, ``gatv2_bwd_t`` and ``gatv2_bwd_f`` share: P divides the
    warp, each column of a row is owned by exactly one lane of an edge
    group, and each head's lanes are an aligned power-of-two run holding
    at most ``MAX_CHANS`` columns each, an even number when C is even
    (float2 loads). The code2 shapes get 32 lanes per edge and 10 channels
    per lane."""
    shapes = 0
    for heads, c in tat.accepted_shapes():
        p, lh, k = tat.edge_geometry(heads, c)
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
        shapes += 1
    assert shapes == 1792
    assert tat.edge_geometry(8, 37) == (32, 4, 10)
    assert tat.edge_geometry(1, 296) == (32, 32, 10)


@pytest.mark.parametrize("heads,c", [(1, 513), (33, 2), (8, 65), (4, 129)])
def test_gatv2_kernels_refuse_shapes_past_the_rule(heads, c):
    """The GATv2 launch checks refuse a shape past ``shape_ok`` with the
    rule in the message."""
    assert not tat.shape_ok(heads, c)
    hl = torch.zeros(4, heads * c)
    with pytest.raises(ValueError, match="edge group of at most 32 lanes"):
        tat._check_v2(hl, hl, torch.zeros(heads, c), [],
                      torch.zeros(5, dtype=torch.int32),
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


@pytest.mark.parametrize("heads,c", [(8, 37), (1, 296)])
def test_gatv2_attention_matches_jax_wide(heads, c):
    """The ogbg-code2 GATv2 widths (H8 C37, C odd, and the single-head H1
    C296 last layer; one edge per warp step in the kernels): the plain
    versions against the JAX kernels (one-phase, as H*cp > 128 takes) in
    interpret mode on a 64-node graph with hub rows, at rtol = atol = 1e-5
    for the normalised outputs and d, gradients of hl, hr and att at
    relative L2 <= 1e-5."""
    n = 64
    s, r = wide_hub_graph(10)
    jplan = jax_plan(s, r, n, two_phase=False)
    f, cp = jax_gatv2_attention(jplan, heads, c)
    assert cp > c and heads * cp > 128
    npad = jplan.n_pad
    has = np.bincount(r, minlength=n) > 0
    rng = np.random.default_rng(11)
    hl = rng.normal(size=(n, heads, c)).astype(np.float32)
    hr = rng.normal(size=(n, heads, c)).astype(np.float32)
    att = (rng.normal(size=(heads, c)) / np.sqrt(c)).astype(np.float32)
    proj = (rng.normal(size=(n, heads, c)) / np.sqrt(c)).astype(np.float32) \
        * has[:, None, None]

    def pad(x):
        return jnp.zeros((npad,) + x.shape[1:]).at[:n].set(x)

    def jloss(hl, hr, att):
        o, d = f(pad(hl), pad(hr), att)
        out = o[:n] / jnp.maximum(d[:n], 1e-16)[:, :, None]
        return jnp.sum(out * proj), (out, d[:n])

    (_, (jout, jd)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(hl, hr, att)
    tw = [torch.tensor(x, requires_grad=True) for x in (hl, hr, att)]
    o, d, m = tat.gatv2_attention(*tw, build_kernel_plan(s, r, n))
    out = o / torch.clamp(d, min=1e-16)[:, :, None]
    (out * torch.as_tensor(proj)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy()[has],
                               np.asarray(jout)[has], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d.detach().numpy()[has], np.asarray(jd)[has],
                               rtol=1e-5, atol=1e-5)
    empty = torch.as_tensor(~has)
    assert torch.all(o[empty] == 0) and torch.all(m[empty] == tat.EMPTY_MAX)
    for t, g, name in zip(tw, jg, ("hl", "hr", "att")):
        assert rel_l2(t.grad.numpy(), np.asarray(g)) <= 1e-5, name


def hub_graph(n, seed):
    """Random graph with a hub sender (node 0, > 64 out-edges), senders
    with exactly 1, 2 and 3 out-edges, silent senders and isolated
    receivers; returns (s, r) coalesced."""
    rng = np.random.default_rng(seed)
    s = [rng.integers(0, n - 20, 4 * n)]
    r = [rng.integers(0, n - 10, 4 * n)]    # the last 10 receive nothing
    few = [(0, 80)] + [(node, 1 + i % 3)
                       for i, node in enumerate(range(n - 20, n - 14))]
    for node, k in few:                     # n-14 .. n-1 send nothing
        s.append(np.full(k, node))
        r.append(rng.choice(n - 10, k, replace=False))
    s, r, _ = coalesce_np(np.concatenate(s).astype(np.int32),
                          np.concatenate(r).astype(np.int32), n)
    deg = np.bincount(s, minlength=n)
    assert deg[0] > 64 and all(deg[node] == k for node, k in few[1:])
    assert (deg[n - 14:] == 0).all()
    return s, r


def hub_receiver_graph(n, seed):
    """The receiver-side twin of ``hub_graph``: a hub receiver (node 0,
    > 64 in-edges), receivers with exactly 1, 2 and 3 in-edges (fewer than
    the kernels' 4 edge groups per warp), isolated receivers and silent
    senders; returns (s, r) coalesced."""
    rng = np.random.default_rng(seed)
    s = [rng.integers(0, n - 10, 4 * n)]    # the last 10 send nothing
    r = [rng.integers(0, n - 20, 4 * n)]
    few = [(0, 80)] + [(node, 1 + i % 3)
                       for i, node in enumerate(range(n - 20, n - 14))]
    for node, k in few:                     # n-14 .. n-1 receive nothing
        r.append(np.full(k, node))
        s.append(rng.choice(n - 10, k, replace=False))
    s, r, _ = coalesce_np(np.concatenate(s).astype(np.int32),
                          np.concatenate(r).astype(np.int32), n)
    deg = np.bincount(r, minlength=n)
    assert deg[0] > 64 and all(deg[node] == k for node, k in few[1:])
    assert (deg[n - 14:] == 0).all()
    return s, r


def _gatv2_inputs(n, heads, c, seed):
    """hl, hr, att, g_o, g_d as numpy, att and g_o scaled so the logits
    and the per-head dot are O(1)."""
    rng = np.random.default_rng(seed)
    hl = rng.normal(size=(n, heads, c)).astype(np.float32)
    hr = rng.normal(size=(n, heads, c)).astype(np.float32)
    att = (rng.normal(size=(heads, c)) / np.sqrt(c)).astype(np.float32)
    g_o = (rng.normal(size=(n, heads, c)) / np.sqrt(c)).astype(np.float32)
    g_d = rng.normal(size=(n, heads)).astype(np.float32)
    return hl, hr, att, g_o, g_d


def _jax_v2_backward_packing(npad, heads, c, hl, hr, att, g_o, g_d, m):
    """The packing ``gatv2_attention``'s backward builds for
    ``_v2_edge_pass`` (head interleave, g_d in g_o's ones channel, m
    tiled): ``(coeff, whl, att_rep, fold, hcp, unpack)``, where ``unpack``
    takes a [npad, C_p * H] head-interleaved array back to [n, H, C]."""
    n = hl.shape[0]
    cp = 1
    while cp < c + 1 or (heads * cp) % 128:
        cp *= 2
    hcp = heads * cp

    def interleave(x, fill=None):
        """[n, H, C] -> [npad, C_p * H] head-interleaved; ``fill`` goes in
        channel C (the ones channel of hl, g_d in g_o)."""
        xt = np.zeros((npad, cp, heads), np.float32)
        xt[:n, :c] = x.transpose(0, 2, 1)
        if fill is not None:
            xt[:n, c] = fill
        return jnp.asarray(xt.reshape(npad, hcp))

    def unpack(x):
        return np.asarray(x).reshape(-1, cp, heads).transpose(0, 2, 1)[
            :n, :, :c]

    m_np = np.zeros((npad, heads), np.float32)
    m_np[:n] = m
    coeff = jnp.concatenate([interleave(g_o, fill=g_d), interleave(hr),
                             jnp.tile(jnp.asarray(m_np), (1, cp))], axis=1)
    att_i = np.zeros((cp, heads), np.float32)
    att_i[:c] = att.T
    att_rep = jnp.broadcast_to(jnp.asarray(att_i.reshape(1, hcp)), (8, hcp))
    return (coeff, interleave(hl, fill=1.0), att_rep,
            jattn._fold_matrix(heads, hcp), hcp, unpack)


@pytest.mark.parametrize("heads,c", [(4, 12), (1, 24), (8, 6)])
def test_gatv2_bwd_t_plain_matches_jax_edge_pass(heads, c):
    """``gatv2_bwd_t_plain`` against the JAX ``_v2_edge_pass`` with
    ``_v2_bwd_t_kernel`` in interpret mode, fed the packing that
    ``gatv2_attention``'s backward builds (head interleave, g_d in the ones
    channel, m tiled), on a graph with a hub sender, 1-3-edge senders and
    silent senders (exact zeros)."""
    n = 160
    s, r = hub_graph(n, 11)
    jplan = jax_plan(s, r, n, two_phase=False)
    hl, hr, att, g_o, g_d = _gatv2_inputs(n, heads, c, 12)

    tplan = build_kernel_plan(s, r, n)
    t = [torch.as_tensor(x.reshape(n, -1)) for x in (hl, hr, g_o)]
    m = tat.gatv2_fwd_plain(t[0], t[1], torch.as_tensor(att), tplan.rowptr,
                            tplan.fwd_senders)[2]
    got = tat.gatv2_bwd_t_plain(t[0], t[1], torch.as_tensor(att), m, t[2],
                                torch.as_tensor(g_d), tplan.colptr,
                                tplan.bwd_receivers).numpy()

    coeff, whl, att_rep, fold, hcp, unpack = _jax_v2_backward_packing(
        jplan.n_pad, heads, c, hl, hr, att, g_o, g_d, m.numpy())
    d_whl = jattn._v2_edge_pass(
        jattn._v2_bwd_t_kernel, coeff, whl, att_rep, fold, jplan.bwd_attn,
        hcp, heads=heads, cp=hcp // heads, slope=tat.SLOPE)
    ref = unpack(d_whl).reshape(n, -1)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    silent = np.bincount(s, minlength=n) == 0
    assert silent.sum() >= 14 and np.all(got[silent] == 0)
    assert np.abs(got[0]).max() > 0          # the hub's row


@pytest.mark.parametrize("heads,c", [(4, 12), (1, 24), (8, 6)])
def test_gatv2_bwd_f_plain_matches_jax_edge_pass(heads, c):
    """``gatv2_bwd_f_plain`` against the JAX ``_v2_edge_pass`` with
    ``_v2_bwd_f_kernel`` in interpret mode, fed the same packing, on a
    graph with a hub receiver, 1-3-edge receivers and isolated receivers
    (exact zeros): d_hr at rtol = atol = 1e-4, d_att by relative L2 after
    the JAX per-row partial sums are summed."""
    n = 160
    s, r = hub_receiver_graph(n, 13)
    jplan = jax_plan(s, r, n, two_phase=False)
    hl, hr, att, g_o, g_d = _gatv2_inputs(n, heads, c, 14)

    tplan = build_kernel_plan(s, r, n)
    t = [torch.as_tensor(x.reshape(n, -1)) for x in (hl, hr, g_o)]
    m = tat.gatv2_fwd_plain(t[0], t[1], torch.as_tensor(att), tplan.rowptr,
                            tplan.fwd_senders)[2]
    d_hr, d_att = tat.gatv2_bwd_f_plain(
        t[0], t[1], torch.as_tensor(att), m, t[2], torch.as_tensor(g_d),
        tplan.rowptr, tplan.fwd_senders)
    d_hr = d_hr.numpy()

    coeff, whl, att_rep, fold, hcp, unpack = _jax_v2_backward_packing(
        jplan.n_pad, heads, c, hl, hr, att, g_o, g_d, m.numpy())
    fpass = jattn._v2_edge_pass(
        jattn._v2_bwd_f_kernel, whl, coeff, att_rep, fold, jplan.fwd_attn,
        2 * hcp, heads=heads, cp=hcp // heads, slope=tat.SLOPE)
    np.testing.assert_allclose(d_hr, unpack(fpass[:, :hcp]).reshape(n, -1),
                               rtol=1e-4, atol=1e-4)
    ref_att = unpack(jnp.sum(fpass[:, hcp:], axis=0, keepdims=True))[0]
    assert rel_l2(d_att.numpy(), ref_att) <= 1e-4
    empty = np.bincount(r, minlength=n) == 0
    assert empty.sum() >= 14 and np.all(d_hr[empty] == 0)
    assert np.abs(d_hr[0]).max() > 0         # the hub's row


def grouped_online_softmax(hl, hr, att, rowptr, senders, groups):
    """A pure-torch emulation of the ``gatv2_fwd`` kernel's order: edge
    start + g + t G of a row goes to group g, each group keeps its own
    online softmax state (m, d, o) per head from m = -1e30, d = 0, o = 0,
    and the groups merge by xor partner at offsets 1, 2, ..., G / 2 (the
    kernel's lane offsets P, 2P, ..., 16), group 0's state being the
    row's. Returns ``(o [N, H*C], d [N, H], m [N, H])``."""
    n, hc = hl.shape
    heads, c = att.shape
    deg = rowptr[1:] - rowptr[:-1]
    rows = torch.arange(n)
    m = torch.full((n, groups, heads), tat.EMPTY_MAX)
    d = torch.zeros(n, groups, heads)
    o = torch.zeros(n, groups, heads, c)
    hl3, hr3 = hl.view(n, heads, c), hr.view(n, heads, c)
    for g in range(groups):
        for t in range(-(-int(deg.max()) // groups)):
            pos = g + t * groups
            live = rows[deg > pos]
            s = senders[rowptr[live] + pos].long()
            e = (tat._leaky(hl3[s] + hr3[live]) * att).sum(-1)
            m_new = torch.maximum(m[live, g], e)
            cc = torch.exp(m[live, g] - m_new)
            p = torch.exp(e - m_new)
            d[live, g] = d[live, g] * cc + p
            o[live, g] = o[live, g] * cc[..., None] + p[..., None] * hl3[s]
            m[live, g] = m_new
    off = 1
    while off < groups:
        partner = torch.arange(groups) ^ off
        m_b, d_b, o_b = m[:, partner], d[:, partner], o[:, partner]
        m_new = torch.maximum(m, m_b)
        ca, cb = torch.exp(m - m_new), torch.exp(m_b - m_new)
        d = d * ca + d_b * cb
        o = o * ca[..., None] + o_b * cb[..., None]
        m = m_new
        off *= 2
    return o[:, 0].reshape(n, hc), d[:, 0], m[:, 0]


@pytest.mark.parametrize("groups", [1, 2, 4, 8, 32])
def test_grouped_online_softmax_merge_matches_plain(groups):
    """The forward kernel's order (per-group online softmax, then the
    fixed xor merge of the groups' states) equals ``gatv2_fwd_plain`` at
    rtol = atol = 1e-5 on a graph with a hub receiver and receivers with
    1-3 in-edges; a receiver without in-edges gets exact zeros and
    m = -1e30, and one with a single in-edge the gathered row exactly and
    d = 1, so the empty groups it merges add exact zeros."""
    n, heads, c = 160, 4, 6
    s, r = hub_receiver_graph(n, 15)
    plan = build_kernel_plan(s, r, n)
    hl, hr, att, _, _ = _gatv2_inputs(n, heads, c, 16)
    args = (torch.as_tensor(hl.reshape(n, -1)),
            torch.as_tensor(hr.reshape(n, -1)), torch.as_tensor(att),
            plan.rowptr, plan.fwd_senders)
    got = grouped_online_softmax(*args, groups)
    ref = tat.gatv2_fwd_plain(*args)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    deg = np.bincount(r, minlength=n)
    assert deg[0] > 64 and {0, 1, 2, 3} <= set(deg.tolist())
    empty, one = torch.as_tensor(deg == 0), torch.as_tensor(deg == 1)
    o, d, m = got
    assert torch.all(o[empty] == 0) and torch.all(d[empty] == 0)
    assert torch.all(m[empty] == tat.EMPTY_MAX)
    single = plan.fwd_senders[plan.rowptr[:-1][one]].long()
    assert torch.equal(o[one], args[0][single])
    assert torch.all(d[one] == 1)
