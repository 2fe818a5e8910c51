"""The attention rows past one launch and the conv route, against the
JAX package on the CPU:

- ``sweeps`` covers every column of every (H, C) with H <= 32 and
  H*C <= 2,048 exactly once, each launch one that ``shape_ok`` takes, or
  for GATv2 one ``gatv2w_*`` launch of a head wider than 512 floats;
- ``wide_geometry`` against the constants of the wide kernels' source,
  and ``chip_smoke.WIDE_SMALL_SHAPES`` reaching each of its variants;
- a torch model of ``gatv2w_fwd``'s step rule (``WIDE_FWD_EDGES`` edges
  a step, one online-softmax update a step, masked edges past a row's
  end, a start from -1e30) against JAX's ``gatv2_attention`` in Pallas
  interpret mode and against the plain version;
- the sweeps composed with the plain versions standing in for the
  launches (``run_sweeps``) against the whole-row plain versions, and
  ``gat_attention`` / ``gatv2_attention`` at (3, 250), (1, 750), (2, 600)
  against JAX's in Pallas interpret mode, as
  ``tests/test_attention_kernel.py`` runs them;
- ``_attention_route`` against the route the JAX convs take, and
  ``GATConv`` / ``GATv2Conv`` with 33 heads against JAX's;
- one Adam step of GAT and GATv2 ``ArxivNet`` at h48 H3 against JAX
  through ``export_model_state``.

Tolerances: normalised outputs rtol = atol = 1e-5, m bitwise on receivers
with in-edges, gradients relative L2 <= 1e-5 (the step's <= 1e-4, its
loss rtol 1e-5); the composition against the whole row relative L2 <=
1e-6 (the same sums, split into launches).
"""

import ast
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import jax.experimental.pallas as pl
import egc_tpu.nn.conv.attention as jconv
import egc_tpu.ops.pallas.attention as jattn
import egc_tpu.ops.pallas.gather_reduce as jgr
from egc_tpu.data import synthetic as jsyn
from egc_tpu.exp import fullgraph as jfg
from egc_tpu.exp.weight_port import export_model_state
from egc_tpu.graph.structure import Graph as JGraph
from egc_tpu.graph.transforms import coalesce_np
from egc_tpu.models.nets import ArxivNet as JArxivNet, ConvSpec as JSpec
from egc_tpu.ops.dispatch import GraphKernelPlan, WindowPlanDev

from egc_tpu_torch.exp import fullgraph as tfg
from egc_tpu_torch.exp.weight_port import arxiv_state_dict_from_jax
from egc_tpu_torch.graph.structure import Graph as TGraph
from egc_tpu_torch.models.nets import ArxivNet as TArxivNet, ConvSpec
from egc_tpu_torch.nn.conv import attention as tconv
from egc_tpu_torch.ops.cuda import attention as tat
from egc_tpu_torch.ops.dispatch import build_kernel_plan

torch.set_num_threads(2)
PLAIN = {name: getattr(tat, name + "_plain") for name in tat.launches}
NARROW = ("gat_fwd", "gat_bwd_t", "gat_bwd_f", "gatv2_fwd", "gatv2_bwd_t",
          "gatv2_bwd_f")


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


def wide_hub_graph(seed, n=64):
    """64 nodes: a hub receiver (node 0) and a hub sender (node 1) of 48
    edges each, receivers of exactly 1 and 2 in-edges, 6 isolated
    receivers and 8 silent senders; (s, r) coalesced."""
    rng = np.random.default_rng(seed)
    s = [rng.integers(2, n - 8, 160),
         rng.choice(np.arange(2, n - 8), 48, replace=False), np.full(48, 1),
         np.array([9, 10, 11])]
    r = [rng.integers(5, n - 6, 160), np.zeros(48, np.int64),
         rng.choice(np.arange(5, n - 6), 48, replace=False),
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


def jax_plan(s, r, n):
    """The JAX GraphKernelPlan with small window layouts, as
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

    f = dev(jgr.make_window_plan_np(s, r, npad, block_rows=128,
                                    window_rows=256))
    b = dev(jgr.make_window_plan_np(r, s, npad, block_rows=256,
                                    window_rows=128))
    deg = np.zeros(npad, np.float32)
    np.add.at(deg, r, 1.0)
    return GraphKernelPlan(fwd=f, bwd=b, fwd_attn=f, bwd_attn=b,
                           fwd_v2=None, bwd_v2=None, deg=jnp.asarray(deg),
                           n_pad=npad)


def _cp(heads, c):
    cp = 1
    while cp < c or (heads * cp) % 128:
        cp *= 2
    return cp


def jax_gat(plan, heads, c):
    """(wh, a_src, a_dst) -> (o [N, H, C], d, m) through JAX's
    ``gat_attention``, packed as ``_fused_gat_softmax_sum`` packs it."""
    cp = _cp(heads, c)
    hcp, npad = heads * cp, plan.n_pad

    def f(wh, a_src, a_dst):
        xt = wh.transpose(0, 2, 1)
        if cp > c:
            xt = jnp.concatenate([xt, jnp.ones((npad, 1, heads)),
                                  jnp.zeros((npad, cp - c - 1, heads))], 1)
        src_pack = jnp.concatenate(
            [xt.reshape(npad, hcp), jnp.tile(a_src, (1, cp))], axis=1)
        adst = jnp.pad(a_dst, ((0, 0), (0, 128 - heads)))
        o, md = jattn.gat_attention(src_pack, adst, plan, heads=heads,
                                    cp=cp, dchan=c if cp > c else None)
        o = o.reshape(npad, cp, heads).transpose(0, 2, 1)[:, :, :c]
        return o, md[:, 64:64 + heads], md[:, :heads]

    return f


def jax_gatv2(plan, heads, c):
    """(hl, hr, att) -> (o [N, H, C], d, m) through JAX's
    ``gatv2_attention``, packed as ``_fused_gatv2_softmax_sum`` packs it."""
    cp = _cp(heads, c)
    assert cp > c
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
        return o, md[:, 64:64 + heads], md[:, :heads]

    return f


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v2", [False, True], ids=["gat", "gatv2"])
def test_sweeps_cover_every_column_once(v2):
    """Every 1 <= H <= 32 and H*C <= 2,048: the launches' columns
    partition the row; a narrow launch is one ``shape_ok`` takes, a wide
    one (GATv2 only) holds the whole row of heads wider than 512 floats
    and ``wide_shape_ok`` takes it. A GAT head's channel ranges are equal
    where their number divides C, one apart otherwise, and share one edge
    geometry P; a shape ``shape_ok`` takes is one launch of the row."""
    shapes = 0
    for heads in range(1, tat.MAX_HEADS + 1):
        for c in range(1, 2048 // heads + 1):
            plan = tat.sweeps(heads, c, v2=v2)
            cols = []
            for sw in plan:
                assert sw.head + sw.heads <= heads
                assert sw.chan + sw.channels <= c
                if sw.wide:
                    assert v2 and c > tat.MAX_WIDTH
                    assert tat.wide_shape_ok(sw.heads, sw.channels)
                else:
                    assert tat.shape_ok(sw.heads, sw.channels)
                cols += [h * c + sw.chan + k
                         for h in range(sw.head, sw.head + sw.heads)
                         for k in range(sw.channels)]
            assert sorted(cols) == list(range(heads * c)), (heads, c)
            if tat.shape_ok(heads, c):
                assert plan == [tat.Sweep(0, heads, 0, c)]
            if not v2 and c > tat.MAX_WIDTH:
                for h in range(heads):
                    widths = [sw.channels for sw in plan if sw.head == h]
                    assert max(widths) - min(widths) <= 1
                    if c % len(widths) == 0:
                        assert len(set(widths)) == 1
                    assert len({tat.edge_geometry(1, w)[0]
                                for w in widths}) == 1
            shapes += 1
    assert shapes == sum(2048 // h for h in range(1, 33))
    assert tat.sweeps(3, 250) == [tat.Sweep(0, 2, 0, 250),
                                  tat.Sweep(2, 1, 0, 250)]
    assert tat.sweeps(1, 750) == [tat.Sweep(0, 1, 0, 375),
                                  tat.Sweep(0, 1, 375, 375)]
    assert tat.sweeps(1, 750, v2=True) == [tat.Sweep(0, 1, 0, 750, True)]


def test_sweeps_refuse_shapes_past_their_rule():
    """Past 32 heads, or a GATv2 head past ``WIDE_MAX_CHANNELS``: raised
    with the rule in the message."""
    with pytest.raises(ValueError, match="1 <= H <= 32"):
        tat.sweeps(33, 8)
    with pytest.raises(ValueError, match="at most 4096 channels"):
        tat.sweeps(1, tat.WIDE_MAX_CHANNELS + 1, v2=True)
    assert tat.sweeps(1, tat.WIDE_MAX_CHANNELS + 1)   # GAT: any width


ROOT = Path(__file__).resolve().parents[1]
WIDE_CU = ROOT / "egc_tpu_torch" / "csrc" / "gatv2_attention_wide.cu"


def _cu_constant(name: str) -> int:
    found = re.search(rf"constexpr int {name} = (\d+);", WIDE_CU.read_text())
    assert found, name
    return int(found.group(1))


def test_wide_bwd_geometry_is_the_kernels_rule():
    """``wide_geometry``, the blocks of all three wide kernels, against
    the constants of ``csrc/gatv2_attention_wide.cu``: for every C the
    rule takes, the fewest warps of ``WIDE_CHANS`` channels a thread that
    hold the head, at most ``WIDE_MAX_WARPS``; 2-float vectors where C is
    even; any H the rule takes alike; a shape the rule refuses raises.
    The forward's edges a step, ``WIDE_FWD_EDGES``, is the source's, and
    its step rule keeps G rows of ``WIDE_CHANS`` floats a thread."""
    assert tat.WIDE_CHANS == _cu_constant("kWideChans")
    assert tat.WIDE_MAX_WARPS == _cu_constant("kMaxWideWarps")
    assert tat.WIDE_MAX_CHANNELS == _cu_constant("kMaxWideChannels")
    assert tat.WIDE_FWD_EDGES == _cu_constant("kFwdEdges")
    assert 3 <= tat.WIDE_FWD_EDGES <= 6
    src = WIDE_CU.read_text()
    for kernel in ("gatv2w_fwd_kernel", "gatv2w_bwd_t_kernel",
                   "gatv2w_bwd_f_kernel"):
        assert re.search(r"__launch_bounds__\(kMaxWideWarps \* 32\)\n"
                         rf"{kernel}\(", src), kernel
    assert src.count("wide_warps(a.channels) * 32") == 1   # one launch
    lanes = 32 * tat.WIDE_CHANS
    for c in range(1, tat.WIDE_MAX_CHANNELS + 1):
        warps, vector = tat.wide_geometry(1, c)
        assert 1 <= warps <= tat.WIDE_MAX_WARPS
        assert (warps - 1) * lanes < c <= warps * lanes
        assert vector == (1 if c % 2 else 2)
        assert tat.wide_geometry(tat.MAX_HEADS, c) == (warps, vector)
    assert tat.wide_geometry(1, 750) == (4, 2)
    for hc in ((0, 8), (tat.MAX_HEADS + 1, 8), (1, 0),
               (1, tat.WIDE_MAX_CHANNELS + 1)):
        with pytest.raises(ValueError, match="wide GATv2 kernels take"):
            tat.wide_geometry(*hc)


def test_chip_smoke_holds_every_wide_backward_variant():
    """``chip_smoke.WIDE_SMALL_SHAPES`` reach both vector widths of the
    blocks of all three wide kernels and the most warps the rule needs
    (C = 4,096), and hold the arxiv head (1, 750) and more than one head;
    phase 2 checks all six instantiations (two of each kernel) for
    spills; the small graph has receivers of G - 1 and G + 1 in-edges for
    the forward's G edges a step."""
    text = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    shapes = next(ast.literal_eval(node.value) for node in ast.walk(tree)
                  if isinstance(node, ast.Assign)
                  and any(getattr(t, "id", None) == "WIDE_SMALL_SHAPES"
                          for t in node.targets))
    geometries = {tat.wide_geometry(*hc) for hc in shapes}
    assert {vector for _, vector in geometries} == {1, 2}
    assert max(warps for warps, _ in geometries) == \
        tat.wide_geometry(1, tat.WIDE_MAX_CHANNELS)[0]
    assert (1, 750) in shapes and max(h for h, _ in shapes) > 1
    assert 'ln.startswith("gatv2w_")' in text and "len(wide) == 6" in text
    assert "groups.add(at.WIDE_FWD_EDGES)" in text


def _kernel_args(name, plan, n, heads, c, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale)
                               .astype(np.float32))

    if name.startswith("gatv2"):
        hl, hr, att = t(n, heads * c), t(n, heads * c), \
            t(heads, c, scale=c ** -0.5)
        m = tat.gatv2_fwd_plain(hl, hr, att, plan.rowptr,
                                plan.fwd_senders)[2]
        head = (hl, hr, att)
    else:
        wh, a_src, a_dst = t(n, heads * c), t(n, heads), t(n, heads)
        m = tat.gat_fwd_plain(wh, a_src, a_dst, plan.rowptr,
                              plan.fwd_senders)[2]
        head = (wh, a_src, a_dst)
    if name.endswith("_fwd"):
        return head + (plan.rowptr, plan.fwd_senders)
    graph = (plan.colptr, plan.bwd_receivers) if name.endswith("_bwd_t") \
        else (plan.rowptr, plan.fwd_senders)
    return head + (m, t(n, heads * c, scale=c ** -0.5), t(n, heads)) + graph


@pytest.mark.parametrize("heads,c", [(3, 250), (1, 750), (2, 600), (1, 513),
                                     (5, 100)])
@pytest.mark.parametrize("name", NARROW)
def test_composition_equals_the_whole_row(name, heads, c):
    """Each kernel over its sweeps, the plain versions standing in for the
    launches, against the plain version over the whole row: relative L2
    <= 1e-6 per output (m bitwise: the forward's max is order-free)."""
    n = 64
    s, r = wide_hub_graph(2)
    plan = build_kernel_plan(s, r, n)
    args = _kernel_args(name, plan, n, heads, c, seed=heads * 1000 + c)
    got = tat.run_sweeps(name, args, heads, c, PLAIN)
    ref = PLAIN[name](*args)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, i
        assert rel_l2(a, b) <= 1e-6, (i, rel_l2(a, b))
    if name.endswith("_fwd"):
        assert torch.equal(got[2], ref[2])


def test_run_sweeps_counts_each_launch():
    """(3, 250): two narrow launches; GAT (1, 750): two; GATv2 (1, 750):
    one ``gatv2w_fwd``; a shape ``shape_ok`` takes: one, on the row as it
    is."""
    n = 64
    s, r = wide_hub_graph(2)
    plan = build_kernel_plan(s, r, n)
    for name, heads, c, want in (("gat_fwd", 3, 250, {"gat_fwd": 2}),
                                 ("gat_bwd_t", 1, 750, {"gat_bwd_t": 2}),
                                 ("gatv2_fwd", 1, 750, {"gatv2w_fwd": 1}),
                                 ("gatv2_bwd_f", 3, 250, {"gatv2_bwd_f": 2}),
                                 ("gatv2_fwd", 8, 14, {"gatv2_fwd": 1})):
        calls = {}
        args = _kernel_args(name, plan, n, heads, c, seed=1)

        def counted(kernel):
            def run(*a):
                calls[kernel] = calls.get(kernel, 0) + 1
                if tat.sweeps(heads, c, name.startswith("gatv2")) == \
                        [tat.Sweep(0, heads, 0, c)]:
                    assert all(x is y for x, y in zip(a, args))
                return PLAIN[kernel](*a)
            return run

        tat.run_sweeps(name, args, heads, c,
                       {k: counted(k) for k in PLAIN})
        assert calls == want, (name, heads, c)


# ---------------------------------------------------------------------------
# against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------

def _against_jax(jf, port, inputs, s, r, n, seed):
    """Normalised outputs, m and the gradients of a fixed projection of
    the outputs, JAX ``jf`` against the port's autograd ``port``."""
    jplan = jax_plan(s, r, n)
    npad = jplan.n_pad
    has = np.bincount(r, minlength=n) > 0
    heads, c = inputs[0].shape[1:]
    rng = np.random.default_rng(seed)
    proj = (rng.normal(size=(n, heads, c)) / np.sqrt(c)).astype(np.float32) \
        * has[:, None, None]

    def pad(x):
        if x.shape[0] != n:        # att
            return jnp.asarray(x)
        return jnp.zeros((npad,) + x.shape[1:]).at[:n].set(x)

    def jloss(*xs):
        o, d, m = jf(jplan)(*xs)
        out = o[:n] / jnp.maximum(d[:n], 1e-16)[:, :, None]
        return jnp.sum(out * proj), (out, m[:n])

    (_, (jout, jm)), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(len(inputs))), has_aux=True)(
        *[pad(x) for x in inputs])
    tw = [torch.tensor(x, requires_grad=True) for x in inputs]
    o, d, m = port(*tw, build_kernel_plan(s, r, n))
    out = o / torch.clamp(d, min=1e-16)[:, :, None]
    (out * torch.as_tensor(proj)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy()[has],
                               np.asarray(jout)[has], rtol=1e-5, atol=1e-5)
    assert torch.all(o[~torch.as_tensor(has)] == 0)
    for t, g in zip(tw, jg):
        assert rel_l2(t.grad.numpy(), np.asarray(g)[:t.shape[0]]) <= 1e-5
    return m.numpy()[has], np.asarray(jm)[has]


@pytest.mark.parametrize("heads,c", [(3, 250), (1, 750)])
def test_gat_sweeps_match_jax(heads, c):
    """GAT over two launches of whole heads (3, 250) or of one head's
    channel ranges (1, 750), the plain versions standing in for the
    launches, against JAX's ``gat_attention`` (m bitwise)."""
    assert len(tat.sweeps(heads, c)) == 2
    n = 64
    s, r = wide_hub_graph(8)
    rng = np.random.default_rng(9)
    inputs = (rng.normal(size=(n, heads, c)).astype(np.float32),
              rng.normal(size=(n, heads)).astype(np.float32),
              rng.normal(size=(n, heads)).astype(np.float32))
    m, jm = _against_jax(lambda p: jax_gat(p, heads, c), tat.gat_attention,
                         inputs, s, r, n, seed=10)
    np.testing.assert_array_equal(m, jm)


@pytest.mark.parametrize("heads,c", [(3, 250), (1, 750), (2, 600)])
def test_gatv2_sweeps_and_wide_match_jax(heads, c):
    """GATv2 over two launches of whole heads (3, 250), and the
    ``gatv2w_*`` plain versions in one launch of heads wider than 512
    floats (1, 750), (2, 600), against JAX's ``gatv2_attention``."""
    plan = tat.sweeps(heads, c, v2=True)
    assert len(plan) == 2 if c <= tat.MAX_WIDTH else plan[0].wide
    n = 64
    s, r = wide_hub_graph(10)
    rng = np.random.default_rng(11)
    inputs = (rng.normal(size=(n, heads, c)).astype(np.float32),
              rng.normal(size=(n, heads, c)).astype(np.float32),
              (rng.normal(size=(heads, c)) / np.sqrt(c)).astype(np.float32))
    _against_jax(lambda p: jax_gatv2(p, heads, c), tat.gatv2_attention,
                 inputs, s, r, n, seed=12)


def step_rule_graph(g, n=64):
    """A hub receiver (node 0, 48 in-edges), receivers of exactly 1,
    g - 1, g, g + 1 and 2 g + 1 in-edges (nodes 1-5) and 6 receivers
    without in-edges (the last); (s, r) coalesced."""
    rng = np.random.default_rng(g)
    counts = {0: 48, 1: 1, 2: g - 1, 3: g, 4: g + 1, 5: 2 * g + 1}
    s, r = [rng.integers(0, n, 160)], [rng.integers(6, n - 6, 160)]
    for node, k in counts.items():
        s.append(rng.choice(n, k, replace=False))
        r.append(np.full(k, node))
    s, r, _ = coalesce_np(np.concatenate(s).astype(np.int32),
                          np.concatenate(r).astype(np.int32), n)
    in_deg = np.bincount(r, minlength=n)
    assert [in_deg[v] for v in counts] == list(counts.values())
    assert (in_deg[n - 6:] == 0).all()
    return s, r


def wide_fwd_steps(hl, hr, att, rowptr, senders, steps):
    """``gatv2w_fwd``'s step rule in torch: each row walks its in-edges
    ``steps`` at a time; a step's logits fold into one (m, d, o) state
    per (row, head) in one rescale, m' = max(m, the step's logits),
    c = exp(m - m'), p_g = exp(e_g - m') (0 past the row's end),
    d = d c + sum_g p_g, o = o c + sum_g p_g hl_g in g order, from
    m = -1e30, d = 0, o = 0. A row past its end takes steps that change
    nothing (c = 1, p = 0)."""
    n = rowptr.shape[0] - 1
    heads, c = att.shape
    hl3, hr3 = hl.view(-1, heads, c), hr.view(n, heads, c)
    start, deg = rowptr[:-1].long(), (rowptr[1:] - rowptr[:-1]).long()
    m = torch.full((n, heads), tat.EMPTY_MAX)
    d = torch.zeros(n, heads)
    o = torch.zeros(n, heads, c)
    for base in range(0, int(deg.max()), steps):
        k = base + torch.arange(steps)
        valid = k[None, :] < deg[:, None]                       # [n, G]
        x = hl3[senders.long()[torch.where(valid, start[:, None] + k, 0)]]
        x = torch.where(valid[..., None, None], x, 0.0)         # [n, G, H, C]
        z = x + hr3[:, None]
        e = (att * torch.where(z >= 0, z, tat.SLOPE * z)).sum(-1)
        e = torch.where(valid[..., None], e, -torch.inf)        # [n, G, H]
        m_new = torch.maximum(m, e.amax(1))
        corr = torch.exp(m - m_new)
        p = torch.where(valid[..., None], torch.exp(e - m_new[:, None]), 0.0)
        d, o = d * corr, o * corr[..., None]
        for g in range(steps):
            d = d + p[:, g]
            o = o + p[:, g, :, None] * x[:, g]
        m = m_new
    return o.reshape(n, heads * c), d, m


@pytest.mark.parametrize("heads,c", [(1, 750), (3, 513)])
def test_wide_fwd_step_rule_matches_jax(heads, c):
    """The forward kernel's order (``wide_fwd_steps`` at the kernel's
    ``WIDE_FWD_EDGES``) on rows of 0, 1, G - 1, G, G + 1, 2 G + 1 and 48
    in-edges: o, d and m against JAX's ``gatv2_attention`` in Pallas
    interpret mode and against the plain version, rtol = atol = 1e-5 on
    receivers with in-edges; a receiver without in-edges o = d = 0 and
    m = -1e30 exactly."""
    steps = tat.WIDE_FWD_EDGES
    n = 64
    s, r = step_rule_graph(steps, n)
    rng = np.random.default_rng(heads * 1000 + c)
    hl = rng.normal(size=(n, heads, c)).astype(np.float32)
    hr = rng.normal(size=(n, heads, c)).astype(np.float32)
    att = (rng.normal(size=(heads, c)) / np.sqrt(c)).astype(np.float32)
    plan = build_kernel_plan(s, r, n)
    args = (torch.as_tensor(hl).reshape(n, -1),
            torch.as_tensor(hr).reshape(n, -1), torch.as_tensor(att),
            plan.rowptr, plan.fwd_senders)
    got = wide_fwd_steps(*args, steps)
    jplan = jax_plan(s, r, n)

    def pad(x):
        return jnp.zeros((jplan.n_pad,) + x.shape[1:]).at[:n].set(x)

    jo, jd, jm = jax_gatv2(jplan, heads, c)(pad(hl), pad(hr),
                                            jnp.asarray(att))
    has = np.bincount(r, minlength=n) > 0
    for a, b in zip(got, (np.asarray(jo)[:n].reshape(n, -1),
                          np.asarray(jd)[:n], np.asarray(jm)[:n])):
        np.testing.assert_allclose(a.numpy()[has], b[has], rtol=1e-5,
                                   atol=1e-5)
    for a, b in zip(got, tat.gatv2w_fwd_plain(*args)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    o, d, m = (t[torch.as_tensor(~has)] for t in got)
    assert torch.all(o == 0) and torch.all(d == 0)
    assert torch.all(m == tat.EMPTY_MAX)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

def _jax_graph(s, r, x):
    g = jax.tree.map(jnp.asarray, JGraph.from_coo(x, s, r))
    return g.replace(kernel_plan=jax_plan(s, r, x.shape[0]))


@pytest.mark.parametrize("kind", ["gat", "gatv2"])
def test_route_is_the_jax_convs(monkeypatch, kind):
    """``_attention_route`` against the route JAX's convs take on the
    accelerator (its backend and fused path stubbed: the fused call is
    recorded), for H in {1, 32, 33}, train and eval, at attention dropout
    0 (the port's only rate). C is 3, where JAX's GATv2
    ``_attn_cp(H, C) > C`` holds for every H."""
    n, c = 40, 3
    s, r = wide_hub_graph(4, n=64)
    keep = (s < n) & (r < n)
    s, r = s[keep], r[keep]
    x = np.random.default_rng(5).normal(size=(n, 6)).astype(np.float32)
    g = _jax_graph(s, r, x)
    fused = "_fused_gat_softmax_sum" if kind == "gat" else \
        "_fused_gatv2_softmax_sum"
    took = []

    def stub(*args):
        took.append(True)
        h = args[1]
        return jnp.zeros(h.shape, h.dtype)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jconv, fused, stub)
    ctor = jconv.GATConv if kind == "gat" else jconv.GATv2Conv
    for heads in (1, 32, 33):
        assert jconv._attn_cp(heads, c) > c
        conv = ctor(out_channels=c, heads=heads)
        variables = conv.init(jax.random.PRNGKey(0), g, jnp.asarray(x))
        for train in (False, True):
            took.clear()
            conv.apply(variables, g, jnp.asarray(x), train=train,
                       rngs={"dropout": jax.random.PRNGKey(1)})
            want = "kernel" if took else "segment"
            assert tconv._attention_route(heads) == want, (heads, train)


def _port_conv(kind, fin, c, heads, params):
    """The port's conv with JAX's ``params`` (the weight port's rules)."""
    sd = arxiv_state_dict_from_jax({"params": {
        f"{'GATConv' if kind == 'gat' else 'GATv2Conv'}_0":
            jax.tree.map(np.asarray, params),
        "embed": _dense(1, 1), "out": _dense(1, 1)}})
    conv = (tconv.GATConv if kind == "gat" else tconv.GATv2Conv)(
        fin, c, heads=heads)
    conv.load_state_dict({k[len("convs.0."):]: v for k, v in sd.items()
                          if k.startswith("convs.0.")}, strict=True)
    return conv


def _dense(i, o):
    return {"kernel": np.zeros((i, o), np.float32),
            "bias": np.zeros((o,), np.float32)}


def _conv_case(kind, heads, c, seed):
    """JAX's conv and the port's from the same weights on a hub graph, in
    training: values and the gradients of a fixed projection w.r.t. the
    input and every parameter; returns (port out, JAX out, port grads,
    JAX grads)."""
    n, fin = 64, 12
    s, r = wide_hub_graph(seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(n, fin)).astype(np.float32)
    proj = rng.normal(size=(n, heads * c)).astype(np.float32)
    gj = jax.tree.map(jnp.asarray, JGraph.from_coo(x, s, r))
    ctor = jconv.GATConv if kind == "gat" else jconv.GATv2Conv
    conv = ctor(out_channels=c, heads=heads)
    params = conv.init(jax.random.PRNGKey(seed), gj, jnp.asarray(x))["params"]
    params = {**params, "bias": jnp.asarray(
        rng.normal(size=(heads * c,)).astype(np.float32))}
    def fj(p, xx):
        out = conv.apply({"params": p}, gj, xx, train=True,
                         rngs={"dropout": jax.random.PRNGKey(7)})
        return jnp.sum(out * proj), out

    (_, jout), (gp, gx) = jax.value_and_grad(fj, argnums=(0, 1),
                                             has_aux=True)(
        params, jnp.asarray(x))
    tc = _port_conv(kind, fin, c, heads, params)
    gt = TGraph.from_coo(x, s, r)
    xt = torch.tensor(x, requires_grad=True)
    out = tc(gt, xt)
    (out * torch.as_tensor(proj)).sum().backward()
    port_grads = {"x": xt.grad.numpy(), **{
        name: p.grad.numpy() for name, p in tc.named_parameters()}}
    jsd = {k[len("convs.0."):]: v.numpy() for k, v in
           arxiv_state_dict_from_jax({"params": {
               f"{'GATConv' if kind == 'gat' else 'GATv2Conv'}_0":
                   jax.tree.map(np.asarray, gp),
               "embed": _dense(1, 1), "out": _dense(1, 1)}}).items()
           if k.startswith("convs.0.")}
    jax_grads = {"x": np.asarray(gx), **jsd}
    return out.detach().numpy(), np.asarray(jout), port_grads, jax_grads


@pytest.mark.parametrize("kind", ["gat", "gatv2"])
def test_convs_with_33_heads_match_jax(kind):
    """H = 33 (past the kernels' 32: the segment path on the card too):
    values and gradients against JAX's conv."""
    got, ref, g_got, g_ref = _conv_case(kind, 33, 3, seed=20)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    for name in g_ref:
        assert rel_l2(g_got[name], g_ref[name]) <= 1e-5, name


# ---------------------------------------------------------------------------
# one step of the slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gat", "gatv2"])
def test_arxiv_net_h3_one_step_matches_jax(kind):
    """One dropout-0 training step (``train_step``: the loss, its
    gradients, Adam at lr 0.01, wd 5e-4) of ArxivNet at hidden 48, 3 heads
    (layers (3, 16), (3, 16), (1, 48)) on a 300-node graph, the port's
    weights from ``export_model_state``: the loss at rtol 1e-5, every
    gradient at relative L2 <= 1e-4 (a conv's bias feeds a BatchNorm, so
    its gradient is noise on both sides)."""
    raw = jsyn.synthetic_full_graph(num_nodes=300, avg_degree=8, seed=1)
    jd = jfg.full_graph_to_device_dict(raw, use_kernel=False)
    td = tfg.full_graph_to_device_dict(raw, device="cpu")
    jm = JArxivNet(conv=JSpec(kind=kind, heads=3), hidden_dim=48,
                   num_layers=3, dropout=0.0)
    tm = TArxivNet(ConvSpec(kind=kind, heads=3), 48, num_layers=3,
                   dropout=0.0)
    convs = [c for c in tm.convs]
    assert [(c.heads, c.out_channels) for c in convs] == \
        [(3, 16), (3, 16), (1, 48)]
    variables = jm.init(jax.random.PRNGKey(3), jd["graph"], train=False)
    tm.load_state_dict({k: torch.as_tensor(v) for k, v in export_model_state(
        "arxiv", kind, jax.tree.map(np.asarray, variables)).items()},
        strict=True)
    params, bstats = variables["params"], variables["batch_stats"]
    y, mask = jd["y"], jd["masks"]["train"]

    def loss_fn(p):
        out, _ = jm.apply({"params": p, "batch_stats": bstats}, jd["graph"],
                          train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                          mutable=["batch_stats"])
        return jfg.FullGraphConfig.loss_fn(None, out, (y, mask), None)

    loss_j, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    opt = torch.optim.Adam(tm.parameters(), lr=0.01, weight_decay=5e-4)
    loss_t = tfg.train_step(tm, opt, td)
    assert loss_t.item() == pytest.approx(float(loss_j), rel=1e-5)
    g_sd = export_model_state("arxiv", kind, {
        "params": jax.tree.map(np.asarray, grads),
        "batch_stats": jax.tree.map(np.asarray, bstats)})
    scale = max(float(np.abs(np.asarray(g_sd[k])).max())
                for k, _ in tm.named_parameters())
    for name, p in tm.named_parameters():
        ref = np.asarray(g_sd[name])
        if re.fullmatch(r"convs\.\d+\.bias", name):
            assert np.abs(p.grad.numpy()).max() <= 1e-6 * scale, name
            assert np.abs(ref).max() <= 1e-6 * scale, name
            continue
        assert rel_l2(p.grad.numpy(), ref) <= 1e-4, name
