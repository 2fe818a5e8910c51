"""GAT and GATv2 edge-softmax kernels (counterpart of
``egc_tpu.ops.pallas.attention``), their plain PyTorch versions and the
autograd functions ``gat_attention`` and ``gatv2_attention``.

GAT. Per head, with z_sr = a_src[s] + a_dst[r] and e_sr = leaky_relu(z_sr)
(slope 0.2) over the in-edges s -> r of each receiver r:

- ``gat_fwd`` replaces ``gat_fwd`` and the max pass that precedes it
  (``windowed_gather_reduce(max)`` in ``_gat_attention_cached``): per
  receiver, m_r = max_s e_sr, o_r = sum_s exp(e_sr - m_r) wh_s and
  d_r = sum_s exp(e_sr - m_r). An empty receiver gets o = 0, d = 0 and
  m = -1e30.
- ``gat_bwd_t`` replaces ``_edge_pass(_bwd_t_kernel)``: per sender s, over
  its out-edges, d_wh[s] = sum_r a g_o[r] and d_asrc[s] = sum_r dz.
- ``gat_bwd_f`` replaces ``_edge_pass(_bwd_f_kernel)``: per receiver r,
  d_adst[r] = sum_s dz.

Here a = exp(e_sr - m_r), q = sum_c g_o[r,h,c] wh[s,h,c],
de = a (q + g_d[r]) and dz = de lrelu'(z). m is not differentiable (the
flash convention of ``egc_tpu/ops/pallas/attention.py:245-269``): every
consumer of (o, d, m) is invariant to m, so the backward has no max-tie
term.

GATv2. Per edge s -> r and head h, with z = hl[s] + hr[r] ([H, C]) and
the logit e_h = sum_c att[h,c] leaky_relu(z_hc):

- ``gatv2_fwd`` replaces ``_gatv2_attention_cached.impl`` (bodies
  ``_v2_fwd_kernel`` and ``_v2_fwd_kernel_tp``): per receiver, m, o and d
  as for GAT with hl[s] as the value (online max in the kernel).
- ``gatv2_bwd_t`` replaces ``_v2_edge_pass(_v2_bwd_t_kernel)`` and
  ``_v2_edge_pass_tp``: per sender s, over its out-edges,
  d_hl[s] = sum_r (a g_o[r] + dz).
- ``gatv2_bwd_f`` replaces ``_v2_edge_pass(_v2_bwd_f_kernel)`` and
  ``_v2_edge_pass_tp_f``: per receiver r, d_hr[r] = sum_s dz, and
  d_att = sum over all edges of de leaky_relu(z) ([H, C]).

Here a = exp(e - m_r), q_h = sum_c g_o[r,h,c] hl[s,h,c], de = a (q + g_d[r])
and dz = de att leaky_relu'(z) (``_v2_edge_grad``; the JAX kernels carry
g_d in a ones channel of hl). m is not differentiable, as for GAT.

The boundary keeps the JAX package's layout, heads x channels: wh, hl and
hr are ``[N, H, C]`` (the kernels see them as ``[N, H*C]``), att is
``[H, C]``, per-head scalars are ``[N, H]``. A CPU tensor runs the plain
version; a CUDA tensor launches the kernel in ``csrc/gat_attention.cu`` or
``csrc/gatv2_attention.cu`` or raises. A launch of those six kernels takes
(H, C) if and only if 1 <= H <= 32 and the edge group of
``edge_geometry(H, C)`` fits a warp (P <= 32): ``shape_ok``, the rule of
``csrc/edge_groups.cuh``. That reaches H*C = 512 (32 lanes of at most 16
channels), the ogbg-code2 widths (H8, C38), (H1, C304), (H8, C37) and (H1,
C296) among them; a single launch past it raises with the rule in the
message.

Wider rows. ``gat_attention`` and ``gatv2_attention`` take any 1 <= H <= 32
and C >= 1 (GATv2: C <= ``WIDE_MAX_CHANNELS``) by sweeping a row in
several launches (``sweeps``, composed by ``run_sweeps``):

- groups of whole heads whose edge group fits a warp, e.g. (3, 250) as
  (2, 250) + (1, 250): each head's logits, m, d and o come from one
  launch, so this is exact for GAT and GATv2;
- a GAT head wider than 512 floats in channel ranges of one edge geometry
  (equal where the count divides C), e.g. (1, 750) as 2 x (1, 375): GAT's
  logit a_src[s] + a_dst[r] is a per-head scalar, so every launch forms
  the same logits and, with one geometry, the same summation order: m and
  d come out bitwise equal, and are taken from the first range. In the
  backward q = sum_c g_o wh is additive over channels: g_d goes to the
  first range only (zeros to the others), and d_asrc / d_adst are summed
  over the ranges;
- a GATv2 row with a head wider than 512 floats in one launch of
  ``gatv2w_fwd``, ``gatv2w_bwd_t`` and ``gatv2w_bwd_f``
  (``csrc/gatv2_attention_wide.cu``): a GATv2 logit needs the head's whole
  row before the softmax, so its channels do not split. They have the
  arguments and outputs of the narrow three, and take (H, C) if and only
  if ``wide_shape_ok``: 1 <= H <= 32 and C <= ``WIDE_MAX_CHANNELS``. Their
  plain versions are the narrow kernels' (``gatv2_*_plain`` take any
  width). The three give a block a (row, head), its threads
  ``WIDE_CHANS`` channels each (``wide_geometry``); the forward walks a
  row ``WIDE_FWD_EDGES`` edges a step, with one online-softmax update a
  step, and ``gatv2w_bwd_f`` writes one row of d_att partial sums a
  block, as many as ``gatv2w_att_rows`` says for the device.

A shape that ``shape_ok`` takes is one launch, on the row as it is.
``launches`` counts kernel launches, every sweep's.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch

from egc_tpu_torch.ops.cuda import _build
from egc_tpu_torch.ops.cuda.gather_reduce import _row_ids

SLOPE = 0.2
EMPTY_MAX = -1e30      # m of a receiver without in-edges
MAX_HEADS = 32         # kMaxHeads in csrc/warp_rows.cuh
MAX_CHANS = 16         # kMaxChans in csrc/edge_groups.cuh
MAX_WIDTH = 32 * MAX_CHANS   # the widest row (H*C) of any accepted shape
SHAPE_RULE = (f"1 <= H <= {MAX_HEADS} heads and an edge group of at most 32 "
              f"lanes (edge_geometry(H, C)[0] <= 32, so H*C <= {MAX_WIDTH})")
WIDE_MAX_CHANNELS = 4096   # kMaxWideChannels in csrc/gatv2_attention_wide.cu
WIDE_CHANS = 6             # kWideChans: a thread's channels
WIDE_MAX_WARPS = 24        # kMaxWideWarps: a block's warps at most
WIDE_FWD_EDGES = 4         # kFwdEdges: gatv2w_fwd's edges a block step
WIDE_RULE = (f"1 <= H <= {MAX_HEADS} heads of at most {WIDE_MAX_CHANNELS} "
             f"channels each (so H*C <= {MAX_HEADS * WIDE_MAX_CHANNELS})")

launches: Dict[str, int] = {"gat_fwd": 0, "gat_bwd_t": 0, "gat_bwd_f": 0,
                            "gatv2_fwd": 0, "gatv2_bwd_t": 0,
                            "gatv2_bwd_f": 0, "gatv2w_fwd": 0,
                            "gatv2w_bwd_t": 0, "gatv2w_bwd_f": 0}


def _leaky(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z >= 0, z, SLOPE * z)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def gat_fwd_plain(wh, a_src, a_dst, rowptr, senders
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 5 (any device): ``(o [N, H*C],
    d [N, H], m [N, H])`` over the CSR ``(rowptr, senders)``."""
    n, hc = wh.shape
    heads = a_src.shape[1]
    rows = _row_ids(rowptr)
    s = senders.long()
    e = _leaky(a_src[s] + a_dst[rows])                           # [E, H]
    m = a_src.new_full((n, heads), EMPTY_MAX).scatter_reduce_(
        0, rows[:, None].expand(-1, heads), e, "amax")
    p = torch.exp(e - m[rows])
    o = wh.new_zeros(n, heads, hc // heads).index_add_(
        0, rows, p[:, :, None] * wh.view(n, heads, -1)[s])
    d = a_src.new_zeros(n, heads).index_add_(0, rows, p)
    return o.view(n, hc), d, m


def _edge_grads(wh, a_src, a_dst, m, g_o, g_d, s, r):
    """Per edge (s -> r) and head: alpha-hat ``a``, the gathered ``g_o[r]``
    rows and ``dz``."""
    n = wh.shape[0]
    heads = a_src.shape[1]
    z = a_src[s] + a_dst[r]
    a = torch.exp(_leaky(z) - m[r])
    g_r = g_o.view(n, heads, -1)[r]
    q = (g_r * wh.view(n, heads, -1)[s]).sum(-1)
    dz = a * (q + g_d[r]) * torch.where(z >= 0, 1.0, SLOPE)
    return a, g_r, dz


def gat_bwd_t_plain(wh, a_src, a_dst, m, g_o, g_d, colptr, receivers
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 6 (any device): ``(d_wh [N, H*C],
    d_asrc [N, H])`` over the transposed CSC ``(colptr, receivers)``."""
    n, hc = wh.shape
    s, r = _row_ids(colptr), receivers.long()
    a, g_r, dz = _edge_grads(wh, a_src, a_dst, m, g_o, g_d, s, r)
    d_wh = wh.new_zeros((n,) + g_r.shape[1:]).index_add_(
        0, s, a[:, :, None] * g_r)
    return d_wh.view(n, hc), a_src.new_zeros(a_src.shape).index_add_(0, s, dz)


def gat_bwd_f_plain(wh, a_src, a_dst, m, g_o, g_d, rowptr, senders
                    ) -> torch.Tensor:
    """Plain PyTorch version of kernel 7 (any device): ``d_adst [N, H]``
    over the CSR ``(rowptr, senders)``."""
    r, s = _row_ids(rowptr), senders.long()
    _, _, dz = _edge_grads(wh, a_src, a_dst, m, g_o, g_d, s, r)
    return a_dst.new_zeros(a_dst.shape).index_add_(0, r, dz)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check(wh, heads_arrays, ptr, idx, heads=None, ok=None,
           rule=SHAPE_RULE):
    """Shapes, types and devices every GAT and GATv2 kernel assumes (H from
    ``heads`` or the first per-head array), (H, C) by the launch's rule
    ``ok`` (``shape_ok`` by default); returns ``(n, H, C)``."""
    dev = wh.device
    n, hc = wh.shape
    if heads is None:
        heads = heads_arrays[0][1].shape[1]
    ok = ok or shape_ok
    if heads < 1 or hc % heads or not ok(heads, hc // heads):
        raise ValueError(f"the attention kernels take {rule}; got "
                         f"H={heads}, H*C={hc}")
    _build.check_tensor("wh", wh, torch.float32, dev)
    for name, t in heads_arrays:
        _build.check_tensor(name, t, torch.float32, dev, (n, heads))
    _build.check_tensor("ptr", ptr, torch.int32, dev, (n + 1,))
    _build.check_tensor("idx", idx, torch.int32, dev)
    return n, heads, hc // heads


def _needs_cuda(name, t):
    if t.device.type != "cuda":
        raise RuntimeError(f"{name} kernel needs a CUDA tensor, got one on "
                           f"{t.device}")


def _library(name: str):
    """The library of kernel ``name``: its prefix names the source."""
    return _build.library(
        "gatv2_attention_wide" if name.startswith("gatv2w")
        else "gatv2_attention" if name.startswith("gatv2")
        else "gat_attention")


def _call(name, args, types):
    lib = _library(name)
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = types + [ctypes.c_void_p]
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args], stream)
    _build.check_launch(err, name, lib)
    launches[name] += 1


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _launch_fwd(wh, a_src, a_dst, rowptr, senders):
    _needs_cuda("gat_fwd", wh)
    n, heads, c = _check(wh, [("a_src", a_src), ("a_dst", a_dst)], rowptr,
                         senders)
    o = torch.empty_like(wh)
    d = torch.empty_like(a_src)
    m = torch.empty_like(a_src)
    _call("gat_fwd", [wh, a_src, a_dst, rowptr, senders, n, heads, c, SLOPE,
                      o, d, m],
          [_P] * 5 + [_I] * 3 + [_F] + [_P] * 3)
    return o, d, m


def _launch_bwd(name, wh, a_src, a_dst, m, g_o, g_d, ptr, idx):
    _needs_cuda(name, wh)
    n, heads, c = _check(wh, [("a_src", a_src), ("a_dst", a_dst), ("m", m),
                              ("g_d", g_d)], ptr, idx)
    _build.check_tensor("g_o", g_o, torch.float32, wh.device, wh.shape)
    d_head = torch.empty_like(a_src)
    outs = [d_head] if name == "gat_bwd_f" else [torch.empty_like(wh), d_head]
    _call(name, [wh, a_src, a_dst, m, g_o, g_d, ptr, idx, n, heads, c, SLOPE,
                 *outs],
          [_P] * 8 + [_I] * 3 + [_F] + [_P] * len(outs))
    return outs[0] if name == "gat_bwd_f" else tuple(outs)


# ---------------------------------------------------------------------------
# device dispatch
# ---------------------------------------------------------------------------

def gat_fwd(wh, a_src, a_dst, rowptr, senders):
    """``(o [N, H*C], d [N, H], m [N, H])`` per receiver row of the CSR."""
    if wh.device.type == "cpu":
        return gat_fwd_plain(wh, a_src, a_dst, rowptr, senders)
    return _launch_fwd(wh, a_src, a_dst, rowptr, senders)


def gat_bwd_t(wh, a_src, a_dst, m, g_o, g_d, colptr, receivers):
    """``(d_wh [N, H*C], d_asrc [N, H])`` per sender row of the CSC."""
    if wh.device.type == "cpu":
        return gat_bwd_t_plain(wh, a_src, a_dst, m, g_o, g_d, colptr,
                               receivers)
    return _launch_bwd("gat_bwd_t", wh, a_src, a_dst, m, g_o, g_d, colptr,
                       receivers)


def gat_bwd_f(wh, a_src, a_dst, m, g_o, g_d, rowptr, senders):
    """``d_adst [N, H]`` per receiver row of the CSR."""
    if wh.device.type == "cpu":
        return gat_bwd_f_plain(wh, a_src, a_dst, m, g_o, g_d, rowptr,
                               senders)
    return _launch_bwd("gat_bwd_f", wh, a_src, a_dst, m, g_o, g_d, rowptr,
                       senders)


class _GATAttention(torch.autograd.Function):
    """Kernel 5 forward; kernels 6 and 7 backward, each over the row's
    sweeps. m is marked non-differentiable, so its cotangent is
    dropped."""

    @staticmethod
    def forward(ctx, wh, a_src, a_dst, plan):
        n, heads, c = wh.shape
        wh2 = wh.reshape(n, heads * c).contiguous()
        a_src, a_dst = a_src.contiguous(), a_dst.contiguous()
        o, d, m = run_sweeps("gat_fwd", (wh2, a_src, a_dst, plan.rowptr,
                                         plan.fwd_senders), heads, c)
        ctx.plan = plan
        ctx.save_for_backward(wh2, a_src, a_dst, m)
        ctx.mark_non_differentiable(m)
        return o.view(n, heads, c), d, m

    @staticmethod
    def backward(ctx, g_o, g_d, _g_m):
        wh2, a_src, a_dst, m = ctx.saved_tensors
        plan = ctx.plan
        g_o = g_o.reshape(wh2.shape).contiguous()
        g_d = g_d.contiguous()
        heads = a_src.shape[1]
        c = wh2.shape[1] // heads
        d_wh, d_asrc = run_sweeps("gat_bwd_t", (
            wh2, a_src, a_dst, m, g_o, g_d, plan.colptr, plan.bwd_receivers),
            heads, c)
        d_adst = run_sweeps("gat_bwd_f", (wh2, a_src, a_dst, m, g_o, g_d,
                                          plan.rowptr, plan.fwd_senders),
                            heads, c)
        return d_wh.view(wh2.shape[0], heads, c), d_asrc, d_adst, None


def gat_attention(wh: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                  plan) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable GAT edge softmax over a ``KernelPlan``:
    ``wh [N, H, C], a_src [N, H], a_dst [N, H] -> (o [N, H, C], d [N, H],
    m [N, H])`` with o and d unnormalised at the stationary max m (m
    carries no gradient)."""
    if wh.shape[0] != plan.num_nodes:
        raise ValueError(f"wh has {wh.shape[0]} rows, the plan "
                         f"{plan.num_nodes}")
    return _GATAttention.apply(wh, a_src, a_dst, plan)


# ---------------------------------------------------------------------------
# GATv2: plain versions
# ---------------------------------------------------------------------------

def _v2_logits(hl, hr, att, s, r):
    """Per edge (s -> r): ``z [E, H, C]``, ``leaky(z)`` and the logits
    ``e [E, H]``."""
    n = hl.shape[0]
    heads, c = att.shape
    z = hl.view(n, heads, c)[s] + hr.view(n, heads, c)[r]
    lz = _leaky(z)
    return z, lz, (lz * att).sum(-1)


def gatv2_fwd_plain(hl, hr, att, rowptr, senders
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``gatv2_fwd`` (any device): ``(o [N, H*C],
    d [N, H], m [N, H])`` over the CSR ``(rowptr, senders)``."""
    n, hc = hl.shape
    heads, c = att.shape
    rows = _row_ids(rowptr)
    s = senders.long()
    _, _, e = _v2_logits(hl, hr, att, s, rows)
    m = hl.new_full((n, heads), EMPTY_MAX).scatter_reduce_(
        0, rows[:, None].expand(-1, heads), e, "amax")
    p = torch.exp(e - m[rows])
    o = hl.new_zeros(n, heads, c).index_add_(
        0, rows, p[:, :, None] * hl.view(n, heads, c)[s])
    d = hl.new_zeros(n, heads).index_add_(0, rows, p)
    return o.view(n, hc), d, m


def _v2_edge_grads(hl, hr, att, m, g_o, g_d, s, r):
    """Per edge (s -> r): alpha-hat ``a [E, H]``, the gathered ``g_o[r]``
    rows, ``de [E, H]``, ``dz [E, H, C]`` and ``leaky(z)``."""
    n = hl.shape[0]
    heads, c = att.shape
    z, lz, e = _v2_logits(hl, hr, att, s, r)
    a = torch.exp(e - m[r])
    g_r = g_o.view(n, heads, c)[r]
    q = (g_r * hl.view(n, heads, c)[s]).sum(-1)
    de = a * (q + g_d[r])
    dz = de[:, :, None] * att * torch.where(z >= 0, 1.0, SLOPE)
    return a, g_r, de, dz, lz


def gatv2_bwd_t_plain(hl, hr, att, m, g_o, g_d, colptr, receivers
                      ) -> torch.Tensor:
    """Plain PyTorch version of ``gatv2_bwd_t`` (any device): ``d_hl
    [N, H*C]`` over the transposed CSC ``(colptr, receivers)``."""
    n, hc = hl.shape
    s, r = _row_ids(colptr), receivers.long()
    a, g_r, _, dz, _ = _v2_edge_grads(hl, hr, att, m, g_o, g_d, s, r)
    return hl.new_zeros((n,) + g_r.shape[1:]).index_add_(
        0, s, a[:, :, None] * g_r + dz).view(n, hc)


def gatv2_bwd_f_plain(hl, hr, att, m, g_o, g_d, rowptr, senders
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``gatv2_bwd_f`` (any device): ``(d_hr
    [N, H*C], d_att [H, C])`` over the CSR ``(rowptr, senders)``."""
    n, hc = hl.shape
    r, s = _row_ids(rowptr), senders.long()
    _, _, de, dz, lz = _v2_edge_grads(hl, hr, att, m, g_o, g_d, s, r)
    d_hr = hl.new_zeros((n,) + dz.shape[1:]).index_add_(0, r, dz)
    return d_hr.view(n, hc), (de[:, :, None] * lz).sum(0)


# ---------------------------------------------------------------------------
# GATv2: kernel launches
# ---------------------------------------------------------------------------

def _check_v2(hl, hr, att, heads_arrays, ptr, idx, ok=None,
              rule=SHAPE_RULE):
    """The GAT checks plus hr like hl and att ``[H, C]``; ``(n, H, C)``."""
    heads = att.shape[0] if att.dim() == 2 else 0
    n, heads, c = _check(hl, heads_arrays, ptr, idx, heads=heads, ok=ok,
                         rule=rule)
    _build.check_tensor("hr", hr, torch.float32, hl.device, hl.shape)
    _build.check_tensor("att", att, torch.float32, hl.device, (heads, c))
    return n, heads, c


def edge_geometry(heads: int, channels: int) -> Tuple[int, int, int]:
    """``(P, LH, K)`` of the edge-group kernels (``edge_groups`` in
    ``csrc/edge_groups.cuh``): P lanes own one edge of a row (32 / P edges
    per warp step), heads padded to a power of two get LH lanes each (an
    aligned power-of-two run), and each lane holds K consecutive channels of
    its head. LH is the least that keeps K <= ``MAX_CHANS``; K is even
    when C is, so float2 loads never split a lane's run."""
    hp = 1 << (heads - 1).bit_length()
    lh = 1
    while -(-channels // lh) > MAX_CHANS:
        lh *= 2
    k = -(-channels // lh)
    if channels % 2 == 0 and k % 2:
        k += 1
    return hp * lh, lh, k


def shape_ok(heads: int, channels: int) -> bool:
    """The one shape rule of the six attention kernels (``shape_ok`` in
    ``csrc/edge_groups.cuh``): 1 <= H <= ``MAX_HEADS`` and an edge group of
    at most 32 lanes."""
    return (1 <= heads <= MAX_HEADS and channels >= 1
            and edge_geometry(heads, channels)[0] <= 32)


def wide_shape_ok(heads: int, channels: int) -> bool:
    """The shape rule of ``gatv2w_fwd``, ``gatv2w_bwd_t`` and
    ``gatv2w_bwd_f`` (``wide_shape_ok`` in
    ``csrc/gatv2_attention_wide.cu``): 1 <= H <= ``MAX_HEADS`` and
    1 <= C <= ``WIDE_MAX_CHANNELS``. A block of each owns one (row,
    head), its threads ``WIDE_CHANS`` channels each, so C bounds a block's
    warps (``wide_geometry``)."""
    return 1 <= heads <= MAX_HEADS and 1 <= channels <= WIDE_MAX_CHANNELS


def wide_geometry(heads: int, channels: int) -> Tuple[int, int]:
    """``(warps, vector)`` of a ``gatv2w_fwd``, ``gatv2w_bwd_t`` and
    ``gatv2w_bwd_f`` block (``gatv2w_geometry`` in
    ``csrc/gatv2_attention_wide.cu``) for a shape ``wide_shape_ok`` takes,
    on 8-byte aligned tensors (every PyTorch allocation): the block owns
    one (row, head), each thread ``WIDE_CHANS`` of its channels, so
    ceil(C / (32 * ``WIDE_CHANS``)) warps; the threads load 2-float
    vectors where C is even, else single floats (the launch also takes
    floats where a pointer is not 8-byte aligned)."""
    if not wide_shape_ok(heads, channels):
        raise ValueError(f"the wide GATv2 kernels take {WIDE_RULE}; got "
                         f"H={heads}, C={channels}")
    return -(-channels // (32 * WIDE_CHANS)), 1 if channels % 2 else 2


def kernel_wide_geometry(heads: int, channels: int) -> Tuple[int, int]:
    """``wide_geometry`` as the compiled wide kernels report it."""
    fn = _build.library("gatv2_attention_wide").gatv2w_geometry
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 2)()
    if fn(heads, channels, out) != 0:
        raise ValueError(f"gatv2w_geometry refuses H={heads}, "
                         f"C={channels}")
    return tuple(out)


def kernel_wide_shape_ok(heads: int, channels: int) -> bool:
    """``wide_shape_ok`` as the compiled wide kernels report it."""
    fn = _build.library("gatv2_attention_wide").gatv2w_shape_ok
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_int]
    return bool(fn(heads, channels))


def accepted_shapes() -> List[Tuple[int, int]]:
    """Every (H, C) that ``shape_ok`` takes, by H then C (1,792 shapes; an
    accepted shape has H*C <= ``MAX_WIDTH``)."""
    return [(h, c) for h in range(1, MAX_HEADS + 1)
            for c in range(1, MAX_WIDTH // h + 1) if shape_ok(h, c)]


def gat_edge_geometry(heads: int, channels: int) -> Tuple[int, int, int]:
    """``(P, LH, K)`` of the three GAT kernels: the GATv2 kernels' rule,
    since they share its header and cap (``edge_geometry``)."""
    return edge_geometry(heads, channels)


def _kernel_geometry(source: str, entry: str, heads: int, channels: int
                     ) -> Tuple[int, int, int]:
    fn = getattr(_build.library(source), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 3)()
    if fn(heads, channels, out) != 0:
        raise ValueError(f"{entry} refuses H={heads}, C={channels}")
    return tuple(out)


def kernel_edge_geometry(heads: int, channels: int) -> Tuple[int, int, int]:
    """``(P, LH, K)`` as the compiled GATv2 kernels report it, to hold
    against ``edge_geometry``."""
    return _kernel_geometry("gatv2_attention", "gatv2_edge_geometry", heads,
                            channels)


def kernel_gat_edge_geometry(heads: int, channels: int
                             ) -> Tuple[int, int, int]:
    """``(P, LH, K)`` as the compiled GAT kernels report it, to hold
    against ``gat_edge_geometry``."""
    return _kernel_geometry("gat_attention", "gat_edge_geometry", heads,
                            channels)


def _v2_rule(name: str):
    """``(ok, rule)`` of a GATv2 launch: the wide kernels' or the narrow."""
    if name.startswith("gatv2w"):
        return wide_shape_ok, WIDE_RULE
    return shape_ok, SHAPE_RULE


def _launch_v2_fwd(hl, hr, att, rowptr, senders, name="gatv2_fwd"):
    _needs_cuda(name, hl)
    ok, rule = _v2_rule(name)
    n, heads, c = _check_v2(hl, hr, att, [], rowptr, senders, ok, rule)
    o = torch.empty_like(hl)
    d = hl.new_empty(n, heads)
    m = hl.new_empty(n, heads)
    _call(name, [hl, hr, att, rowptr, senders, n, heads, c, SLOPE, o, d, m],
          [_P] * 5 + [_I] * 3 + [_F] + [_P] * 3)
    return o, d, m


def _att_rows(name, n, heads, c, dev) -> int:
    """Rows of d_att partial sums of a ``gatv2_bwd_f`` launch (by n) or
    a ``gatv2w_bwd_f`` launch (by n, H, C and the device ``dev``)."""
    lib = _library(name)
    if name == "gatv2w_bwd_f":
        fn, args = lib.gatv2w_att_rows, (n, heads, c)
    else:
        fn, args = lib.gatv2_att_blocks, (n,)
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int] * len(args)
    with torch.cuda.device(dev):
        rows = fn(*args)
    if n > 0 and rows < 1:
        raise RuntimeError(f"{name}: the device gave no block count")
    return rows


def _launch_v2_bwd(name, hl, hr, att, m, g_o, g_d, ptr, idx):
    _needs_cuda(name, hl)
    ok, rule = _v2_rule(name)
    n, heads, c = _check_v2(hl, hr, att, [("m", m), ("g_d", g_d)], ptr, idx,
                            ok, rule)
    _build.check_tensor("g_o", g_o, torch.float32, hl.device, hl.shape)
    outs = [torch.empty_like(hl)]
    if name.endswith("_bwd_f"):
        # one row of d_att partial sums per block, summed below
        outs.append(hl.new_empty(_att_rows(name, n, heads, c, hl.device),
                                heads * c))
    _call(name, [hl, hr, att, m, g_o, g_d, ptr, idx, n, heads, c, SLOPE,
                 *outs],
          [_P] * 8 + [_I] * 3 + [_F] + [_P] * len(outs))
    if name.endswith("_bwd_t"):
        return outs[0]
    return outs[0], outs[1].sum(0).view(heads, c)


# ---------------------------------------------------------------------------
# GATv2: device dispatch
# ---------------------------------------------------------------------------

def gatv2_fwd(hl, hr, att, rowptr, senders):
    """``(o [N, H*C], d [N, H], m [N, H])`` per receiver row of the CSR."""
    if hl.device.type == "cpu":
        return gatv2_fwd_plain(hl, hr, att, rowptr, senders)
    return _launch_v2_fwd(hl, hr, att, rowptr, senders)


def gatv2_bwd_t(hl, hr, att, m, g_o, g_d, colptr, receivers):
    """``d_hl [N, H*C]`` per sender row of the CSC."""
    if hl.device.type == "cpu":
        return gatv2_bwd_t_plain(hl, hr, att, m, g_o, g_d, colptr,
                                 receivers)
    return _launch_v2_bwd("gatv2_bwd_t", hl, hr, att, m, g_o, g_d, colptr,
                          receivers)


def gatv2_bwd_f(hl, hr, att, m, g_o, g_d, rowptr, senders):
    """``(d_hr [N, H*C], d_att [H, C])`` per receiver row of the CSR."""
    if hl.device.type == "cpu":
        return gatv2_bwd_f_plain(hl, hr, att, m, g_o, g_d, rowptr, senders)
    return _launch_v2_bwd("gatv2_bwd_f", hl, hr, att, m, g_o, g_d, rowptr,
                          senders)


def gatv2w_fwd(hl, hr, att, rowptr, senders):
    """``gatv2_fwd`` for a head wider than 512 floats (``wide_shape_ok``)."""
    if hl.device.type == "cpu":
        return gatv2w_fwd_plain(hl, hr, att, rowptr, senders)
    return _launch_v2_fwd(hl, hr, att, rowptr, senders, name="gatv2w_fwd")


def gatv2w_bwd_t(hl, hr, att, m, g_o, g_d, colptr, receivers):
    """``gatv2_bwd_t`` for a head wider than 512 floats."""
    if hl.device.type == "cpu":
        return gatv2w_bwd_t_plain(hl, hr, att, m, g_o, g_d, colptr,
                                  receivers)
    return _launch_v2_bwd("gatv2w_bwd_t", hl, hr, att, m, g_o, g_d, colptr,
                          receivers)


def gatv2w_bwd_f(hl, hr, att, m, g_o, g_d, rowptr, senders):
    """``gatv2_bwd_f`` for a head wider than 512 floats."""
    if hl.device.type == "cpu":
        return gatv2w_bwd_f_plain(hl, hr, att, m, g_o, g_d, rowptr,
                                  senders)
    return _launch_v2_bwd("gatv2w_bwd_f", hl, hr, att, m, g_o, g_d, rowptr,
                          senders)


# the wide kernels compute the narrow ones' functions, whose plain versions
# take any width
gatv2w_fwd_plain = gatv2_fwd_plain
gatv2w_bwd_t_plain = gatv2_bwd_t_plain
gatv2w_bwd_f_plain = gatv2_bwd_f_plain


# ---------------------------------------------------------------------------
# rows wider than one launch: sweeps
# ---------------------------------------------------------------------------

class Sweep(NamedTuple):
    """One launch of a row's sweep: ``heads`` heads from ``head`` on, with
    channels ``chan`` .. ``chan + channels - 1`` of each; ``wide``: a
    ``gatv2w_*`` launch."""
    head: int
    heads: int
    chan: int
    channels: int
    wide: bool = False


def _channel_ranges(channels: int) -> List[Tuple[int, int]]:
    """``(first, count)`` of a GAT head's channel ranges past 512 floats:
    the fewest ranges, each taken by ``shape_ok(1, .)``, whose widths
    (equal where their number divides C, else one apart) share one edge
    geometry P, so every launch sums m and d in the same order."""
    parts = -(-channels // MAX_WIDTH)
    while True:
        bounds = [k * channels // parts for k in range(parts + 1)]
        widths = {b - a for a, b in zip(bounds, bounds[1:])}
        if len({edge_geometry(1, w)[0] for w in widths}) == 1:
            return [(a, b - a) for a, b in zip(bounds, bounds[1:])]
        parts += 1


def sweeps(heads: int, channels: int, v2: bool = False) -> List[Sweep]:
    """The launches that cover a row of (H, C) (``v2``: GATv2's). A shape
    ``shape_ok`` takes is one launch. Else, for C <= 512, groups of whole
    heads, each as many as ``shape_ok`` takes; for C > 512 each GAT head in
    ``_channel_ranges``, and a GATv2 row in one ``gatv2w_*`` launch
    (``wide_shape_ok``). Raises with the rule past 1 <= H <= 32 or, for
    GATv2, past ``WIDE_MAX_CHANNELS``."""
    if not (1 <= heads <= MAX_HEADS and channels >= 1):
        raise ValueError(f"the attention kernels take 1 <= H <= "
                         f"{MAX_HEADS} heads of C >= 1 channels; got "
                         f"H={heads}, C={channels}")
    if shape_ok(heads, channels):
        return [Sweep(0, heads, 0, channels)]
    if channels <= MAX_WIDTH:
        group = max(k for k in range(1, heads + 1) if shape_ok(k, channels))
        return [Sweep(h, min(group, heads - h), 0, channels)
                for h in range(0, heads, group)]
    if v2:
        if not wide_shape_ok(heads, channels):
            raise ValueError(f"the wide GATv2 kernels take {WIDE_RULE}; "
                             f"got H={heads}, C={channels}")
        return [Sweep(0, heads, 0, channels, wide=True)]
    return [Sweep(h, 1, c0, nc) for h in range(heads)
            for c0, nc in _channel_ranges(channels)]


# Each kernel's arguments and outputs by role: R a row [N, H*C] (its
# sweep's columns), S per-head scalars [N, H] (its heads), A att [H, C],
# G g_d (its heads in a head's first channel range, zeros in the others),
# P the graph, passed as it is. Outputs: R placed in the sweep's columns,
# S1 per-head scalars from the first channel range (m and d are bitwise
# equal in every range), S+ per-head scalars summed over the ranges, A
# att's rows of the sweep's heads.
_ROLES = {
    "gat_fwd": ("RSSPP", ("R", "S1", "S1")),
    "gat_bwd_t": ("RSSSRGPP", ("R", "S+")),
    "gat_bwd_f": ("RSSSRGPP", ("S+",)),
    "gatv2_fwd": ("RRAPP", ("R", "S1", "S1")),
    "gatv2_bwd_t": ("RRASRGPP", ("R",)),
    "gatv2_bwd_f": ("RRASRGPP", ("R", "A")),
}


def _piece(role: str, t: torch.Tensor, sw: Sweep, heads: int,
           channels: int) -> torch.Tensor:
    """The sweep's part of argument ``t`` of role ``role`` (a contiguous
    copy where it is not the whole)."""
    hs = slice(sw.head, sw.head + sw.heads)
    cs = slice(sw.chan, sw.chan + sw.channels)
    if role == "P":
        return t
    if role == "R":
        return t.view(t.shape[0], heads, channels)[:, hs, cs].reshape(
            t.shape[0], -1).contiguous()
    if role == "A":
        return t[hs, cs].contiguous()
    if role == "G" and sw.chan > 0:
        return t.new_zeros(t.shape[0], sw.heads)
    return t[:, hs].contiguous()


def run_sweeps(name: str, args: tuple, heads: int, channels: int,
               kernels: Optional[Mapping[str, Callable]] = None):
    """Kernel ``name`` (a narrow GAT or GATv2 kernel's) over rows of any
    (H, C) that ``sweeps`` covers: each sweep's launch through
    ``kernels[name]``, or ``kernels["gatv2w_*"]`` for a wide one (by
    default this module's dispatch functions; the tests pass the plain
    versions), composed into the outputs of one launch over the row."""
    kernels = kernels or KERNELS
    plan = sweeps(heads, channels, v2=name.startswith("gatv2"))
    if len(plan) == 1:
        return kernels[name.replace("gatv2", "gatv2w") if plan[0].wide
                       else name](*args)
    arg_roles, out_roles = _ROLES[name]
    n = args[0].shape[0]
    outs = None
    for sw in plan:
        got = kernels[name](*[_piece(role, a, sw, heads, channels)
                              for role, a in zip(arg_roles, args)])
        got = got if isinstance(got, tuple) else (got,)
        if outs is None:
            ref = args[0]
            outs = [ref.new_empty(n, heads, channels) if role == "R"
                    else ref.new_empty(heads, channels) if role == "A"
                    else ref.new_zeros(n, heads) for role in out_roles]
        hs = slice(sw.head, sw.head + sw.heads)
        cs = slice(sw.chan, sw.chan + sw.channels)
        for role, out, part in zip(out_roles, outs, got):
            if role == "R":
                out[:, hs, cs] = part.view(n, sw.heads, sw.channels)
            elif role == "A":
                out[hs, cs] = part.view(sw.heads, sw.channels)
            elif role == "S+":
                out[:, hs] += part
            elif sw.chan == 0:
                out[:, hs] = part
    outs = [o.view(n, heads * channels) if role == "R" else o
            for role, o in zip(out_roles, outs)]
    return tuple(outs) if len(outs) > 1 else outs[0]


class _GATv2Attention(torch.autograd.Function):
    """``gatv2_fwd`` forward; ``gatv2_bwd_t`` and ``gatv2_bwd_f`` backward,
    each over the row's sweeps (the ``gatv2w_*`` kernels past 512 floats a
    head). m is marked non-differentiable, so its cotangent is dropped."""

    @staticmethod
    def forward(ctx, hl, hr, att, plan):
        n, heads, c = hl.shape
        hl2 = hl.reshape(n, heads * c).contiguous()
        hr2 = hr.reshape(n, heads * c).contiguous()
        att = att.contiguous()
        o, d, m = run_sweeps("gatv2_fwd", (hl2, hr2, att, plan.rowptr,
                                           plan.fwd_senders), heads, c)
        ctx.plan = plan
        ctx.save_for_backward(hl2, hr2, att, m)
        ctx.mark_non_differentiable(m)
        return o.view(n, heads, c), d, m

    @staticmethod
    def backward(ctx, g_o, g_d, _g_m):
        hl2, hr2, att, m = ctx.saved_tensors
        plan = ctx.plan
        g_o = g_o.reshape(hl2.shape).contiguous()
        g_d = g_d.contiguous()
        heads, c = att.shape
        d_hl = run_sweeps("gatv2_bwd_t", (hl2, hr2, att, m, g_o, g_d,
                                          plan.colptr, plan.bwd_receivers),
                          heads, c)
        d_hr, d_att = run_sweeps("gatv2_bwd_f", (
            hl2, hr2, att, m, g_o, g_d, plan.rowptr, plan.fwd_senders),
            heads, c)
        shape = (hl2.shape[0],) + tuple(att.shape)
        return d_hl.view(shape), d_hr.view(shape), d_att, None


def gatv2_attention(hl: torch.Tensor, hr: torch.Tensor, att: torch.Tensor,
                    plan) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable GATv2 edge softmax over a ``KernelPlan``:
    ``hl [N, H, C], hr [N, H, C], att [H, C] -> (o [N, H, C], d [N, H],
    m [N, H])`` with o and d unnormalised at the per-receiver max m of the
    edge logits (m carries no gradient); gradients reach hl, hr and att."""
    if hl.shape[0] != plan.num_nodes:
        raise ValueError(f"hl has {hl.shape[0]} rows, the plan "
                         f"{plan.num_nodes}")
    if hr.shape != hl.shape or tuple(att.shape) != tuple(hl.shape[1:]):
        raise ValueError(f"hl {tuple(hl.shape)}, hr {tuple(hr.shape)} and "
                         f"att {tuple(att.shape)} do not match")
    return _GATv2Attention.apply(hl, hr, att, plan)


# the launch of each kernel name on a tensor's device (``run_sweeps``)
KERNELS: Dict[str, Callable] = {name: globals()[name] for name in launches}
