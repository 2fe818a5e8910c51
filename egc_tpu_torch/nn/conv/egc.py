"""EGC — Efficient Graph Convolution (counterpart of
``egc_tpu.nn.conv.egc``).

    x'_i = ||_{h=1..H} sum_{a in A} sum_{b=1..B}
           w[i,h,b,a] * AGG_a_{j in N(i) (+ i)} (Theta_b x_j)

One ``conv_aggregate`` pass produces every aggregator of the B bases; the
head mix combines them with the per-node weights ``w = comb(x)``, whose
columns are in (h, b, a) order. On a CUDA tensor the aggregation runs the
gather-reduce kernels and the head mix kernels 3/4 with the bias folded in;
on a CPU tensor both run in plain PyTorch.

``self_loop_mode="paper"`` (reference ``EfficientGraphConv``) puts the
self-loop only inside symnorm; ``"all"`` (upstreamed ``EGConv``) gives
every aggregator a virtual self-loop. Parameters carry the reference's
``EfficientGraphConv`` names: ``bases_weight.{b}`` [in, L],
``comb_weights.weight/.bias`` and ``bias``. ``OptimizedEGConv`` carries
the upstreamed ``EGConv``'s (reference ``optimized_layers.py``), the
MagNet layer's: one ``bases_weight`` [in, B*L], ``comb_weight``, whose
rows are aggregator-major, (h, a*B + b), and ``bias``.

``EGC_TPU_BF16_DENSE=1`` (JAX's opt-in, ``egc_tpu/nn/conv/egc.py:125-138``)
makes the bases and comb matmuls take bf16 inputs, accumulating and
returning f32 (``bf16_matmuls``), where the layer runs on a graph with a
kernel plan of at least ``BF16_MIN_ROWS`` rows: JAX's ``use_fused_mix``
conditions less its backend test. The port's kernel path and plain path
compute the same function, so the rule does not look at the device. The
default is f32.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from egc_tpu_torch.graph.transforms import symnorm_weight
from egc_tpu_torch.nn import init as einit
from egc_tpu_torch.ops.cuda.headmix import head_mix_fused
from egc_tpu_torch.ops.dispatch import conv_aggregate
from egc_tpu_torch.ops.segment import canonical_aggr
from egc_tpu_torch.utils.profiling import span

WEIGHTINGS = ("none", "softmax", "sigmoid", "hardtanh")
BF16_MIN_ROWS = 4096     # egc_tpu/ops/pallas/headmix.py:259-261
BF16_FUSED_FAN_IN = 192  # JAX's one product over [bases | comb] from here


def _mm_f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``, accumulated and returned in f32: on the card a cuBLAS
    GEMM of two bf16 matrices (``aten::mm.dtype``, the bf16 tensor
    cores); on the CPU the plain version, an f32 matmul of the values
    (exact products where both are bf16 values)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _BF16MatMuls(torch.autograd.Function):
    """JAX's ``xm = x.astype(bf16)`` and ``matmul(xm, w.astype(bf16),
    preferred_element_type=f32)`` for each ``w``, and their transpose:
    each cotangent is computed in f32 and rounded to bf16 (its operand's
    dtype), the bf16 cotangents of ``xm`` are summed in bf16
    (``add_any``), and each arrives back as f32. The plain version takes
    the f32 output cotangents as JAX does; the card's GEMMs take them
    rounded to bf16, so that every product runs on the bf16 tensor
    cores."""

    @staticmethod
    def forward(ctx, x, *ws):
        xb = x.bfloat16()
        wbs = [w.bfloat16() for w in ws]
        ctx.save_for_backward(xb, *wbs)
        return tuple(_mm_f32_out(xb, wb) for wb in wbs)

    @staticmethod
    def backward(ctx, *gs):
        xb, *wbs = ctx.saved_tensors
        need_x, *need_w = ctx.needs_input_grad
        dx, dws = None, []
        for g, wb, need in zip(gs, wbs, need_w):
            if g.is_cuda:
                g = g.bfloat16()
            if need_x:
                dxi = _mm_f32_out(g, wb.t()).bfloat16()
                dx = dxi if dx is None else dx + dxi
            dws.append(_mm_f32_out(xb.t(), g).bfloat16().float()
                       if need else None)
        return (None if dx is None else dx.float(), *dws)


def bf16_matmuls(x: torch.Tensor, *ws: torch.Tensor) -> tuple:
    """``x [N, K] @ w [K, M]`` for each ``w``, with bf16 inputs, f32
    accumulation and f32 results; the gradients of x and of each w arrive
    rounded to bf16, as JAX's."""
    return _BF16MatMuls.apply(x, *ws)


def bf16_dense(g, n: int) -> bool:
    """Whether a layer over ``n`` rows of ``g`` takes its matmuls in bf16:
    ``EGC_TPU_BF16_DENSE=1``, a kernel plan, and ``n >= BF16_MIN_ROWS``."""
    return (os.environ.get("EGC_TPU_BF16_DENSE") == "1"
            and g.kernel_plan is not None and n >= BF16_MIN_ROWS)


def _bf16_bases_and_comb(x, wb, wc, bc):
    """JAX's bf16 branch: ``x wb`` and ``x wc + bc``, the bias added in
    f32 after the product; one product over ``[wb | wc]`` when the fan-in
    is at least ``BF16_FUSED_FAN_IN``, as JAX takes it."""
    if x.shape[1] >= BF16_FUSED_FAN_IN:
        out, = bf16_matmuls(x, torch.cat([wb, wc], dim=1))
        return out[:, :wb.shape[1]], out[:, wb.shape[1]:] + bc
    bases, w = bf16_matmuls(x, wb, wc)
    return bases, w + bc


class EGConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, *,
                 num_heads: int = 8, num_bases: int = 4,
                 aggrs: Sequence[str] = ("symnorm",),
                 weighting: str = "none", self_loop_mode: str = "paper",
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        if out_channels % num_heads:
            raise ValueError("out_channels must be divisible by num_heads")
        if weighting not in WEIGHTINGS:
            raise ValueError(f"unknown weighting {weighting!r}")
        if self_loop_mode not in ("paper", "all"):
            raise ValueError(f"unknown self_loop_mode {self_loop_mode!r}")
        self.aggrs = tuple(canonical_aggr(a) for a in aggrs)
        self.H, self.B, self.A = num_heads, num_bases, len(self.aggrs)
        self.L = out_channels // num_heads
        self.weighting = weighting
        self.self_loop_mode = self_loop_mode
        self._init_weights(in_channels, out_channels, generator, device)

    def _init_weights(self, in_channels, out_channels, generator, device):
        self.bases_weight = nn.ParameterList([
            nn.Parameter(torch.empty(in_channels, self.L, device=device))
            for _ in range(self.B)])
        self.comb_weights = nn.Linear(in_channels,
                                      self.H * self.B * self.A,
                                      device=device)
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        einit.glorot_per_base_(self.bases_weight, in_channels, generator)
        einit.torch_linear_(self.comb_weights, generator)

    def bases_and_comb(self, x: torch.Tensor, bf16: bool = False):
        """``x Theta`` [N, B*L] and the head-mix weights [N, H*B*A], their
        columns in (h, b, a) order; with ``bf16``, through
        ``bf16_matmuls``."""
        wb = torch.cat(list(self.bases_weight), dim=1)
        if bf16:
            return _bf16_bases_and_comb(x, wb, self.comb_weights.weight.t(),
                                        self.comb_weights.bias)
        return x @ wb, self.comb_weights(x)

    def bases_and_weights(self, x: torch.Tensor, bf16: bool = False):
        """``bases_and_comb`` (the span ``egc.conv.dense``) with the
        weighting applied to the head-mix weights, ``[N, H*B*A]``."""
        H, B, A = self.H, self.B, self.A
        n = x.shape[0]
        with span("egc.conv.dense"):
            bases, w = self.bases_and_comb(x, bf16)
        if self.weighting == "softmax":
            # softmax over all bases x aggregators of a head
            w = torch.softmax(w.reshape(n, H, B * A), dim=-1)
        elif self.weighting == "sigmoid":
            w = torch.sigmoid(w)
        elif self.weighting == "hardtanh":
            w = torch.clamp(w, -1.0, 1.0)
        return bases, w.reshape(n, H * B * A)

    def forward(self, g, x: torch.Tensor) -> torch.Tensor:
        H, B, A, L = self.H, self.B, self.A, self.L
        n = x.shape[0]
        bases, w2d = self.bases_and_weights(x, bf16_dense(g, n))

        sym_ew = sym_sw = None
        if "symnorm" in self.aggrs:
            if g.edge_weight is not None:
                sym_ew, sym_sw = g.edge_weight, g.self_weight
            else:
                sym_ew, sym_sw = symnorm_weight(
                    g.senders, g.receivers, n, edge_mask=g.edge_mask)
        include_self = self.self_loop_mode == "all"
        ys = conv_aggregate(g, bases, self.aggrs, include_self=include_self,
                            symnorm_edge_w=sym_ew, symnorm_self_w=sym_sw,
                            stacked=False)
        return head_mix_fused(w2d, ys, H=H, B=B, A=A, L=L, bias=self.bias)


def comb_perm(H: int, B: int, A: int) -> np.ndarray:
    """``perm`` with ours[j] = optimized[perm[j]] over the head-mix weight
    columns: ours j = (h, b, a), the optimized EGConv's h*B*A + a*B + b
    (``egc_tpu/exp/weight_port.py:69-79``). The identity when A = 1."""
    h, b, a = np.meshgrid(np.arange(H), np.arange(B), np.arange(A),
                          indexing="ij")
    return (h * B * A + a * B + b).reshape(-1)


class OptimizedEGConv(EGConv):
    """EGC with the upstreamed ``EGConv``'s parameters and, by default,
    self-loops for every aggregator (the reference's ogbn-mag layer)."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 self_loop_mode: str = "all", **kwargs):
        super().__init__(in_channels, out_channels,
                         self_loop_mode=self_loop_mode, **kwargs)

    def _init_weights(self, in_channels, out_channels, generator, device):
        H, B, A, L = self.H, self.B, self.A, self.L
        self.bases_weight = nn.Parameter(
            torch.empty(in_channels, B * L, device=device))
        self.comb_weight = nn.Linear(in_channels, H * B * A, device=device)
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        einit.glorot_per_base_(self.bases_weight.data.split(L, dim=1),
                               in_channels, generator)
        einit.torch_linear_(self.comb_weight, generator)
        self.register_buffer("perm", torch.as_tensor(
            comb_perm(H, B, A), device=device), persistent=False)

    def bases_and_comb(self, x: torch.Tensor, bf16: bool = False):
        wc = self.comb_weight.weight[self.perm]
        bc = self.comb_weight.bias[self.perm]
        if bf16:
            return _bf16_bases_and_comb(x, self.bases_weight, wc.t(), bc)
        return x @ self.bases_weight, F.linear(x, wc, bc)
