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
"""

from __future__ import annotations

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

WEIGHTINGS = ("none", "softmax", "sigmoid", "hardtanh")


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

    def bases_and_comb(self, x: torch.Tensor):
        """``x Theta`` [N, B*L] and the head-mix weights [N, H*B*A], their
        columns in (h, b, a) order."""
        return (x @ torch.cat(list(self.bases_weight), dim=1),
                self.comb_weights(x))

    def bases_and_weights(self, x: torch.Tensor):
        """``bases_and_comb`` with the weighting applied to the head-mix
        weights, ``[N, H*B*A]``."""
        H, B, A = self.H, self.B, self.A
        n = x.shape[0]
        bases, w = self.bases_and_comb(x)
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
        bases, w2d = self.bases_and_weights(x)

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

    def bases_and_comb(self, x: torch.Tensor):
        return (x @ self.bases_weight,
                F.linear(x, self.comb_weight.weight[self.perm],
                         self.comb_weight.bias[self.perm]))
