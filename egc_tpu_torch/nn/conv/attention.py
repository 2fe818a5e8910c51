"""GAT and GATv2 attention convolutions (counterpart of ``GATConv`` and
``GATv2Conv`` in ``egc_tpu.nn.conv.attention``).

PyG semantics: per head, a logit per in-edge j -> i plus a virtual
self-loop (PyG ``add_self_loops=True``), softmax at the receiver, heads
concatenated, then a bias. The self term enters the softmax analytically;
no self-loop edge is materialised. Logits (slope 0.2):

- GAT: e_ij = leaky_relu(a_src . Wx_j + a_dst . Wx_i), values Wx_j;
- GATv2: e_ij = att . leaky_relu(W_l x_j + W_r x_i), values W_l x_j.

Dispatch follows the device and, on the card, the JAX convs' route
(``_attention_route``):

- a CPU tensor takes the plain segment path (``softmax_sum``, shared by
  both convs);
- a CUDA tensor with at most 32 heads takes ``gat_attention`` or
  ``gatv2_attention`` and the exact node-level merge of the self term
  (``merge_self``), and needs a kernel plan there (it raises without one);
- a CUDA tensor with more heads takes the segment path on the card, the
  counterpart of the JAX convs' XLA route.

Attention dropout is not ported: no configuration of the JAX package sets
``gat_dropout`` (``egc_tpu/models/nets.py:51``), which keeps its default of
0.0 on the full-graph and the batched paths alike. Parameters carry the
reference's names: GAT ``lin_src`` (Linear without bias, H*C outputs),
``att_src`` and ``att_dst`` of shape [1, H, C], and ``bias``; GATv2
``lin_l`` and ``lin_r`` (Linear with bias, H*C outputs; one module when
``share_weights``), ``att`` [1, H, C] and ``bias``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from egc_tpu_torch.nn import init as einit
from egc_tpu_torch.ops.cuda.attention import (
    EMPTY_MAX, MAX_HEADS, _leaky, gat_attention, gatv2_attention,
)
from egc_tpu_torch.ops.segment import (
    _segment_max_raw, segment_count, segment_sum,
)


def _attention_route(heads: int) -> str:
    """``"kernel"`` or ``"segment"``: the JAX convs' rule for a call on the
    accelerator at attention dropout 0
    (``egc_tpu/nn/conv/attention.py:196-199``, ``:312-316``): the kernels for at most ``MAX_HEADS`` heads, the segment
    path otherwise. Chosen by these semantics, never by a failure. JAX's
    GATv2 route also needs ``_attn_cp(H, C) > C``: its Pallas kernel
    carries the softmax denominator in a spare channel. The port's kernels
    compute d without one, so that condition has no counterpart here."""
    return "kernel" if heads <= MAX_HEADS else "segment"


def softmax_sum(h: torch.Tensor, edge_logits: torch.Tensor,
                self_logits: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain path: ``[N, H, C]`` sums of ``h[sender]`` over in-edges and of
    ``h`` itself over the self-loop, weighted by the per-head softmax of
    ``edge_logits [E, H]`` and ``self_logits [N, H]`` at each receiver
    (``_attention_alphas`` + ``_aggregate`` of the JAX package, at
    attention dropout 0)."""
    n = h.shape[0]
    s, r = senders.long(), receivers.long()
    neg = torch.tensor(EMPTY_MAX, dtype=h.dtype, device=h.device)
    if edge_mask is not None:
        edge_logits = torch.where(edge_mask[:, None], edge_logits, neg)
    mx = _segment_max_raw(edge_logits, r, n)
    has = segment_count(r, n, mask=edge_mask) > 0
    mx = torch.maximum(torch.where(has[:, None], mx, neg), self_logits)
    ex = torch.exp(edge_logits - mx[r])
    if edge_mask is not None:
        ex = torch.where(edge_mask[:, None], ex, torch.zeros_like(ex))
    ex_self = torch.exp(self_logits - mx)
    denom = torch.clamp(segment_sum(ex, r, n) + ex_self, min=1e-16)
    alpha_edge = ex / denom[r]
    alpha_self = ex_self / denom
    return (segment_sum(alpha_edge[:, :, None] * h[s], r, n)
            + alpha_self[:, :, None] * h)


def merge_self(o: torch.Tensor, d: torch.Tensor, m: torch.Tensor,
               self_logits: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Kernel path: the edge softmax ``(o, d, m)`` of an attention kernel
    merged with the self term ``(self_logits, h)`` at the receiver
    (``_fused_gat_softmax_sum`` and ``_fused_gatv2_softmax_sum`` of the JAX
    package). The merge is invariant to m and m_full, so both are
    constants to autograd."""
    m_full = torch.maximum(m, self_logits).detach()
    corr = torch.exp(m - m_full)
    p_self = torch.exp(self_logits - m_full)
    denom = torch.clamp(d * corr + p_self, min=1e-16)
    return (o * corr[:, :, None] + p_self[:, :, None] * h) / denom[:, :, None]


def segment_softmax_sum(h: torch.Tensor, a_src: torch.Tensor,
                        a_dst: torch.Tensor, senders: torch.Tensor,
                        receivers: torch.Tensor,
                        edge_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """GAT's segment path: ``[N, H, C]``."""
    s, r = senders.long(), receivers.long()
    return softmax_sum(h, _leaky(a_src[s] + a_dst[r]), _leaky(a_src + a_dst),
                       senders, receivers, edge_mask)


def fused_softmax_sum(h: torch.Tensor, a_src: torch.Tensor,
                      a_dst: torch.Tensor, plan) -> torch.Tensor:
    """GAT's kernel path: ``gat_attention`` and the self-term merge."""
    o, d, m = gat_attention(h, a_src, a_dst, plan)
    return merge_self(o, d, m, _leaky(a_src + a_dst), h)


def _logits_v2(x_src: torch.Tensor, x_dst: torch.Tensor,
               att: torch.Tensor) -> torch.Tensor:
    """GATv2 logits ``[..., H]`` of ``[..., H, C]`` features; att
    ``[H, C]``."""
    return (_leaky(x_src + x_dst) * att).sum(-1)


def segment_softmax_sum_v2(hl: torch.Tensor, hr: torch.Tensor,
                           att: torch.Tensor, senders: torch.Tensor,
                           receivers: torch.Tensor,
                           edge_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """GATv2's segment path: ``[N, H, C]``."""
    s, r = senders.long(), receivers.long()
    return softmax_sum(hl, _logits_v2(hl[s], hr[r], att),
                       _logits_v2(hl, hr, att), senders, receivers, edge_mask)


def fused_softmax_sum_v2(hl: torch.Tensor, hr: torch.Tensor,
                         att: torch.Tensor, plan) -> torch.Tensor:
    """GATv2's kernel path: ``gatv2_attention`` and the self-term merge,
    with hl as the self value."""
    o, d, m = gatv2_attention(hl, hr, att, plan)
    return merge_self(o, d, m, _logits_v2(hl, hr, att), hl)


def _uses_kernel(heads: int, x: torch.Tensor) -> bool:
    """A CUDA call that the JAX route sends to the kernels."""
    return x.device.type != "cpu" and _attention_route(heads) == "kernel"


class GATConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, *,
                 heads: int = 1,
                 generator: Optional[torch.Generator] = None, device=None):
        """``out_channels`` per head; the output has ``heads *
        out_channels`` columns."""
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        self.lin_src = nn.Linear(in_channels, heads * out_channels,
                                 bias=False, device=device)
        self.att_src = nn.Parameter(
            torch.empty(1, heads, out_channels, device=device))
        self.att_dst = nn.Parameter(
            torch.empty(1, heads, out_channels, device=device))
        self.bias = nn.Parameter(
            torch.zeros(heads * out_channels, device=device))
        for p in (self.lin_src.weight, self.att_src, self.att_dst):
            einit.glorot_uniform_(p, generator)

    def project(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(h [N, H, C], a_src [N, H], a_dst [N, H])``."""
        h = self.lin_src(x).view(x.shape[0], self.heads, self.out_channels)
        return h, (h * self.att_src).sum(-1), (h * self.att_dst).sum(-1)

    def forward(self, g, x: torch.Tensor) -> torch.Tensor:
        h, a_src, a_dst = self.project(x)
        if _uses_kernel(self.heads, x):
            out = fused_softmax_sum(h, a_src, a_dst, _plan(g, "GATConv"))
        else:
            out = segment_softmax_sum(h, a_src, a_dst, g.senders,
                                      g.receivers, g.edge_mask)
        return out.reshape(x.shape[0], -1) + self.bias


def _plan(g, conv: str):
    if g.kernel_plan is None:
        raise RuntimeError(
            f"{conv} on a CUDA tensor needs a graph with a kernel plan "
            "(ops.dispatch.build_kernel_plan)")
    return g.kernel_plan


class GATv2Conv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, *,
                 heads: int = 1, share_weights: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        """``out_channels`` per head; the output has ``heads *
        out_channels`` columns. ``share_weights``: ``lin_r`` is ``lin_l``.
        """
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        self.lin_l = nn.Linear(in_channels, heads * out_channels,
                               device=device)
        self.lin_r = self.lin_l if share_weights else nn.Linear(
            in_channels, heads * out_channels, device=device)
        self.att = nn.Parameter(
            torch.empty(1, heads, out_channels, device=device))
        self.bias = nn.Parameter(
            torch.zeros(heads * out_channels, device=device))
        lins = (self.lin_l,) if share_weights else (self.lin_l, self.lin_r)
        for lin in lins:
            einit.glorot_uniform_(lin.weight, generator)
            nn.init.zeros_(lin.bias)
        einit.glorot_uniform_(self.att, generator)

    def project(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(hl [N, H, C], hr [N, H, C])``."""
        shape = (x.shape[0], self.heads, self.out_channels)
        hl = self.lin_l(x).view(shape)
        hr = hl if self.lin_r is self.lin_l else self.lin_r(x).view(shape)
        return hl, hr

    def forward(self, g, x: torch.Tensor) -> torch.Tensor:
        hl, hr = self.project(x)
        if _uses_kernel(self.heads, x):
            out = fused_softmax_sum_v2(hl, hr, self.att[0],
                                       _plan(g, "GATv2Conv"))
        else:
            out = segment_softmax_sum_v2(hl, hr, self.att[0], g.senders,
                                         g.receivers, g.edge_mask)
        return out.reshape(x.shape[0], -1) + self.bias
