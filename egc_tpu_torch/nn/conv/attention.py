"""GAT attention convolution (counterpart of ``GATConv`` in
``egc_tpu.nn.conv.attention``).

PyG semantics: per head, logits e_ij = leaky_relu(a_src . Wx_j +
a_dst . Wx_i) (slope 0.2) over the in-edges of i plus a virtual self-loop
(PyG ``add_self_loops=True``), softmax at the receiver, heads concatenated,
then a bias. The self term enters the softmax analytically; no self-loop
edge is materialised.

Dispatch follows the device, as in ``ops.dispatch.conv_aggregate``:

- a CPU tensor takes the plain segment path (``segment_softmax_sum``);
- a CUDA tensor with a kernel plan takes ``gat_attention`` (kernels 5-7)
  and the exact node-level merge of the self term below;
- a CUDA tensor without a plan raises.

Attention dropout is not ported: no configuration of the full-graph path
sets it. Parameters carry the reference's names: ``lin_src`` (Linear
without bias, H*C outputs), ``att_src`` and ``att_dst`` of shape
[1, H, C], and ``bias``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from egc_tpu_torch.nn import init as einit
from egc_tpu_torch.ops.cuda.attention import (
    EMPTY_MAX, _leaky, gat_attention,
)
from egc_tpu_torch.ops.segment import (
    _segment_max_raw, segment_count, segment_sum,
)


def segment_softmax_sum(h: torch.Tensor, a_src: torch.Tensor,
                        a_dst: torch.Tensor, senders: torch.Tensor,
                        receivers: torch.Tensor,
                        edge_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain path: ``[N, H, C]`` softmax-weighted sums over in-edges and
    the self-loop (``_attention_alphas`` + ``_aggregate`` of the JAX
    package, at attention dropout 0)."""
    n = h.shape[0]
    s, r = senders.long(), receivers.long()
    self_logits = _leaky(a_src + a_dst)
    edge_logits = _leaky(a_src[s] + a_dst[r])
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


def fused_softmax_sum(h: torch.Tensor, a_src: torch.Tensor,
                      a_dst: torch.Tensor, plan) -> torch.Tensor:
    """Kernel path: the edge softmax of ``gat_attention`` merged with the
    self term at the receiver (``_fused_gat_softmax_sum`` of the JAX
    package). The merge is invariant to m and m_full, so both are
    constants to autograd."""
    o, d, m = gat_attention(h, a_src, a_dst, plan)
    self_logits = _leaky(a_src + a_dst)
    m_full = torch.maximum(m, self_logits).detach()
    corr = torch.exp(m - m_full)
    p_self = torch.exp(self_logits - m_full)
    denom = torch.clamp(d * corr + p_self, min=1e-16)
    return (o * corr[:, :, None] + p_self[:, :, None] * h) / denom[:, :, None]


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
        if x.device.type == "cpu":
            out = segment_softmax_sum(h, a_src, a_dst, g.senders,
                                      g.receivers, g.edge_mask)
        elif g.kernel_plan is None:
            raise RuntimeError(
                "GATConv on a CUDA tensor needs a graph with a kernel plan "
                "(ops.dispatch.build_kernel_plan)")
        else:
            out = fused_softmax_sum(h, a_src, a_dst, g.kernel_plan)
        return out.reshape(x.shape[0], -1) + self.bias
