"""Towered MPNN (counterpart of ``egc_tpu.nn.conv.mpnn``; reference
``experiments/layers.py:231-267``).

Per tower t: message_ij = Linear_t([x_i || x_j]), aggregated (sum or max)
at the receiver; update_i = Linear_t([agg_i || x_i]); then one Linear
across the concatenated towers. No self-loops; in_dim == out_dim.

The JAX package's factorisation is kept: the message Linear is linear in
[x_i || x_j], so message_ij = p_i + p_j with node-level transforms (the
bias in p_i), and

    sum_i = deg_i * p_i + SUM_j p_j
    max_i = p_i + MAX_j p_j              (deg_i > 0, else 0)

exactly the per-edge form, with one ``conv_aggregate`` of ``p_j`` (the
gather-reduce kernels on a CUDA tensor with a plan). Parameters carry the
reference's names: ``message_layer.{t}``, ``update_layer.{t}`` (one
Linear a tower) and ``lin``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from egc_tpu_torch.nn.mlp import linear
from egc_tpu_torch.ops.dispatch import conv_aggregate
from egc_tpu_torch.ops.segment import segment_count


def node_degree(g, n: int) -> torch.Tensor:
    """[n] f32 in-degree over valid edges: the plan's when the graph has a
    plan for its rows, else counted (``mpnn.py:53-58`` of the JAX
    package)."""
    plan = g.kernel_plan
    if plan is not None and plan.num_nodes == n:
        return plan.deg
    return segment_count(g.receivers, n, mask=g.edge_mask)


def tower_linear(xt: torch.Tensor, lins, *, cols: slice = slice(None),
                 bias: bool = True) -> torch.Tensor:
    """Tower t's Linear on ``xt[:, t]``, with the weight columns ``cols``
    only: ``[N, T, in] -> [N, T, out]``, one matmul a tower. (As one
    batched einsum, the weight gradient is a bmm over N rows of tiny
    matrices, which ran ~50x slower on the card; the towers come apart by
    ``unbind``, whose gradient is one stack, where indexing each tower
    would add T full-size zero tensors.)"""
    return torch.stack([F.linear(x, lin.weight[:, cols],
                                 lin.bias if bias else None)
                        for x, lin in zip(xt.unbind(1), lins)], dim=1)


class MPNNConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, *,
                 aggr: str = "sum", towers: int = 4,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if in_channels % towers or out_channels % towers:
            raise ValueError("in/out dims must divide towers")
        if aggr not in ("sum", "max"):
            raise ValueError(f"unsupported MPNN aggr {aggr!r}")
        self.aggr = aggr
        self.towers = towers
        it, ot = in_channels // towers, out_channels // towers
        self.it, self.ot = it, ot
        self.message_layer = nn.ModuleList(
            linear(2 * it, ot, generator=generator, device=device)
            for _ in range(towers))
        self.update_layer = nn.ModuleList(
            linear(ot + it, ot, generator=generator, device=device)
            for _ in range(towers))
        self.lin = linear(out_channels, out_channels, generator=generator,
                          device=device)

    def forward(self, g, x: torch.Tensor) -> torch.Tensor:
        n, T, it, ot = x.shape[0], self.towers, self.it, self.ot
        xt = x.reshape(n, T, it)
        # message_ij = [x_i || x_j] W^T + b = (x_i W_i^T + b) + x_j W_j^T
        p_i = tower_linear(xt, self.message_layer, cols=slice(0, it))
        p_j = tower_linear(xt, self.message_layer, cols=slice(it, None),
                           bias=False)
        deg = node_degree(g, n)[:, None, None]
        a = conv_aggregate(g, p_j.reshape(n, T * ot), (self.aggr,),
                           stacked=False)[0].reshape(n, T, ot)
        if self.aggr == "sum":
            agg = deg * p_i + a
        else:
            agg = torch.where(deg > 0, p_i + a, torch.zeros_like(a))
        upd = tower_linear(torch.cat([agg, xt], -1), self.update_layer)
        return self.lin(upd.reshape(n, T * ot))
