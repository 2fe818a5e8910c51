"""GCN, GIN and GraphSAGE convolutions (counterpart of
``egc_tpu.nn.conv.simple``; PyG semantics, reference
``experiments/arxiv/norm_models.py``).

Each runs one ``conv_aggregate`` of node values, so on a CUDA tensor with
a kernel plan its aggregation is the gather-reduce kernels' (GCN: wsum,
GIN: sum, SAGE: sum and the in-degree). Self-loops are virtual, as in
``egc_tpu``. Parameters carry PyG's names: GCN ``lin.weight`` (no bias)
and ``bias``; GIN ``eps`` (a scalar) and its net ``nn``; SAGE ``lin_l``
(with bias) and ``lin_r`` (without).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from egc_tpu_torch.graph.transforms import symnorm_weight
from egc_tpu_torch.nn import init as einit
from egc_tpu_torch.nn.mlp import linear
from egc_tpu_torch.ops.dispatch import conv_aggregate


class GCNConv(nn.Module):
    """x' = D^-1/2 (A + I) D^-1/2 X Theta + b (PyG GCNConv defaults: the
    projection glorot-initialised, the bias zeros). The graph's own
    ``edge_weight`` / ``self_weight`` are used when it has them."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.lin = nn.Linear(in_channels, out_channels, bias=False,
                             device=device)
        einit.glorot_uniform_(self.lin.weight, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))

    def forward(self, g, x: torch.Tensor) -> torch.Tensor:
        h = self.lin(x)
        if g.edge_weight is not None:
            ew, sw = g.edge_weight, g.self_weight
        else:
            ew, sw = symnorm_weight(g.senders, g.receivers, x.shape[0],
                                    edge_mask=g.edge_mask)
        out = conv_aggregate(g, h, ("symnorm",), symnorm_edge_w=ew,
                             symnorm_self_w=sw, stacked=False)[0]
        return out + self.bias


class GINConv(nn.Module):
    """x' = nn((1 + eps) x + sum_j x_j) (PyG GINConv with ``train_eps``, as
    every net builds it: ``eps`` a trainable scalar from 0)."""

    def __init__(self, net: nn.Module, *, device=None):
        super().__init__()
        self.nn = net
        self.eps = nn.Parameter(torch.zeros((), device=device))

    def forward(self, g, x: torch.Tensor) -> torch.Tensor:
        agg = conv_aggregate(g, x, ("sum",), stacked=False)[0]
        return self.nn((1.0 + self.eps) * x + agg)


class SAGEConv(nn.Module):
    """x' = W_l mean_j(x_j) + W_r x (PyG SAGEConv defaults: mean, root
    weight, the bias on the neighbour path only)."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.lin_l = linear(in_channels, out_channels, generator=generator,
                            device=device)
        self.lin_r = linear(in_channels, out_channels, bias=False,
                            generator=generator, device=device)

    def forward(self, g, x: torch.Tensor) -> torch.Tensor:
        agg = conv_aggregate(g, x, ("mean",), stacked=False)[0]
        return self.lin_l(agg) + self.lin_r(x)
