"""PNA, Principal Neighbourhood Aggregation (counterpart of
``egc_tpu.nn.conv.pna``; PyG ``PNAConv(h, h, aggregators=[mean, min, max,
std], scalers=[identity, amplification, attenuation], deg=hist, towers=4,
divide_input=True)``, reference ``experiments/arxiv/norm_models.py:
174-182``).

- a per-tower pre Linear on [x_i || x_j] per edge;
- the aggregators concatenated, then the degree scalers multiply the
  concatenation: amplification log(d + 1) / avg_log, attenuation
  avg_log / log(d + 1), d the in-degree clamped to >= 1;
- ``avg_log`` is the histogram-weighted mean of log(deg + 1) over the
  dataset (``avg_log_degree``, PyG's ``avg_deg['log']``);
- a per-tower post Linear on [x_i || aggregated], towers concatenated,
  then a final Linear. No self-loops.

The JAX package's factorisation is kept: the pre Linear is linear in
[x_i || x_j], so msg_ij = u_i + v_j with node-level u = x W_i + b and
v = x W_j, and mean / min / max of msg are u_i + those of v (0 on an
empty receiver), std of msg is std of v. All four aggregators of ``v`` go
through one ``conv_aggregate`` call (the gather-reduce kernels' sum,
sumsq, max and min on a CUDA tensor with a plan). Parameters carry PyG's
names: ``pre_nns.{t}.0``, ``post_nns.{t}.0`` and ``lin``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from egc_tpu_torch.nn.conv.mpnn import node_degree, tower_linear
from egc_tpu_torch.nn.mlp import linear
from egc_tpu_torch.ops.dispatch import conv_aggregate

AGGREGATORS = ("mean", "min", "max", "std")
SCALERS = ("identity", "amplification", "attenuation")


def avg_log_degree(deg_hist) -> float:
    """PyG ``avg_deg['log']``: histogram-weighted mean of log(d + 1)."""
    hist = np.asarray(deg_hist, dtype=np.float64)
    d = np.arange(len(hist), dtype=np.float64)
    return float((np.log(d + 1) * hist).sum() / max(hist.sum(), 1.0))


class PNAConv(nn.Module):
    """The reference's PNA: ``AGGREGATORS`` and ``SCALERS``, 4 towers over
    a divided input (the one configuration every net builds)."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 avg_log_deg: float, towers: int = 4,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if in_channels % towers or out_channels % towers:
            raise ValueError("in/out dims must divide towers")
        self.avg_log_deg = float(avg_log_deg)
        self.towers = towers
        self.f_in = f_in = in_channels // towers
        pin = f_in * (1 + len(AGGREGATORS) * len(SCALERS))
        self.pre_nns = nn.ModuleList(
            nn.Sequential(linear(2 * f_in, f_in, generator=generator,
                                 device=device))
            for _ in range(towers))
        self.post_nns = nn.ModuleList(
            nn.Sequential(linear(pin, out_channels // towers,
                                 generator=generator, device=device))
            for _ in range(towers))
        self.lin = linear(out_channels, out_channels, generator=generator,
                          device=device)

    def forward(self, g, x: torch.Tensor) -> torch.Tensor:
        n, T, f_in = x.shape[0], self.towers, self.f_in
        xt = x.reshape(n, T, f_in)
        pre = [s[0] for s in self.pre_nns]
        u = tower_linear(xt, pre, cols=slice(0, f_in))
        v = tower_linear(xt, pre, cols=slice(f_in, None), bias=False)
        mean, mn, mx, std = (a.reshape(n, T, f_in) for a in conv_aggregate(
            g, v.reshape(n, T * f_in), AGGREGATORS, stacked=False))
        rdeg = node_degree(g, n)
        nonempty = (rdeg > 0)[:, None, None]
        # mean / min / max shift by u_i (0 on an empty receiver); the std
        # is shift-invariant
        agg = torch.cat([torch.where(nonempty, u + a, torch.zeros_like(a))
                         for a in (mean, mn, mx)] + [std], dim=-1)
        log_deg = torch.log(torch.clamp(rdeg, min=1.0) + 1.0)[:, None, None]
        post_in = torch.cat([xt, agg, agg * (log_deg / self.avg_log_deg),
                             agg * (self.avg_log_deg / log_deg)], dim=-1)
        out = tower_linear(post_in, [s[0] for s in self.post_nns])
        return self.lin(out.reshape(n, -1))
