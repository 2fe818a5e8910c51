"""Masked BatchNorm (counterpart of ``egc_tpu.nn.norm``).

Statistics over the valid rows only, with ``egc_tpu``'s exact formula
rather than ``nn.BatchNorm1d``'s:

- batch mean and var = max(E[x^2] - E[x]^2, 0), the biased var used to
  normalise;
- running var updated with the unbiased estimate var * n / (n - 1);
- running = (1 - momentum) * running + momentum * batch, momentum 0.1;
- eps 1e-5 inside the square root.

Parameter and buffer names are ``BatchNorm1d``'s (weight, bias,
running_mean, running_var, num_batches_tracked), so reference state dicts
load as they are.

Sync-BN (``MaskedBatchNorm(axis_name=...)`` of the JAX package,
``egc_tpu/nn/norm.py:29, 60-63``): with a ``process_group`` set
(``sync_process_group``), training mode sums ``(s, ssq, n)`` over the
group's ranks with one differentiable all-reduce, so every rank
normalises, and updates its running statistics, with the global batch's.
The all-reduce's backward sums the cotangents over the ranks, as
``psum``'s transpose does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from egc_tpu_torch.utils.profiling import span


MOMENTUM = 0.1
EPS = 1e-5


class MaskedBatchNorm(nn.Module):
    def __init__(self, num_features: int, *, device=None):
        super().__init__()
        self.process_group = None
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long, device=device))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [N, F]; mask: [N] bool (None: every row is valid). Training
        mode uses and updates batch statistics, eval mode the running
        ones. The span ``egc.norm``."""
        with span("egc.norm"):
            if not self.training:
                mean, var = self.running_mean, self.running_var
            else:
                xf = x.float()
                if mask is None:
                    s, ssq = xf.sum(0), (xf * xf).sum(0)
                    n = torch.tensor(float(x.shape[0]), device=x.device)
                else:
                    m = mask.to(torch.float32)[:, None]
                    s, ssq = (xf * m).sum(0), (xf * xf * m).sum(0)
                    n = m.sum()
                if self.process_group is not None:
                    from egc_tpu_torch.parallel.mesh import all_reduce_sum
                    f = s.shape[0]
                    tot = all_reduce_sum(torch.cat([s, ssq, n.reshape(1)]),
                                         self.process_group)
                    s, ssq, n = tot[:f], tot[f:2 * f], tot[2 * f]
                n = torch.clamp(n, min=1.0)
                mean = s / n
                var = torch.clamp(ssq / n - mean * mean, min=0.0)
                with torch.no_grad():
                    unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                    self.running_mean.mul_(1 - MOMENTUM).add_(
                        MOMENTUM * mean)
                    self.running_var.mul_(1 - MOMENTUM).add_(
                        MOMENTUM * unbiased)
                    self.num_batches_tracked.add_(1)
            y = (x.float() - mean) * torch.reciprocal(torch.sqrt(var + EPS))
            return (y * self.weight + self.bias).to(x.dtype)


def sync_process_group(module: nn.Module, group) -> nn.Module:
    """Set ``group`` (None: no sync) on every ``MaskedBatchNorm`` in
    ``module`` (the JAX nets' ``bn_axis``); returns ``module``."""
    for m in module.modules():
        if isinstance(m, MaskedBatchNorm):
            m.process_group = group
    return module
