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
group's ranks with one all-reduce, so every rank normalises, and updates
its running statistics, with the global batch's. The backward sums the
cotangents of ``(s, ssq)`` over the ranks, as ``psum``'s transpose does.

The arithmetic is ``ops/cuda/batch_norm``'s autograd function: its plain
PyTorch versions on a CPU tensor, its four CUDA kernels on a CUDA one.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from egc_tpu_torch.ops.cuda.batch_norm import masked_batch_norm
from egc_tpu_torch.utils.profiling import span


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
        ones. The span ``egc.norm``; on a CUDA tensor the kernels of
        ``ops/cuda/batch_norm``."""
        with span("egc.norm"):
            return masked_batch_norm(
                x, mask, self.weight, self.bias, self.running_mean,
                self.running_var, self.num_batches_tracked,
                training=self.training, group=self.process_group)


def sync_process_group(module: nn.Module, group) -> nn.Module:
    """Set ``group`` (None: no sync) on every ``MaskedBatchNorm`` in
    ``module`` (the JAX nets' ``bn_axis``); returns ``module``."""
    for m in module.modules():
        if isinstance(m, MaskedBatchNorm):
            m.process_group = group
    return module
