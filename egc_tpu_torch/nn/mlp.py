"""MLP (counterpart of ``egc_tpu.nn.mlp``; the reference's ``mlp()``
helper, ``experiments/utils.py:30-40``).

For output sizes ``[l1, ..., lk]``: (Linear -> masked BatchNorm -> ReLU
-> dropout) for each hidden size, then a plain Linear. The children sit
at the reference's ``nn.Sequential`` indices (Linear at 4k, BatchNorm at
4k + 1), so a reference state dict loads as it is. The BatchNorm counts
the rows of ``mask`` only. The dropout is the JAX package's default, 0,
the only rate its callers use.

``MLP([out])`` is one Linear. The GIN conv, whose reference net is a bare
``nn.Linear(h, h)`` (``arxiv/norm_models.py:95``), holds that Linear
itself (``nn/conv/simple.GINConv``), under the reference's name.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from egc_tpu_torch.nn import init as einit
from egc_tpu_torch.nn.norm import MaskedBatchNorm


def linear(fan_in: int, fan_out: int, *, bias: bool = True,
           generator: Optional[torch.Generator] = None,
           device=None) -> nn.Linear:
    """``nn.Linear`` with torch's default init drawn from ``generator``."""
    lin = nn.Linear(fan_in, fan_out, bias=bias, device=device)
    einit.torch_linear_(lin, generator)
    return lin


class MLP(nn.Sequential):
    def __init__(self, in_dim: int, layer_sizes: Sequence[int], *,
                 generator: Optional[torch.Generator] = None, device=None):
        sizes = list(layer_sizes)
        mods = []
        for size in sizes[:-1]:
            mods += [linear(in_dim, size, generator=generator,
                            device=device),
                     MaskedBatchNorm(size, device=device), nn.ReLU(),
                     nn.Dropout(0.0)]
            in_dim = size
        mods.append(linear(in_dim, sizes[-1], generator=generator,
                           device=device))
        super().__init__(*mods)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        mods = list(self)
        for k in range(0, len(mods) - 1, 4):
            x = torch.relu(mods[k + 1](mods[k](x), mask))
        return mods[-1](x)
