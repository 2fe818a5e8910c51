"""What the port needs of ``egc_tpu.train.state``.

There is no flax-style ``TrainState``: the model holds the parameters and
the BatchNorm statistics, and the optimizer holds its moments and the
step count, so the two together are the training state.
"""

from __future__ import annotations

import torch


def num_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def optimizer_step(optimizer: torch.optim.Optimizer) -> int:
    """Optimizer steps taken (``TrainState.step``): the largest ``step``
    in the optimizer's per-parameter state, 0 before the first."""
    steps = [float(s["step"]) for s in optimizer.state.values()
             if "step" in s]
    return int(max(steps)) if steps else 0
