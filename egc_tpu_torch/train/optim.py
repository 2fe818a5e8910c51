"""Optimizer and learning-rate schedule (counterpart of
``egc_tpu.train.optim``).

- ``make_optimizer``: torch ``Adam(lr, weight_decay)``, the reference's
  optimizer (``experiments/zinc/configs.py:129``): the L2 penalty is added
  to the gradient before the Adam moments (not AdamW), as the JAX chain
  ``add_decayed_weights -> scale_by_adam -> scale(-lr)`` does.
- ``plateau_init`` / ``plateau_update``: torch ``ReduceLROnPlateau``
  (relative threshold 1e-4, cooldown 0) as a small pure state machine
  updated on the host after each validation, the JAX package's; ``set_lr``
  writes its learning rate into the optimizer's parameter groups.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   learning_rate: float, weight_decay: float = 0.0,
                   b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2),
                            eps=eps, weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class PlateauState(NamedTuple):
    """torch ReduceLROnPlateau state (host-side scalars)."""

    lr: float
    best: float
    num_bad: int
    mode: str = "min"
    factor: float = 0.5
    patience: int = 10
    min_lr: float = 1e-5
    threshold: float = 1e-4


def plateau_init(lr: float, mode: str = "min", factor: float = 0.5,
                 patience: int = 10, min_lr: float = 1e-5) -> PlateauState:
    best = float("inf") if mode == "min" else float("-inf")
    return PlateauState(lr=lr, best=best, num_bad=0, mode=mode,
                        factor=factor, patience=patience, min_lr=min_lr)


def plateau_update(state: PlateauState, metric: float) -> PlateauState:
    """One validation's update; returns the state, with the learning rate
    cut by ``factor`` (not below ``min_lr``) after more than ``patience``
    validations without a relative improvement of ``threshold``."""
    if state.mode == "min":
        improved = state.best == float("inf") or \
            metric < state.best * (1 - state.threshold)
    else:
        improved = state.best == float("-inf") or \
            metric > state.best * (1 + state.threshold)
    if improved:
        return state._replace(best=metric, num_bad=0)
    num_bad = state.num_bad + 1
    if num_bad > state.patience:
        return state._replace(lr=max(state.lr * state.factor, state.min_lr),
                              num_bad=0)
    return state._replace(num_bad=num_bad)
