"""Batched training and evaluation epochs (counterpart of
``egc_tpu.train.loop``).

``train_epoch`` keeps each step's loss on the device until the epoch ends
and reads them all at once, as the JAX loop does: a per-step ``float()``
would hold the host at every step and serialise the loader's prefetch
against the device. ``eval_epoch`` brings each batch's outputs to the
host for the task metric.

The consuming thread's two parts of a step are spans
(``utils.profiling.span``), ``egc.batch`` (waiting for the next batch and
its copy to the device) and ``egc.step`` (forward, backward and optimizer
step, enqueued); ``train_step`` splits the step into ``egc.forward``,
``egc.loss``, ``egc.backward`` and ``egc.optimizer``. A span is on only
under a recording ``torch.profiler`` (a range on its clock, so a trace
splits the host's time between them) or inside ``span_totals()`` (host
seconds by name); otherwise it is a shared no-op.

Dropout draws from an explicit ``torch.Generator``: ``fold_in`` derives an
iteration's generator from the trial's, as the JAX loop folds the trial
key with the iteration (``egc_tpu/exp/batched.py:137-140``), and the steps
of the epoch draw from it in turn. The two frameworks' streams differ, so
the same seed gives other dropout masks than the JAX package's.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from egc_tpu_torch.utils.profiling import span


class StepClock:
    """Step boundaries without a host synchronise: a CUDA event per mark
    on the card, the host clock on the CPU. ``start()`` opens a window and
    ``mark()`` ends a step; ``seconds()`` reads the marks (synchronising
    once) as each step's duration from the mark before it, so time between
    windows (an evaluation) counts as no step."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._marks: List = []     # (mark, opens a window)

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self) -> None:
        self._marks.append((self._now(), True))

    def mark(self) -> None:
        self._marks.append((self._now(), False))

    def seconds(self) -> List[float]:
        if self.cuda and self._marks:
            self._marks[-1][0].synchronize()
        out = []
        for (a, _), (b, opens) in zip(self._marks, self._marks[1:]):
            if not opens:
                out.append(a.elapsed_time(b) / 1e3 if self.cuda else b - a)
        return out


def fold_in(generator: torch.Generator, data: int) -> torch.Generator:
    """A new generator on ``generator``'s device, seeded from its seed and
    ``data`` (``jax.random.fold_in``'s role; ``generator``'s state is left
    as it is)."""
    seed = np.random.SeedSequence(
        [generator.initial_seed(), int(data)]).generate_state(1, np.uint64)
    return torch.Generator(device=generator.device).manual_seed(
        int(seed[0]) >> 1)


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               loss_fn: Callable, graph, y: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One step on one batch; returns the loss (a device scalar). The
    parameters' ``.grad`` hold this step's gradients afterwards. Dropout
    draws from ``generator``."""
    model.train()
    with span("egc.optimizer"):
        optimizer.zero_grad(set_to_none=True)
    with span("egc.forward"):
        out = model(graph, generator=generator)
    with span("egc.loss"):
        loss = loss_fn(out, y, graph)
    with span("egc.backward"):
        loss.backward()
    with span("egc.optimizer"):
        optimizer.step()
    return loss.detach()


def train_epoch(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                loss_fn: Callable, loader: Iterable, *,
                steps: Optional[int] = None,
                clock: Optional[StepClock] = None,
                generator: Optional[torch.Generator] = None) -> np.ndarray:
    """One pass over ``loader`` (its first ``steps`` batches, when given);
    returns the per-step losses, read from the device once at the end (the
    JAX loop returns their mean). ``loss_fn(out, y, graph)`` must respect
    the batch's masks. ``clock`` is marked after each step; the steps'
    dropout draws from ``generator``."""
    losses = []
    it = iter(loader)
    while steps is None or len(losses) < steps:
        with span("egc.batch"):
            batch = next(it, None)
        if batch is None:
            break
        with span("egc.step"):
            losses.append(train_step(model, optimizer, loss_fn, *batch,
                                     generator=generator))
        if clock is not None:
            clock.mark()
    if not losses:
        return np.zeros(0, np.float32)
    return torch.stack(losses).cpu().numpy()


@torch.no_grad()
def eval_epoch(model: torch.nn.Module, loader: Iterable) -> list:
    """The model in eval mode over ``loader``; returns host-side
    ``(out, y, graph_mask)`` numpy triples, one per batch."""
    model.eval()
    return [(model(graph).cpu().numpy(), y.cpu().numpy(),
             graph.graph_mask.cpu().numpy()) for graph, y in loader]
