"""Faults planted under the program, and the lower-precision control,
for calibrating the limits and for the tests that show a broken program
reads ``correct`` false. The benchmark's own runs plant nothing.

- ``control``: the program's own lower-precision path, bf16 inputs to
  EGConv's matmuls (``EGC_TPU_BF16_DENSE=1``), in place of the float32
  the configurations state;
- ``frozen``: a step that returns its state unchanged (Adam's step does
  nothing);
- ``half_batch``: the loss averaged over half the step's labelled rows,
  the rest left out;
- ``altered``: the step's loss altered where it is produced (scaled by
  1 + 1e-3).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch

FAULTS = ("control", "frozen", "half_batch", "altered")


@contextlib.contextmanager
def planted(fault: Optional[str]) -> Iterator[None]:
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    if fault == "control":
        old = os.environ.get("EGC_TPU_BF16_DENSE")
        os.environ["EGC_TPU_BF16_DENSE"] = "1"
        try:
            yield
        finally:
            if old is None:
                os.environ.pop("EGC_TPU_BF16_DENSE", None)
            else:
                os.environ["EGC_TPU_BF16_DENSE"] = old
        return
    if fault == "frozen":
        with _patched(torch.optim.Adam, "step",
                      lambda self, closure=None: None):
            yield
        return
    from egc_tpu_torch.exp import fullgraph
    nll = fullgraph.masked_nll

    def half(out, y, mask):
        kept = mask & (torch.cumsum(mask.long(), 0) <= (mask.sum() + 1) // 2)
        return nll(out, y, kept)

    def altered(out, y, mask):
        return nll(out, y, mask) * (1.0 + 1e-3)

    with _patched(fullgraph, "masked_nll",
                  half if fault == "half_batch" else altered):
        yield


@contextlib.contextmanager
def _patched(owner, name: str, value) -> Iterator[None]:
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)
