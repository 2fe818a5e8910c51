"""Profiling on ``torch.profiler`` (counterpart of
``egc_tpu.utils.profiling``): the program's spans, a trace context that
also writes a Chrome trace, and a table of device self time by op.

``span(name)`` marks a stretch of the program (a module's forward, a
step's phase, a trial's phase). It is on only while something reads it:

- under a recording ``torch.profiler`` it enters ``record_function(name)``,
  so the span lies on the profiler's clock with the kernels it launched
  and the device's idle gaps;
- inside ``span_totals()`` it adds its host-clock seconds and a count
  under ``name``.

With neither it returns one shared no-op context and reads nothing else.
Nothing else turns spans on: no environment variable, option or setting.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

NO_SPAN = contextlib.nullcontext()

# The open ``span_totals`` collector: {name: [seconds, count]}, or None.
_totals: Optional[Dict[str, List[float]]] = None


class _Span:
    """An open span: its profiler range and its host-clock start, added
    on exit to the collector that was open when it began."""

    __slots__ = ("name", "_range", "_totals", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = record_function(self.name)
            self._range.__enter__()
        self._totals = _totals
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._totals is not None:
            row = self._totals[self.name]
            row[0] += time.perf_counter() - self._t0
            row[1] += 1
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str):
    """A context that marks ``name``: a profiler range while a
    ``torch.profiler`` records, host seconds while ``span_totals`` is
    open, otherwise the shared no-op ``NO_SPAN``."""
    if _totals is None and not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return _Span(name)


@contextlib.contextmanager
def span_totals() -> Iterator[Dict[str, List[float]]]:
    """Collect the spans of the block: yields ``{name: [seconds, count]}``,
    filled as each span ends (on any thread). The collector open before
    it comes back at the end."""
    global _totals
    outer, _totals = _totals, defaultdict(lambda: [0.0, 0])
    try:
        yield _totals
    finally:
        _totals = outer


@contextlib.contextmanager
def profile_trace(log_dir=None, enabled: bool = True):
    """Profile the block's CPU ops and, when a card is present, its CUDA
    kernels and copies; yields the profiler (``None`` when not
    ``enabled``). With ``log_dir``, ``trace.json`` (Chrome trace format)
    is written there at the end."""
    if not enabled:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if log_dir is not None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def _self_device_us(evt) -> float:
    """An event's device self time in us (the attribute's name changed
    across torch releases)."""
    v = getattr(evt, "self_device_time_total", None)
    return float(v if v is not None else
                 getattr(evt, "self_cuda_time_total", 0.0))


def device_op_table(prof) -> List[Tuple[str, float]]:
    """``[(device op, self time in us)]`` of a finished profiler,
    descending: the kernels, copies and memsets the card ran (whatever
    launched them, ``ctypes`` kernels too), user ranges left out. Their
    sum is the card's busy time in the window."""
    rows = [(evt.key, _self_device_us(evt)) for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False)]
    rows = [(k, v) for k, v in rows if v > 0]
    rows.sort(key=lambda kv: -kv[1])
    return rows
