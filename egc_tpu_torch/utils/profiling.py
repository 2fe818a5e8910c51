"""Profiling on ``torch.profiler`` (counterpart of
``egc_tpu.utils.profiling``): a trace context that also writes a Chrome
trace, and a table of device self time by op."""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


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


def print_op_table(prof, top: int = 25) -> float:
    """Print the ``top`` ops of ``device_op_table`` with their shares;
    returns the total device self time in us."""
    rows = device_op_table(prof)
    total = sum(v for _, v in rows)
    print(f"total device self-time: {total / 1e3:.3f} ms", flush=True)
    for name, v in rows[:top]:
        print(f"  {v / 1e3:9.3f} ms {100 * v / max(total, 1e-9):5.1f}%  "
              f"{name[:84]}", flush=True)
    return total
