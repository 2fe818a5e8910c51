"""What a traced run reads from ``torch.profiler``: each device
operation's time, the device's busy time, and the idle gaps between
device operations by what the host was doing.

The device-time table follows ``egc_tpu_torch/utils/profiling.py``
(``device_op_table``: CUDA events' self time, user ranges left out),
copied here so that the benchmark's arithmetic does not move with the
program's.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def profiler() -> profile:
    """A profiler of the host's operations and the card's kernels."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _self_device_us(evt) -> float:
    v = getattr(evt, "self_device_time_total", None)
    return float(v if v is not None else
                 getattr(evt, "self_cuda_time_total", 0.0))


def device_ops(prof) -> List[Tuple[str, float]]:
    """``[(device op, seconds)]``, the largest first: the kernels, copies
    and memsets the card ran. Their sum is its busy time."""
    rows = [(evt.key, _self_device_us(evt) / 1e6)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False)]
    rows = [(k, v) for k, v in rows if v > 0]
    rows.sort(key=lambda kv: -kv[1])
    return rows


def idle_gaps(prof, top: int = 10) -> List[Tuple[str, float]]:
    """The device's idle time between its operations, summed by the host
    operation that was running when each gap began (the innermost one),
    the largest first."""
    dev, host = [], []
    for evt in prof.events():
        tr = evt.time_range
        if evt.device_type == DeviceType.CUDA:
            if not getattr(evt, "is_user_annotation", False):
                dev.append((tr.start, tr.end))
        elif evt.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, evt.name))
    if not dev:
        return []
    dev.sort()
    host.sort()
    gaps, end = [], dev[0][1]
    for a, b in dev[1:]:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    starts = [h[0] for h in host]
    by = defaultdict(float)
    for a, b in gaps:
        name = "(no host op)"
        for i in range(bisect.bisect_right(starts, a) - 1, -1, -1):
            if host[i][1] > a:        # the latest-starting op still running
                name = host[i][2]
                break
        by[name] += (b - a) / 1e6
    return sorted(by.items(), key=lambda kv: -kv[1])[:top]


def matching(ops: Sequence[Tuple[str, float]], patterns: Sequence[str]
             ) -> float:
    """Seconds of the operations whose names match any of ``patterns``."""
    rx = re.compile("|".join(patterns))
    return sum(v for k, v in ops if rx.search(k))


def profile_record(prof, steps: int, window_s: float) -> Dict[str, object]:
    """The traced window's record: its device operations, busy seconds,
    idle gaps, steps and host-clock length."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    ops = device_ops(prof)
    return {"ops": ops, "busy_s": sum(v for _, v in ops),
            "gaps": idle_gaps(prof), "steps": steps, "window_s": window_s}


def idle_share_reader(path: str):
    """``read`` of ``metrics/device_idle_share.<mode>.py``: the card's
    idle share of a step of that traffic mode (the file's last name),
    one less the device's busy time a step under the profiler over the
    step's time without it (the same run's window). After
    ``chip_smoke.py``'s ``_device_idle``."""
    mode = Path(path).name.split(".")[-2]

    def read(r):
        if r["mode"] != mode or "profile" not in r:
            return None
        prof = r["profile"]
        step_s = r["window_s"] / r["steps"]
        return 100.0 * (1.0 - prof["busy_s"] / prof["steps"] / step_s)

    return read
