"""Structured metric logging and throughput counters (counterpart of
``egc_tpu.utils.logging``): a JSONL logger (one metric row a line) and a
meter that turns step times into edges/s and nodes/s."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class JSONLLogger:
    """Append-only JSONL metric log (one dict a line, ``ts`` added)."""

    def __init__(self, path, echo: bool = False):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.echo = echo
        self._fh = open(self.path, "a")

    def log(self, row: Dict[str, Any]):
        row = {"ts": time.time(), **row}
        self._fh.write(json.dumps(row, default=float) + "\n")
        self._fh.flush()
        if self.echo:
            print(" ".join(f"{k}={v}" for k, v in row.items()
                           if k != "ts"))

    def close(self):
        self._fh.close()


class ThroughputMeter:
    """Step time -> edges/s and nodes/s, the first ``warmup`` steps left
    out.

    The meter reads the host clock. CUDA work is enqueued and returns
    before the card finishes it, so call ``step_end`` only after the
    caller has synchronised with the device (``torch.cuda.synchronize``,
    or reading a result such as the loss); otherwise a step counts its
    enqueue time, not its device time."""

    def __init__(self, edges_per_step: int, nodes_per_step: int = 0,
                 warmup: int = 1):
        self.edges = edges_per_step
        self.nodes = nodes_per_step
        self.warmup = warmup
        self._steps = 0
        self._t0: Optional[float] = None
        self._elapsed = 0.0

    def step_start(self):
        self._t0 = time.perf_counter()

    def step_end(self) -> float:
        dt = time.perf_counter() - self._t0
        self._steps += 1
        if self._steps > self.warmup:
            self._elapsed += dt
        return dt

    @property
    def counted_steps(self) -> int:
        return max(self._steps - self.warmup, 0)

    def summary(self) -> Dict[str, float]:
        n = self.counted_steps
        if n == 0 or self._elapsed == 0:
            return {}
        per_step = self._elapsed / n
        out = {"step_time_s": per_step,
               "edges_per_s": self.edges / per_step}
        if self.nodes:
            out["nodes_per_s"] = self.nodes / per_step
        return out
