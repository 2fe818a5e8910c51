"""One run of one cell: the traffic mode runs the program (set-up,
the first steps the reference follows, the measured window, and in a
traced run a profiled stretch), the program's state is dropped, the
reference follows the first steps, and the numbers that decide
``correct`` are compared with the cell's limits.

``run_cell`` takes the device it is given; the look for a card is
``run.py``'s. ``fault`` plants one of ``faults.FAULTS`` under the
program (calibration and the tests only).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from gnnbench import faults as faults_mod
from gnnbench.cell import Cell
from gnnbench.reference.common import fold_seed


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float

    @property
    def weights_seed(self) -> int:
        return fold_seed(self.seed, 1)

    @property
    def trial_seed(self) -> int:
        """The program's trial seed (its dropout stream; numpy's legacy
        seeding takes 32 bits)."""
        return fold_seed(self.seed, 2) % 2 ** 32

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0


@dataclasses.dataclass
class Outcome:
    """What a traffic mode hands back: the run's records, the program's
    readings of its first steps, the window's steps attempted and failed,
    and the reference's side, run once the program's state is gone."""

    records: dict
    program: dict
    attempted: int
    failed: int
    reference: Callable[[], dict]
    setup_peak: int = 0


def clock() -> float:
    return time.perf_counter()


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               leaves: List[str]) -> List[float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the
    median leaf."""
    pn, rn = _norms({k: prog[k] for k in leaves}), \
        _norms({k: ref[k] for k in leaves})
    median = float(np.median([rn[k] for k in leaves]))
    return [abs(pn[k] - rn[k]) / max(rn[k], median, 1e-30) for k in leaves]


def training_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers of a training comparison (a cell compares those its
    workload file gives a limit):

    - ``loss_gap``: the widest relative gap of a step's loss;
      ``loss_gap_first``: the first step's;
    - ``grad_gap``: the first gradient as Adam took it, by the worst leaf;
    - ``change_gap``: each parameter's change over the steps, by the
      worst leaf, and ``change_gap_median`` by the median leaf; leaves
      whose reference gradient of the loss is under a thousandth of the
      median leaf's are left out (they move by round-off alone);
    - ``acc_gap``: where both evaluated, the widest gap of a split's
      accuracy after a step.
    """
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog["losses"], ref["losses"])]
    out = {"loss_gap": max(gaps), "loss_gap_first": gaps[0]}
    if len(prog["losses"]) != len(ref["losses"]):
        out["loss_gap"] = math.inf
    leaves = sorted(ref["grad"])
    out["grad_gap"] = max(_leaf_gaps(prog["grad"], ref["grad_taken"],
                                     leaves))
    gn = _norms(ref["grad"])
    floor = 1e-3 * float(np.median(list(gn.values())))
    moved = [k for k in leaves if gn[k] >= floor]
    change = _leaf_gaps(prog["change"], ref["change"], moved)
    out["change_gap"] = max(change)
    out["change_gap_median"] = float(np.median(change))
    if ref.get("accs"):
        out["acc_gap"] = max(abs(p[k] - r[k])
                             for p, r in zip(prog["accs"], ref["accs"])
                             for k in r)
    return out


def checks(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, Dict[str, float]]:
    """Each number the cell compares beside its limit; a number the cell
    names and the run did not give reads infinite, and fails."""
    return {k: {"value": numbers.get(k, math.inf), "limit": lim}
            for k, lim in limits.items()}


def all_within(table: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in table.values())


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, *, t_start: Optional[float] = None,
             fault: Optional[str] = None, keep: bool = False) -> dict:
    """Run ``cell`` once; returns ``correct``, ``attempted``, ``failed``,
    the metrics (end-to-end, or per-layer when ``trace``), the checks,
    the set-up peak, and the traced run's breakdown; with ``keep``, also
    both sides' readings and the reference's side to run again."""
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                  device=torch.device(device),
                  t_start=clock() if t_start is None else t_start)
    with faults_mod.planted(fault):
        out = cell.mode().run(ctx)
    window_peak = out.records["peak_bytes"]
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = out.reference()
    numbers = training_numbers(out.program, ref)
    if "batch_faults" in ref:
        numbers["batch_faults"] = float(len(ref["batch_faults"]))
    table = checks(numbers, cell.limits)
    metrics = {}
    names = cell.per_layer if trace else cell.end_to_end
    for name in names:
        value = cell.reader(name)(out.records)
        if value is not None:
            metrics[name] = value
    result = {"correct": all_within(table) and out.failed == 0,
              "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "checks": table,
              "memory_peak_bytes": max(window_peak, out.setup_peak),
              "batch_faults": ref.get("batch_faults", [])}
    if keep:
        result.update(numbers=numbers, program=out.program, reference=ref,
                      rerun_reference=out.reference, records=out.records)
    prof = out.records.get("profile")
    if prof is not None:
        result["busy_s"] = prof["busy_s"]
        result["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": [list(t) for t in
                                              prof["ops"][:10]],
                               "idle_gaps": [list(t) for t in
                                             prof["gaps"][:10]]}
    return result
