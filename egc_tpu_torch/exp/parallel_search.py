"""Trial parallelism across worker processes, the Ray role (counterpart of
``egc_tpu.exp.parallel_search``).

The reference packs fractional-GPU trials with ray.tune
(``zinc/configs.py:106``) and prunes them mid-flight with
AsyncHyperBandScheduler while they run side by side
(``zinc/configs.py:111-115``). Here N spawned worker processes run the
candidates' trials, on ``worker_device``: by default the card, which the
workers share as the reference's Ray trials share a GPU (the JAX package
puts its workers on the CPU only because a TPU chip cannot be shared).
``resources.cpus`` caps the workers at the host's cores.

Cross-worker pruning: rung results are shared through a
``multiprocessing.Manager`` (``SharedRungs``); every worker reports its
best-so-far val metric at each rung and prunes itself against the
quantile of what the trials have recorded there, the decision rule of
the in-process ``AsyncHyperBandPruner`` (``exp/search.py``), so with one
worker the decisions equal the sequential search's.

Workers are spawned (never forked after CUDA is initialised); each
rebuilds the config from a picklable spec, ``(module, qualname, args,
kwargs)`` of a factory that takes ``device=`` and returns a fresh
``ExperimentConfig``. The results, one per candidate, go to
``search_results.json`` in the JAX package's shape.
"""

from __future__ import annotations

import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class SharedRungs:
    """Manager-backed rung table: {rung_iteration: [best-so-far scores]}.

    Picklable (proxies travel to spawned workers). The quantile cutoff is
    computed under the lock against a snapshot, exactly like the
    sequential pruner's local list."""

    def __init__(self, manager, rungs: List[int], reduction: int,
                 sign: float):
        self.rungs = {int(r): manager.list() for r in rungs}
        self.lock = manager.Lock()
        self.reduction = int(reduction)
        self.sign = float(sign)

    def report(self, iteration: int, best_so_far: float) -> bool:
        """Record a trial's best-so-far at a rung; True => prune."""
        lst = self.rungs.get(int(iteration))
        if lst is None:
            return False
        with self.lock:
            lst.append(float(best_so_far))
            vals = list(lst)
        if len(vals) < self.reduction:
            return False
        cutoff = float(np.quantile(vals, 1.0 / self.reduction))
        return best_so_far > cutoff


def make_shared_rungs(manager, scheduler, metric_mode: str
                      ) -> Optional[SharedRungs]:
    """Build SharedRungs from a config's trial_scheduler() (an
    AsyncHyperBandPruner or None/FIFO-like object without rungs)."""
    rungs = getattr(scheduler, "rungs", None)
    if not rungs:
        return None
    if isinstance(rungs, dict):
        rungs = list(rungs)
    sign = getattr(scheduler, "sign", 1.0 if metric_mode == "min" else -1.0)
    reduction = getattr(scheduler, "reduction", 4)
    return SharedRungs(manager, list(rungs), reduction, sign)


def _worker(spec: Tuple[str, str, tuple, dict], hparams: Dict[str, Any],
            seed: int, max_iterations: Optional[int], device: Optional[str],
            metric_name: str, shared: Optional[SharedRungs]):
    import importlib

    import torch

    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    module, qualname, args, kwargs = spec
    factory = importlib.import_module(module)
    for part in qualname.split("."):
        factory = getattr(factory, part)
    config = factory(*args, **kwargs, device=device)

    from egc_tpu_torch.exp.runner import run_trial

    report = None
    pruned = {"flag": False}
    if shared is not None:
        state = {"best": float("inf")}

        def report(it, row):
            state["best"] = min(state["best"],
                                shared.sign * float(row[metric_name]))
            if shared.report(it, state["best"]):
                pruned["flag"] = True
                return True
            return False

    res = run_trial(config, hparams, seed=seed,
                    max_iterations=max_iterations, report=report,
                    verbose=False)
    return {"hparams": hparams, "best_val": res["best_val"],
            "best_iter": res["best_iter"], "test": res["test"],
            "pruned": pruned["flag"]}


def run_search_parallel(
    config_spec: Tuple[str, str, tuple, dict],
    candidates: List[Dict[str, Any]],
    *,
    metric_mode: str,
    metric_name: str,
    num_workers: int = 2,
    exp_dir: Optional[Path] = None,
    seed: int = 0,
    max_iterations: Optional[int] = None,
    worker_device: Optional[str] = None,
    resources=None,
    scheduler=None,
) -> Dict[str, Any]:
    """Run the candidates' trials on ``num_workers`` spawned workers and
    return the best hyperparameters; candidate i's trial has seed ``seed +
    i``, as in the sequential search.

    ``config_spec`` = (module, qualname, args, kwargs) of a factory,
    importable in the workers, called as ``factory(*args, **kwargs,
    device=worker_device)`` (None: the card). ``resources``: the config's
    ``resource_requirements()``; the workers are capped so that ``workers
    * resources.cpus`` does not oversubscribe the host. ``scheduler``: the
    config's ``trial_scheduler()``; when it has rungs, the workers prune
    against a shared rung table (``SharedRungs``). A worker's failure
    raises here."""
    if resources is not None and getattr(resources, "cpus", 0):
        cap = max(1, (os.cpu_count() or 1) // max(int(resources.cpus), 1))
        num_workers = max(1, min(num_workers, cap))
    sign = 1.0 if metric_mode == "min" else -1.0
    device = None if worker_device is None else str(worker_device)
    results = []
    ctx = multiprocessing.get_context("spawn")
    # a Manager is a whole server process: only when there are rungs
    manager = ctx.Manager() if getattr(scheduler, "rungs", None) else None
    shared = make_shared_rungs(manager, scheduler, metric_mode) \
        if manager is not None else None
    try:
        with ProcessPoolExecutor(max_workers=num_workers,
                                 mp_context=ctx) as pool:
            futures = [
                pool.submit(_worker, config_spec, hp, seed + i,
                            max_iterations, device, metric_name, shared)
                for i, hp in enumerate(candidates)
            ]
            for fut in futures:
                results.append(fut.result())
    finally:
        if manager is not None:
            manager.shutdown()

    best = min(results, key=lambda r: sign * r["best_val"])
    if exp_dir is not None:
        Path(exp_dir).mkdir(parents=True, exist_ok=True)
        (Path(exp_dir) / "search_results.json").write_text(
            json.dumps({"results": results, "best": best["hparams"]},
                       indent=2, default=float))
    return best["hparams"]
