"""Hyperparameter search (counterpart of ``egc_tpu.exp.search``): the
ray.tune role, in process.

Reference strategies: ``RandomSearchStrategy(num_samples)`` with
AsyncHyperBand pruning for zinc / cifar / mol / code, ``GridSearchStrategy``
with FIFO for arxiv / mag. The pruner is a successive-halving one (the
core of AsyncHyperBand); trials run one after another on the config's
device. Given the same numpy seed, the strategies give the JAX package's
candidates. Trials across worker processes are ``exp/parallel_search.py``.
"""

from __future__ import annotations

import itertools
import json
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from egc_tpu_torch.exp.config import ExperimentConfig
from egc_tpu_torch.exp.runner import run_trial


class RandomSearchStrategy:
    def __init__(self, num_samples: int):
        self.num_samples = num_samples

    def generate(self, space, rng) -> List[Dict[str, Any]]:
        return [{k: hp.sample(rng) for k, hp in space.items()}
                for _ in range(self.num_samples)]


class GridSearchStrategy:
    """points_per_param: {name: n_points}; unlisted params use defaults."""

    def __init__(self, points_per_param: Dict[str, int]):
        self.points = points_per_param

    def generate(self, space, rng) -> List[Dict[str, Any]]:
        axes = {}
        for k, hp in space.items():
            axes[k] = hp.grid(self.points[k]) if k in self.points \
                else [hp.default()]
        keys = list(axes)
        return [dict(zip(keys, combo))
                for combo in itertools.product(*(axes[k] for k in keys))]


class AsyncHyperBandPruner:
    """Successive-halving pruner (AsyncHyperBandScheduler's core behavior):
    at each rung (grace_period * reduction^k iterations), a trial is pruned
    if its BEST-SO-FAR score falls outside the top 1/reduction of the
    best-so-far scores other trials recorded at that rung (asynchronous:
    the cutoff uses however many trials have reached the rung, as
    ray.tune's AsyncHyperBand does)."""

    def __init__(self, mode: str, grace_period: int = 20,
                 reduction_factor: int = 4, max_t: int = 200):
        self.sign = 1.0 if mode == "min" else -1.0
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        self.reduction = reduction_factor
        self.recorded: Dict[int, List[float]] = {r: [] for r in self.rungs}
        self._trial_best = float("inf")

    def start_trial(self):
        """Reset per-trial state (call before each trial's first report)."""
        self._trial_best = float("inf")

    def __call__(self, iteration: int, score: float) -> bool:
        """Report one (iteration, metric) row; True => prune the trial."""
        self._trial_best = min(self._trial_best, self.sign * score)
        if iteration not in self.recorded:
            return False
        rung = self.recorded[iteration]
        rung.append(self._trial_best)
        if len(rung) < self.reduction:
            return False
        cutoff = np.quantile(rung, 1.0 / self.reduction)
        return bool(self._trial_best > cutoff)


def run_search(
    config: ExperimentConfig,
    exp_dir: Path,
    *,
    strategy=None,
    seed: int = 0,
    use_pruner: bool = True,
    verbose: bool = True,
) -> Dict[str, Any]:
    """Runs the search; returns the best hyperparameters
    (reference main.py:363 run_search contract)."""
    exp_dir = Path(exp_dir)
    exp_dir.mkdir(parents=True, exist_ok=True)
    space = config.hyperparams()
    metric = config.trial_metric()
    # strategy + scheduler come from the config's own hooks (reference
    # exptune surface: config.search_strategy()/trial_scheduler())
    strategy = strategy or config.search_strategy()
    rng = np.random.default_rng(seed)
    candidates = strategy.generate(space, rng)

    pruner = config.trial_scheduler() if use_pruner else None

    results = []
    sign = 1.0 if metric.mode == "min" else -1.0
    best_score, best_hparams = float("inf"), None
    for i, hp in enumerate(candidates):
        if verbose:
            print(f"[search {config.settings().name}] trial {i + 1}/"
                  f"{len(candidates)}")
        report = None
        if pruner is not None:
            pruner.start_trial()

            def report(it, row, _p=pruner):
                return _p(it, float(row[metric.name]))
        res = run_trial(config, hp, seed=seed + i, report=report,
                        verbose=verbose)
        score = sign * res["best_val"]
        results.append({"hparams": hp, "best_val": res["best_val"],
                        "best_iter": res["best_iter"]})
        if score < best_score:
            best_score, best_hparams = score, hp
    (exp_dir / "search_results.json").write_text(
        json.dumps({"results": results, "best": best_hparams},
                   indent=2, default=float))
    return best_hparams
