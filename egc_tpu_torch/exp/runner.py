"""Trial runner (counterpart of ``egc_tpu.exp.runner``): the
exptune / ray.tune role, without Ray.

Reference flow (``main.py:343-372``): per trial, configure_seeds -> data
-> model -> optimizer -> loop[train -> val -> lr_scheduler.step ->
early-stop check -> persist], then the final test. Exposed as
``run_trial`` plus the ``check_config`` (smoke) and ``train_final_models``
(N seeded repeats + summaries) entry points. The history rows,
``result.json``, ``history.json`` and ``final_summary.json`` carry the
JAX package's keys; a trial directory holds ``checkpoint.pt`` and
``checkpoint.json`` (``train/checkpoint.py``).

An iteration's five phases are spans (``utils.profiling.span``):
``egc.trial.train``, ``egc.trial.val``, ``egc.trial.plateau``,
``egc.trial.persist`` (when a checkpoint is written) and
``egc.trial.report`` (the ``report`` callback).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from egc_tpu_torch.exp.config import ExperimentConfig
from egc_tpu_torch.exp.summaries import TestMetricSummaries, TrialCurvePlotter
from egc_tpu_torch.train.checkpoint import load_checkpoint
from egc_tpu_torch.train.state import num_params
from egc_tpu_torch.utils.profiling import span


def run_trial(
    config: ExperimentConfig,
    hparams: Dict[str, Any],
    *,
    seed: int = 0,
    max_iterations: Optional[int] = None,
    patience: Optional[int] = None,
    trial_dir: Optional[Path] = None,
    log_every: int = 1,
    report=None,           # callable(iteration, metrics) -> bool (prune?)
    verbose: bool = True,
    resume: bool = False,  # continue from trial_dir's checkpoint (preemption
    #                        recovery, SURVEY §5)
) -> Dict[str, Any]:
    """Train one trial to completion/early-stop; returns a result dict."""
    settings = config.settings()
    stopper = config.stoppers()
    max_iters = max_iterations or stopper.max_iters
    patience = patience if patience is not None else stopper.patience
    metric = config.trial_metric()
    sign = 1.0 if metric.mode == "min" else -1.0

    config.configure_seeds(seed)
    data = config.data(hparams)
    model = config.model(hparams, seed=seed)
    state = config.init_state(model, hparams, data, seed)
    plateau = config.plateau(hparams)
    rng = config.rng(seed)

    start_iter = 0
    if resume and trial_dir is not None and \
            (Path(trial_dir) / "checkpoint.pt").exists():
        # the optimizer's lr follows the restored plateau
        _, saved_plateau, _ = load_checkpoint(Path(trial_dir), model=model,
                                              optimizer=state)
        if saved_plateau is not None:
            plateau = saved_plateau
        meta = json.loads(
            (Path(trial_dir) / "checkpoint.json").read_text())
        start_iter = int(meta.get("extra", {}).get("iteration", -1)) + 1
        if verbose:
            print(f"[{settings.name}] resuming from iteration {start_iter}")

    if verbose:
        print(f"[{settings.name}] trial seed={seed} params="
              f"{num_params(model):,} hparams={hparams}")

    best = float("inf")
    best_iter = start_iter - 1
    history: List[Dict[str, float]] = []
    t0 = time.time()
    for it in range(start_iter, max_iters):
        with span("egc.trial.train"):
            state, train_metrics = config.train(model, state, data, rng, it)
        with span("egc.trial.val"):
            val_metrics = config.val(model, state, data)
        with span("egc.trial.plateau"):
            state, plateau = config.apply_plateau(state, plateau,
                                                  val_metrics)
        row = {"iteration": it, **train_metrics, **val_metrics,
               "lr": plateau.lr, "time_s": time.time() - t0}
        history.append(row)
        if verbose and it % log_every == 0:
            print("  " + " ".join(f"{k}={v:.5g}" for k, v in row.items()))

        score = sign * float(val_metrics[metric.name])
        improved = score < best
        if improved:
            best, best_iter = score, it
        periodic = settings.checkpoint_freq and \
            (it + 1) % settings.checkpoint_freq == 0
        if trial_dir is not None and (improved or periodic):
            with span("egc.trial.persist"):
                config.persist_trial(trial_dir, model, state, plateau,
                                     hparams, extra={"iteration": it})
        if report is not None:
            with span("egc.trial.report"):
                stop = report(it, row)
            if stop:
                break
        if it - best_iter >= patience:   # PatientStopper semantics
            break

    test_metrics = config.test(model, state, data)
    if trial_dir is not None and settings.checkpoint_at_end:
        config.persist_trial(trial_dir, model, state, plateau, hparams,
                             extra={"iteration": max_iters - 1})
        (Path(trial_dir) / "history.json").write_text(json.dumps(history))
        (Path(trial_dir) / "result.json").write_text(json.dumps(
            {"best_val": sign * best, "best_iter": best_iter,
             "test": test_metrics, "hparams": hparams}, default=float))
    return {
        "best_val": sign * best,
        "best_iter": best_iter,
        "history": history,
        "test": test_metrics,
        "state": state,
        "model": model,
        "data": data,
    }


def check_config(config: ExperimentConfig, epochs: int = 3,
                 hparams: Optional[Dict[str, Any]] = None,
                 verbose: bool = True) -> Dict[str, Any]:
    """Smoke-run (`--check`, reference main.py:343-345)."""
    hp = dict(config.default_hparams())
    if hparams:
        hp.update(hparams)
    return run_trial(config, hp, max_iterations=epochs, patience=epochs + 1,
                     verbose=verbose)


def train_final_models(
    config: ExperimentConfig,
    hparams: Dict[str, Any],
    exp_dir: Path,
    *,
    override_repeats: Optional[int] = None,
    seed_base: int = 0,
    verbose: bool = True,
) -> Dict[str, Any]:
    """N seeded final runs + test-metric summary (reference main.py:366-372
    + exptune TestMetricSummaries)."""
    settings = config.settings()
    repeats = override_repeats or settings.final_repeats
    exp_dir = Path(exp_dir)
    results = []
    histories = []
    for rep in range(repeats):
        trial_dir = exp_dir / "final" / f"run_{rep}"
        trial_dir.mkdir(parents=True, exist_ok=True)
        res = run_trial(config, hparams, seed=seed_base + rep,
                        trial_dir=trial_dir, verbose=verbose)
        results.append({k: res[k] for k in ("best_val", "best_iter", "test")})
        histories.append(res["history"])

    summary: Dict[str, Any] = {"hparams": hparams, "repeats": repeats}
    test_keys = results[0]["test"].keys()
    for k in test_keys:
        vals = np.array([r["test"][k] for r in results], dtype=np.float64)
        summary[k] = {"mean": float(vals.mean()),
                      "std": float(vals.std(ddof=1)) if len(vals) > 1 else 0.0,
                      "values": vals.tolist()}
    (exp_dir / "final_summary.json").write_text(
        json.dumps(summary, indent=2, default=float))
    # curve plots + test-metric summaries (exptune-style hooks)
    for summarizer in config.final_runs_summaries():
        if isinstance(summarizer, TrialCurvePlotter):
            summarizer(histories, exp_dir)
        elif isinstance(summarizer, TestMetricSummaries):
            summarizer([r["test"] for r in results], exp_dir)
    if verbose:
        print(json.dumps({k: v for k, v in summary.items()
                          if k != "hparams"}, indent=2, default=float))
    return summary
