"""ExperimentConfig, the hook surface every task implements (counterpart of
``egc_tpu.exp.config``; the reference's exptune ``ExperimentConfig``
contract, reference call sites ``experiments/zinc/configs.py:93-186``):
data / model / optimizer / train / val / test / persist_trial /
restore_trial / hyperparams / settings / trial_metric / stoppers.

The training state is the optimizer (the model is passed beside it): no
flax-style ``TrainState``. A config runs on its ``device``, the card
unless it was built for the CPU; ``rng(seed)`` is a ``torch.Generator``
there.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from egc_tpu_torch.exp.hyperparams import HyperParam, default_hparams
from egc_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from egc_tpu_torch.train.optim import (
    PlateauState, make_optimizer, plateau_init, plateau_update, set_lr,
)


@dataclasses.dataclass(frozen=True)
class ExperimentSettings:
    name: str
    final_repeats: int = 10
    final_max_iterations: int = 200
    checkpoint_at_end: bool = True
    checkpoint_freq: int = 0


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    mode: str  # "min" | "max"


@dataclasses.dataclass(frozen=True)
class StopperSpec:
    patience: int
    max_iters: int


@dataclasses.dataclass(frozen=True)
class TrialResources:
    """Per-trial resource request (exptune surface, reference
    zinc/configs.py:106): ``cpus`` for parallel-search workers, ``chips``
    whole cards per trial."""

    cpus: int = 1
    chips: float = 1.0


class ExperimentConfig:
    """Base class; subclasses implement the task-specific hooks and set
    ``device``."""

    synthetic: bool = True   # synthetic data unless --real asks otherwise
    device: torch.device

    # ---- experiment description -----------------------------------------
    def settings(self) -> ExperimentSettings:
        raise NotImplementedError

    def trial_metric(self) -> Metric:
        raise NotImplementedError

    def stoppers(self) -> StopperSpec:
        s = self.settings()
        return StopperSpec(patience=20, max_iters=s.final_max_iterations)

    def hyperparams(self) -> Dict[str, HyperParam]:
        raise NotImplementedError

    def default_hparams(self) -> Dict[str, Any]:
        return default_hparams(self.hyperparams())

    def search_strategy(self):
        """Random search over ``num_samples`` candidates unless a task
        says otherwise (reference zinc/configs.py:108-109)."""
        from egc_tpu_torch.exp.search import RandomSearchStrategy
        return RandomSearchStrategy(getattr(self, "_num_samples", 50))

    def trial_scheduler(self):
        """The search's pruner, or None to run every trial to its stop."""
        return None

    def resource_requirements(self) -> TrialResources:
        return TrialResources(cpus=1, chips=1.0)

    # ---- construction ----------------------------------------------------
    def data(self, hparams: Dict[str, Any]):
        raise NotImplementedError

    def model(self, hparams: Dict[str, Any], *, seed: int = 0):
        """The net, initialised from ``seed``, on ``device``."""
        raise NotImplementedError

    def optimizer(self, model: torch.nn.Module, hparams: Dict[str, Any]):
        """torch Adam(lr, wd) (reference zinc/configs.py:128-129)."""
        return make_optimizer(model.parameters(), hparams["lr"],
                              hparams.get("wd", 0.0))

    def plateau(self, hparams) -> PlateauState:
        metric = self.trial_metric()
        return plateau_init(hparams["lr"], mode=metric.mode, factor=0.5,
                            patience=10, min_lr=1e-5)

    def init_state(self, model, hparams, data, seed: int):
        """The training state of a fresh trial: the model's optimizer."""
        return self.optimizer(model, hparams)

    # ---- one iteration ---------------------------------------------------
    def train(self, model, state, data, rng, iteration: int):
        """-> (state, {"train_loss": ...})"""
        raise NotImplementedError

    def val(self, model, state, data) -> Dict[str, float]:
        raise NotImplementedError

    def test(self, model, state, data) -> Dict[str, float]:
        raise NotImplementedError

    def apply_plateau(self, state, plateau: PlateauState,
                      val_metrics) -> Tuple[Any, PlateauState]:
        """lr_scheduler.step(val_metric) (reference zinc/configs.py:147-151)."""
        metric = self.trial_metric()
        new_plateau = plateau_update(plateau, float(val_metrics[metric.name]))
        if new_plateau.lr != plateau.lr:
            set_lr(state, new_plateau.lr)
        return state, new_plateau

    # ---- persistence -----------------------------------------------------
    def persist_trial(self, ckpt_dir, model, state, plateau, hparams,
                      extra=None):
        save_checkpoint(Path(ckpt_dir), model=model, optimizer=state,
                        plateau=plateau, hparams=hparams, extra=extra)

    def restore_trial(self, ckpt_dir, data=None, seed: int = 0):
        """-> (model, state, plateau, hparams, data) from a trial
        directory."""
        meta = json.loads((Path(ckpt_dir) / "checkpoint.json").read_text())
        hparams = meta.get("hparams", {})
        # data BEFORE model, as in run_trial: PNA's avg_log_deg is a
        # statistic of the data
        if data is None:
            data = self.data(hparams)
        model = self.model(hparams, seed=seed)
        state = self.init_state(model, hparams, data, seed)
        _, plateau, _ = load_checkpoint(Path(ckpt_dir), model=model,
                                        optimizer=state)
        return model, state, plateau, hparams, data

    def final_runs_summaries(self):
        """Summaries applied after the final repeats (reference
        zinc/configs.py:182-186)."""
        from egc_tpu_torch.exp.summaries import (
            TestMetricSummaries, TrialCurvePlotter,
        )
        metric = self.trial_metric()
        return [TrialCurvePlotter(["train_loss", metric.name],
                                  name="curves"),
                TestMetricSummaries()]

    # ---- seeding ---------------------------------------------------------
    def configure_seeds(self, seed: int):
        np.random.seed(seed)
        torch.manual_seed(seed)

    def rng(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)
