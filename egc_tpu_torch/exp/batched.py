"""Batched graph-level training (counterpart of ``egc_tpu.exp.batched``):
``BatchedGraphConfig`` on the ``ExperimentConfig`` surface, the zinc,
cifar, molhiv and ogbg-code2 recipes, and the bare loop ``train_batched``.

The recipes are the JAX package's (reference ``experiments/{zinc,cifar,
mol,code}/configs.py``):

- every split a ``GraphLoader`` of padded batches of ``batch_size``
  graphs on one budget, the train split shuffled, each split from its own
  seed (crc32 of its name);
- Adam (lr, wd) and ReduceLROnPlateau on the trial metric (factor 0.5,
  patience 10; code2: factor 0.2 on val F1), an AsyncHyperBand pruner
  (grace 20; molhiv 30, code2 15);
- one iteration is an epoch over the train split; its dropout draws from
  a generator folded from the trial's and the iteration (``train/loop``);
- zinc: ``ZincNet``, the masked L1 loss, val MAE (stopper patience 20);
  cifar: ``CifarNet`` with a tuned ``dropout`` before each conv, masked
  cross-entropy, accuracy; molhiv: ``HIVNet`` with the ``dropout``
  hyperparameter on its input, BCE-with-logits over the labelled graphs
  (label >= 0), ROC-AUC; code2: ``CodeNet``, the mean of the 5 positions'
  cross-entropies, then the F1 of the sequences cut at the first EOS
  (``vocab_size + 1``).

``vocab_size`` and the node attributes of code2 follow the JAX package:
120 and 500 on the synthetic data, 5000 and 10,030 (10,003 with
``use_old_code_dataset``) on the real one; both can be set. The synthetic
sets are ``data/synthetic``'s (seed 0); ``synthetic = False`` reads the
real files under ``$DATASET_LOC`` (``data/ondisk``).

A config runs on its ``device`` (the card unless it was built for the
CPU); ``data`` and ``model`` also take a ``device`` for one call.
``train_batched`` runs on the config's device unless the caller passes
another.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from egc_tpu_torch.data import synthetic as synth
from egc_tpu_torch.data.loaders import GraphLoader, padding_budget
from egc_tpu_torch.device import DeviceLike, resolve_device
from egc_tpu_torch.exp.config import (
    ExperimentConfig, ExperimentSettings, Metric, StopperSpec,
)
from egc_tpu_torch.exp.hyperparams import (
    ChoiceHyperParam, LogUniformHyperParam, UniformHyperParam,
)
from egc_tpu_torch.models.nets import (
    CifarNet, CodeNet, ConvSpec, HIVNet, ZincNet,
)
from egc_tpu_torch.train.loop import (
    StepClock, eval_epoch, fold_in, train_epoch,
)
from egc_tpu_torch.train.metrics import roc_auc, sequence_f1
from egc_tpu_torch.train.optim import (
    PlateauState, plateau_init, plateau_update, set_lr,
)

PREFETCH_CUDA = 4    # host threads building batches ahead of the card


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(values.dtype)
    return (values * m).sum() / torch.clamp(m.sum(), min=1.0)


class BatchedGraphConfig(ExperimentConfig):
    """The shared machinery of the padded-batch graph-level tasks; a task
    sets ``load_graphs``, ``net``, ``loss_fn`` and ``eval_metrics``."""

    def __init__(self, model_kind: str, hidden: int, *, heads: int = 8,
                 bases: int = 4, softmax: bool = False, sigmoid: bool = False,
                 hardtanh: bool = False,
                 aggrs: Optional[Sequence[str]] = None, num_layers: int = 4,
                 readout: str = "mean", avg_log_deg: float = 1.0,
                 synthetic: bool = True, device: DeviceLike = None):
        self.model_kind = model_kind
        self.hidden = hidden
        self.conv = ConvSpec(
            kind=model_kind, heads=heads, bases=bases, softmax=softmax,
            sigmoid=sigmoid, hardtanh=hardtanh,
            aggrs=tuple(aggrs) if aggrs else None, avg_log_deg=avg_log_deg)
        self.num_layers = num_layers
        self.readout = readout
        self.synthetic = synthetic
        self._device = device

    @property
    def device(self) -> torch.device:
        return resolve_device(self._device)

    # -- hooks of the tasks ------------------------------------------------
    def load_graphs(self) -> Dict[str, list]:
        raise NotImplementedError

    def net(self, hparams: Dict[str, Any],
            generator: torch.Generator) -> torch.nn.Module:
        raise NotImplementedError

    def loss_fn(self, out: torch.Tensor, y: torch.Tensor,
                graph) -> torch.Tensor:
        raise NotImplementedError

    def eval_metrics(self, collected, split: str) -> Dict[str, float]:
        raise NotImplementedError

    # -- the shared implementation ----------------------------------------
    def hyperparams(self):
        # reference zinc/configs.py:194-199 (the same space for each task)
        return {
            "lr": LogUniformHyperParam(0.0001, 0.01, default=0.001),
            "batch_size": ChoiceHyperParam([64, 128], default=128),
            "wd": LogUniformHyperParam(0.0001, 0.001, default=0.0005),
        }

    def trial_metric(self) -> Metric:
        return Metric("val_loss", "min")

    def _ahb(self, grace_period: int, max_t: int):
        from egc_tpu_torch.exp.search import AsyncHyperBandPruner
        return AsyncHyperBandPruner(self.trial_metric().mode,
                                    grace_period=grace_period, max_t=max_t)

    def trial_scheduler(self):
        # reference zinc / cifar configs: AsyncHyperBand, grace_period 20
        return self._ahb(20, self.settings().final_max_iterations)

    def data(self, hparams: Dict[str, Any],
             device: DeviceLike = None) -> Dict[str, GraphLoader]:
        """A loader per split on one budget; the train split shuffles."""
        dev = self.device if device is None else resolve_device(device)
        splits = self.load_graphs()
        bs = int(hparams.get("batch_size", 128))
        budget = padding_budget(splits["train"] + splits["val"]
                                + splits["test"], bs)
        # crc32, not hash(): string hashes differ between processes
        return {name: GraphLoader(
            graphs, bs, shuffle=(name == "train"), budget=budget,
            prefetch=PREFETCH_CUDA if dev.type == "cuda" else 0,
            seed=zlib.crc32(name.encode()) % (2 ** 31), device=dev)
            for name, graphs in splits.items()}

    def model(self, hparams: Dict[str, Any], *, seed: int = 0,
              device: DeviceLike = None) -> torch.nn.Module:
        """The net, initialised from ``seed`` on the CPU and moved to the
        device (so every device starts from the same weights)."""
        dev = self.device if device is None else resolve_device(device)
        return self.net(hparams, torch.Generator().manual_seed(seed)).to(dev)

    def train(self, model, state, data, rng, iteration: int):
        losses = train_epoch(model, state, self.loss_fn, data["train"],
                             generator=fold_in(rng, iteration))
        return state, {"train_loss": float(np.mean(losses))}

    def _evaluate(self, model, data, split: str) -> Dict[str, float]:
        return self.eval_metrics(eval_epoch(model, data[split]), split)

    def val(self, model, state, data):
        return self._evaluate(model, data, "val")

    def test(self, model, state, data):
        return self._evaluate(model, data, "test")


class ZincConfig(BatchedGraphConfig):
    """Graph regression, L1 / MAE (reference experiments/zinc/configs.py)."""

    name = "zinc"

    def settings(self):
        return ExperimentSettings("zinc", final_repeats=10,
                                  final_max_iterations=200)

    def stoppers(self):
        return StopperSpec(patience=20, max_iters=200)

    def load_graphs(self):
        if not self.synthetic:
            from egc_tpu_torch.data.ondisk import load_zinc
            return load_zinc()
        return synth.synthetic_zinc()

    def net(self, hparams, generator):
        return ZincNet(self.conv, self.hidden, num_layers=self.num_layers,
                       readout=self.readout, generator=generator)

    def loss_fn(self, out, y, graph):
        err = (out.reshape(-1) - y.reshape(-1).to(out.dtype)).abs()
        return masked_mean(err, graph.graph_mask)

    def eval_metrics(self, collected, split):
        errs, cnt = 0.0, 0.0
        for out, y, mask in collected:
            e = np.abs(np.asarray(out).reshape(-1) - y.reshape(-1))
            errs += float((e * mask).sum())
            cnt += float(mask.sum())
        return {f"{split}_loss": errs / max(cnt, 1.0)}


class CifarConfig(BatchedGraphConfig):
    """10-class graph classification (reference experiments/cifar/
    configs.py), with a tuned dropout before each conv."""

    name = "cifar"

    def __init__(self, *args, dropout: float = 0.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.dropout = dropout

    def settings(self):
        return ExperimentSettings("cifar", final_repeats=10,
                                  final_max_iterations=200)

    def load_graphs(self):
        if not self.synthetic:
            from egc_tpu_torch.data.ondisk import load_cifar10_superpixels
            return load_cifar10_superpixels()
        return synth.synthetic_cifar()

    def net(self, hparams, generator):
        return CifarNet(self.conv, self.hidden, num_layers=self.num_layers,
                        dropout=float(hparams.get("dropout", self.dropout)),
                        readout=self.readout, generator=generator)

    def hyperparams(self):
        hp = super().hyperparams()
        # reference cifar/configs.py:145
        hp["dropout"] = UniformHyperParam(0.0, 0.5, default=0.0)
        return hp

    def loss_fn(self, out, y, graph):
        ce = F.cross_entropy(out, y.reshape(-1).long(), reduction="none")
        return masked_mean(ce, graph.graph_mask)

    def eval_metrics(self, collected, split):
        ce_sum, cnt, correct = 0.0, 0.0, 0.0
        for out, y, mask in collected:
            out = np.asarray(out)
            y = y.reshape(-1)
            top = out.max(-1, keepdims=True)
            logp = out - np.log(np.exp(out - top).sum(-1, keepdims=True)) \
                - top
            ce = -np.take_along_axis(logp, y[:, None].astype(np.int64),
                                     axis=1).reshape(-1)
            ce_sum += float((ce * mask).sum())
            correct += float(((out.argmax(-1) == y) * mask).sum())
            cnt += float(mask.sum())
        return {f"{split}_loss": ce_sum / max(cnt, 1.0),
                f"{split}_metric": correct / max(cnt, 1.0)}


class MolConfig(BatchedGraphConfig):
    """ogbg-molhiv: BCE-with-logits and ROC-AUC (reference
    experiments/mol/configs.py:64-107)."""

    name = "hiv"

    def settings(self):
        return ExperimentSettings("hiv", final_repeats=10,
                                  final_max_iterations=100)

    def trial_metric(self):
        return Metric("val_metric", "max")

    def search_strategy(self):
        # reference mol/configs.py:125-126
        from egc_tpu_torch.exp.search import GridSearchStrategy
        return GridSearchStrategy({"lr": 5, "wd": 2, "dropout": 2})

    def trial_scheduler(self):
        # reference mol/configs.py:128-131: grace_period 30
        return self._ahb(30, self.settings().final_max_iterations)

    def hyperparams(self):
        # reference mol/configs.py:162-167
        return {
            "lr": LogUniformHyperParam(0.0001, 0.01, default=0.001),
            "batch_size": ChoiceHyperParam([32, 64], default=32),
            "wd": LogUniformHyperParam(0.0001, 0.001, default=0.0005),
            "dropout": UniformHyperParam(0.0, 0.2, default=0.2),
        }

    def load_graphs(self):
        if not self.synthetic:
            from egc_tpu_torch.data.ondisk import load_ogbg_molhiv
            return load_ogbg_molhiv()
        return synth.synthetic_molhiv()

    def net(self, hparams, generator):
        # the dropout hparam is the input dropout (reference
        # mol/configs.py:249)
        return HIVNet(self.conv, self.hidden, num_layers=self.num_layers,
                      in_feat_drop=float(hparams.get("dropout", 0.2)),
                      readout=self.readout, generator=generator)

    def loss_fn(self, out, y, graph):
        y = y.reshape(-1).to(out.dtype)
        # a label < 0 is missing (OGB; the reference masks with y == y)
        labeled = (y >= 0) & graph.graph_mask
        bce = F.binary_cross_entropy_with_logits(out.reshape(-1), y,
                                                 reduction="none")
        return masked_mean(bce, labeled)

    def eval_metrics(self, collected, split):
        scores, labels = [], []
        for out, y, mask in collected:
            m = mask.astype(bool)
            scores.append(np.asarray(out).reshape(-1)[m])
            labels.append(y.reshape(-1)[m])
        return {f"{split}_metric": roc_auc(np.concatenate(scores),
                                           np.concatenate(labels))}


class CodeConfig(BatchedGraphConfig):
    """ogbg-code2: 5-token decode, mean cross-entropy, sequence F1
    (reference experiments/code/configs.py:55-106)."""

    name = "code"

    def __init__(self, *args, vocab_size: Optional[int] = None,
                 num_nodeattributes: Optional[int] = None,
                 use_old_code_dataset: bool = False, num_graphs: int = 900,
                 **kwargs):
        """``num_graphs``: the synthetic dataset's size (``synthetic_code``'s
        default, 900)."""
        super().__init__(*args, **kwargs)
        self._vocab_size = vocab_size
        self._num_nodeattributes = num_nodeattributes
        # old ogbg-code: 10,003 node attributes, code2 10,030 (reference
        # code/utils.py:14-15)
        self.use_old_code_dataset = use_old_code_dataset
        self.num_graphs = num_graphs

    @property
    def vocab_size(self) -> int:
        if self._vocab_size is not None:
            return self._vocab_size
        return 120 if self.synthetic else 5000

    @property
    def num_nodeattributes(self) -> int:
        if self._num_nodeattributes is not None:
            return self._num_nodeattributes
        if self.synthetic:
            return 500
        return 10003 if self.use_old_code_dataset else 10030

    def settings(self):
        # ITERS=25 (reference code/configs.py:28)
        return ExperimentSettings("code", final_repeats=10,
                                  final_max_iterations=25)

    def stoppers(self):
        # PATIENCE=5 (reference code/configs.py:29,144-146)
        return StopperSpec(patience=5, max_iters=25)

    def trial_metric(self):
        return Metric("val_metric", "max")

    def search_strategy(self):
        # reference code/configs.py:128-129
        from egc_tpu_torch.exp.search import GridSearchStrategy
        return GridSearchStrategy({"lr": 6})

    def trial_scheduler(self):
        # reference code/configs.py:131-135: grace_period 15
        return self._ahb(15, 25)

    def hyperparams(self):
        # lr only; the batch size is fixed at 128 (reference
        # code/configs.py:160-163,141)
        return {"lr": LogUniformHyperParam(0.0001, 0.01, default=0.001)}

    def plateau(self, hparams) -> PlateauState:
        # reference code/configs.py:155-157
        return plateau_init(hparams["lr"], mode="max", factor=0.2,
                            patience=10, min_lr=1e-5)

    def load_graphs(self) -> Dict[str, list]:
        if not self.synthetic:
            from egc_tpu_torch.data.ondisk import load_ogbg_code2
            d = load_ogbg_code2(num_vocab=self.vocab_size)
            self.idx2vocab = d["idx2vocab"]
            return d["splits"]
        return synth.synthetic_code(
            num_graphs=self.num_graphs, vocab_size=self.vocab_size,
            num_attrs=self.num_nodeattributes)

    def net(self, hparams, generator):
        return CodeNet(self.conv, self.hidden, num_layers=self.num_layers,
                       vocab_size=self.vocab_size,
                       num_nodeattributes=self.num_nodeattributes,
                       generator=generator)

    def loss_fn(self, out: torch.Tensor, y: torch.Tensor,
                graph) -> torch.Tensor:
        """out [G, S, V+2], y [G, S]: the mean over the S positions'
        cross-entropies, averaged over the real graphs."""
        ce = F.cross_entropy(out.reshape(-1, out.shape[-1]),
                             y.reshape(-1).long(), reduction="none")
        return masked_mean(ce.view(y.shape).mean(-1), graph.graph_mask)

    def eval_metrics(self, collected, split: str) -> Dict[str, float]:
        preds, refs = [], []
        eos = self.vocab_size + 1

        def cut(seq):   # at the FIRST __EOS__ (reference code/utils.py)
            out = []
            for t in seq:
                if t == eos:
                    break
                out.append(int(t))
            return out

        for out, y, mask in collected:
            tok = np.asarray(out).argmax(-1)        # [G, S]
            for i in np.where(mask)[0]:
                preds.append(cut(tok[i]))
                refs.append(cut(y[i]))
        return {f"{split}_metric": sequence_f1(preds, refs)}


@dataclasses.dataclass
class BatchedRun:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    plateau: PlateauState
    history: List[Dict[str, float]]    # one row per epoch (epochs=)
    step_losses: List[float]
    step_seconds: List[float]
    data: Dict[str, GraphLoader]


def evaluate(config: BatchedGraphConfig, model: torch.nn.Module,
             loader: GraphLoader, split: str) -> Dict[str, float]:
    return config.eval_metrics(eval_epoch(model, loader), split)


def train_batched(config: BatchedGraphConfig, hparams: Dict[str, Any], *,
                  epochs: Optional[int] = None, steps: Optional[int] = None,
                  seed: int = 0, device: DeviceLike = None) -> BatchedRun:
    """Train ``config``'s net with ``hparams`` through its hooks (``data``,
    ``model``, ``init_state``, ``plateau``; ``batch_size`` 128 unless
    given), on ``device`` (default: the config's).

    ``epochs``: that many epochs, each a pass over the shuffled train split,
    then a val pass whose trial metric steps the plateau schedule (the
    runner's loop without its early stop and checkpoints). ``steps``: that
    many training steps, across epochs, and no evaluation. Epoch ``i``'s
    dropout draws from ``fold_in(generator of seed, i)``. The run keeps
    the loaders it used (``BatchedRun.data``). Each step's time comes from
    marks that do not hold the host (``StepClock``); losses are read once
    per epoch."""
    if (epochs is None) == (steps is None):
        raise ValueError("give exactly one of epochs and steps")
    dev = config.device if device is None else resolve_device(device)
    data = config.data(hparams, dev)
    model = config.model(hparams, seed=seed, device=dev)
    optimizer = config.init_state(model, hparams, data, seed)
    plateau = config.plateau(hparams)
    metric = config.trial_metric().name
    rng = torch.Generator(device=dev).manual_seed(seed)
    clock = StepClock(dev)
    history, step_losses = [], []
    clock.start()
    for it in range(epochs if epochs is not None else steps):
        left = None if steps is None else steps - len(step_losses)
        if left == 0:
            break
        losses = train_epoch(model, optimizer, config.loss_fn,
                             data["train"], steps=left, clock=clock,
                             generator=fold_in(rng, it))
        if not len(losses):
            raise ValueError("the train split gives no batch")
        step_losses += losses.tolist()
        if epochs is not None:
            val = evaluate(config, model, data["val"], "val")
            plateau = plateau_update(plateau, val[metric])
            set_lr(optimizer, plateau.lr)
            history.append({"iteration": it,
                            "train_loss": float(np.mean(losses)), **val,
                            "lr": plateau.lr})
            clock.start()    # the val pass is no step
    if not np.all(np.isfinite(step_losses)):
        raise FloatingPointError(f"non-finite training loss: {step_losses}")
    return BatchedRun(model, optimizer, plateau, history, step_losses,
                      clock.seconds(), data)
