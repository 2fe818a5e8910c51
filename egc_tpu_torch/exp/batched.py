"""Batched graph-level training (counterpart of ``egc_tpu.exp.batched``):
the ogbg-code2 recipe, ``CodeConfig``, and its entry point
``train_batched``.

``CodeConfig`` is the JAX ``CodeConfig`` recipe (``egc_tpu/exp/batched.py``
``BatchedGraphConfig`` and ``CodeConfig``; reference
``experiments/code/configs.py``), without the experiment-search surface:

- ``CodeNet``: ASTNodeEncoder, ``num_layers`` x [conv, masked BN, ReLU,
  residual], a mean pool and 5 token heads of width V + 2;
- padded batches of ``batch_size`` graphs (128) from ``GraphLoader``, the
  train split shuffled, every split on one budget;
- Adam (lr from ``hparams``, weight decay ``hparams.get("wd", 0)``, 0 for
  code2) and ReduceLROnPlateau on val F1 (mode max, factor 0.2, patience
  10, min_lr 1e-5);
- loss: the cross-entropy of each of the 5 positions, their mean per
  graph, then the mean over the batch's real graphs (``graph_mask``);
- evaluation: the argmax per position, cut at the first EOS
  (``vocab_size + 1``), then ``sequence_f1``.

``vocab_size`` and ``num_nodeattributes`` follow the JAX package: 120 and
500 on the synthetic data, 5000 and 10030 on the real one; both can be
set. The synthetic data is ``synthetic_code(num_graphs, vocab_size=...,
num_attrs=num_nodeattributes)`` (seed 0); the real ogbg-code2 reader is
not ported yet (ROADMAP A12).

``train_batched`` runs on the card unless the caller passes
``device="cpu"``; without a card it raises.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from egc_tpu_torch.data import synthetic
from egc_tpu_torch.data.loaders import GraphLoader, padding_budget
from egc_tpu_torch.device import DeviceLike, resolve_device
from egc_tpu_torch.models.nets import CodeNet, ConvSpec
from egc_tpu_torch.train.loop import (
    StepClock, eval_epoch, train_epoch,
)
from egc_tpu_torch.train.metrics import sequence_f1
from egc_tpu_torch.train.optim import (
    PlateauState, make_optimizer, plateau_init, plateau_update, set_lr,
)

PREFETCH_CUDA = 4    # host threads building batches ahead of the card


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(values.dtype)
    return (values * m).sum() / torch.clamp(m.sum(), min=1.0)


class CodeConfig:
    """ogbg-code2: 5-token decode, mean cross-entropy, sequence F1."""

    name = "code"

    def __init__(self, model_kind: str, hidden: int, *, heads: int = 8,
                 num_layers: int = 4, synthetic: bool = True,
                 vocab_size: Optional[int] = None,
                 num_nodeattributes: Optional[int] = None,
                 num_graphs: int = 900):
        """``model_kind`` "gat" or "gatv2"; ``num_graphs``: the synthetic
        dataset's size (``synthetic_code``'s default, 900)."""
        self.conv = ConvSpec(kind=model_kind, heads=heads)
        self.hidden = hidden
        self.num_layers = num_layers
        self.synthetic = synthetic
        self.vocab_size = vocab_size if vocab_size is not None else \
            (120 if synthetic else 5000)
        self.num_nodeattributes = num_nodeattributes \
            if num_nodeattributes is not None else \
            (500 if synthetic else 10030)
        self.num_graphs = num_graphs

    def load_graphs(self) -> Dict[str, list]:
        if not self.synthetic:
            raise NotImplementedError(
                "the on-disk ogbg-code2 reader is not ported to "
                "egc_tpu_torch yet: ROADMAP.md item A12")
        return synthetic.synthetic_code(
            num_graphs=self.num_graphs, vocab_size=self.vocab_size,
            num_attrs=self.num_nodeattributes)

    def data(self, hparams: Dict[str, Any],
             device: DeviceLike = None) -> Dict[str, GraphLoader]:
        """A loader per split on one budget; the train split shuffles, each
        split from its own seed (crc32 of its name, as the JAX package)."""
        dev = resolve_device(device)
        splits = self.load_graphs()
        bs = int(hparams.get("batch_size", 128))
        budget = padding_budget(splits["train"] + splits["val"]
                                + splits["test"], bs)
        return {name: GraphLoader(
            graphs, bs, shuffle=(name == "train"), budget=budget,
            prefetch=PREFETCH_CUDA if dev.type == "cuda" else 0,
            seed=zlib.crc32(name.encode()) % (2 ** 31), device=dev)
            for name, graphs in splits.items()}

    def model(self, hparams: Dict[str, Any], *, seed: int = 0,
              device: DeviceLike = None) -> CodeNet:
        """The net, initialised from ``seed`` on the CPU and moved to
        ``device`` (so every device starts from the same weights)."""
        net = CodeNet(self.conv, self.hidden, num_layers=self.num_layers,
                      vocab_size=self.vocab_size,
                      num_nodeattributes=self.num_nodeattributes,
                      generator=torch.Generator().manual_seed(seed))
        return net.to(resolve_device(device))

    def optimizer(self, model: torch.nn.Module,
                  hparams: Dict[str, Any]) -> torch.optim.Adam:
        return make_optimizer(model.parameters(), hparams["lr"],
                              hparams.get("wd", 0.0))

    def plateau(self, hparams: Dict[str, Any]) -> PlateauState:
        # reference code/configs.py:155-157
        return plateau_init(hparams["lr"], mode="max", factor=0.2,
                            patience=10, min_lr=1e-5)

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


def evaluate(config: CodeConfig, model: torch.nn.Module,
             loader: GraphLoader, split: str) -> Dict[str, float]:
    return config.eval_metrics(eval_epoch(model, loader), split)


def train_batched(config: CodeConfig, hparams: Dict[str, Any], *,
                  epochs: Optional[int] = None, steps: Optional[int] = None,
                  seed: int = 0, device: DeviceLike = None) -> BatchedRun:
    """Train ``config``'s net with ``hparams`` (``lr``; ``batch_size`` 128
    and ``wd`` 0 unless given).

    ``epochs``: that many epochs, each a pass over the shuffled train split,
    then a val pass whose metric steps the plateau schedule (the JAX
    runner's loop without its early stop and checkpoints). ``steps``: that
    many training steps, across epochs, and no evaluation. The run keeps
    the loaders it used (``BatchedRun.data``). Each step's time comes from
    marks that do not hold the host (``StepClock``); losses are read once
    per epoch."""
    if (epochs is None) == (steps is None):
        raise ValueError("give exactly one of epochs and steps")
    dev = resolve_device(device)
    data = config.data(hparams, dev)
    model = config.model(hparams, seed=seed, device=dev)
    optimizer = config.optimizer(model, hparams)
    plateau = config.plateau(hparams)
    clock = StepClock(dev)
    history, step_losses = [], []
    clock.start()
    if steps is not None:
        while len(step_losses) < steps:
            losses = train_epoch(model, optimizer, config.loss_fn,
                                 data["train"],
                                 steps=steps - len(step_losses), clock=clock)
            if not len(losses):
                raise ValueError("the train split gives no batch")
            step_losses += losses.tolist()
    else:
        for it in range(epochs):
            losses = train_epoch(model, optimizer, config.loss_fn,
                                 data["train"], clock=clock)
            step_losses += losses.tolist()
            val = evaluate(config, model, data["val"], "val")
            plateau = plateau_update(plateau, val["val_metric"])
            set_lr(optimizer, plateau.lr)
            history.append({"iteration": it,
                            "train_loss": float(np.mean(losses)), **val,
                            "lr": plateau.lr})
            clock.start()    # the val pass is no step
    if not np.all(np.isfinite(step_losses)):
        raise FloatingPointError(f"non-finite training loss: {step_losses}")
    return BatchedRun(model, optimizer, plateau, history, step_losses,
                      clock.seconds(), data)
