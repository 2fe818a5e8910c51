"""Heterogeneous ogbn-mag (rmag) experiment config (counterpart of
``egc_tpu.exp.hetero``; reference ``experiments/rmag/configs.py``).

Full-graph node classification of the paper nodes with ``REGCNet`` (2
layers: a REGConv with {mean, max} per relation, then an RGCNConv to the
classes), fixed hyperparameters (an empty grid over a ``Choice`` space),
plateau patience 10, stopper (50, 200). One iteration is one full-graph
step: the forward in training mode, the NLL averaged over the train
split, backward, one ``torch.optim.Adam(lr, weight_decay=wd)`` step.
The parameters the loss does not reach get a zero gradient first, so
the L2 decay moves them as the JAX optimizer does (torch's Adam would
skip them).

``data`` pads the graph (``graph.hetero.hetero_from_numpy``) and, on the
card, attaches one bipartite kernel plan a relation, built on the host;
a CPU config runs the plain path. The synthetic set is
``synthetic_rmag()``; ``synthetic = False`` reads ``load_ogbn_mag_hetero``.
The partitioned config (``PartitionedRMagConfig``) is not ported yet
(ROADMAP.md A16, heterogeneous partitions).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from egc_tpu_torch.data import synthetic
from egc_tpu_torch.device import DeviceLike, resolve_device
from egc_tpu_torch.exp.config import (
    ExperimentConfig, ExperimentSettings, Metric, StopperSpec,
)
from egc_tpu_torch.exp.hyperparams import ChoiceHyperParam
from egc_tpu_torch.graph.hetero import (
    attach_hetero_kernel_plans, hetero_from_numpy,
)
from egc_tpu_torch.nn.conv.hetero import REGCNet
from egc_tpu_torch.train.losses import gather_label_scores
from egc_tpu_torch.train.metrics import split_accuracies
from egc_tpu_torch.train.optim import plateau_init


def hetero_to_device_dict(raw: Dict[str, Any],
                          device: DeviceLike = None) -> Dict[str, Any]:
    """Pad a host hetero dict (``synthetic_rmag``'s layout), attach the
    relations' kernel plans when ``device`` is a card, and move it there:
    the graph, padded paper labels, the split masks and the net's
    schema."""
    dev = resolve_device(device)
    hg = hetero_from_numpy(raw["nodes"], raw["edges"])
    if dev.type == "cuda":
        hg = attach_hetero_kernel_plans(hg)
    hg = hg.to(dev)
    n_paper = hg.num_nodes("paper")
    y = torch.zeros(n_paper, dtype=torch.int64)
    y[:len(raw["y"])] = torch.as_tensor(raw["y"], dtype=torch.int64)
    masks = {}
    for split in ("train", "val", "test"):
        m = torch.zeros(n_paper, dtype=torch.bool)
        m[torch.as_tensor(raw[f"{split}_idx"], dtype=torch.int64)] = True
        masks[split] = m.to(dev)
    featureless = tuple(sorted(t for t, x in raw["nodes"].items()
                               if x.shape[-1] == 0))
    return {"hetero": hg, "y": y.to(dev), "masks": masks,
            "num_classes": raw["num_classes"], "featureless": featureless,
            "in_features": raw["nodes"]["paper"].shape[-1],
            "num_edges": sum(len(s) for s, _ in raw["edges"].values()),
            "device": dev}


def rmag_loss(out: torch.Tensor, y: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """NLL of the paper log-probabilities over ``mask``."""
    m = mask.to(out.dtype)
    return -(gather_label_scores(out, y) * m).sum() / \
        torch.clamp(m.sum(), min=1.0)


def train_step(model: REGCNet, optimizer: torch.optim.Optimizer,
               data: Dict[str, Any],
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One full-graph step; returns the loss (a device scalar)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    out = model(data["hetero"], generator=generator)
    loss = rmag_loss(out, data["y"], data["masks"]["train"])
    loss.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    optimizer.step()
    return loss.detach()


class RMagConfig(ExperimentConfig):
    name = "rmag"
    num_layers = 2                     # reference rmag/configs.py:23

    def __init__(self, hidden: int, *, heads: int = 4, bases: int = 4,
                 use_egc: bool = True, device: DeviceLike = None):
        self.hidden = hidden
        self.heads = heads
        self.bases = bases
        self.use_egc = use_egc
        self.device = resolve_device(device)
        self._schema: Optional[Dict[str, Any]] = None

    def settings(self):
        return ExperimentSettings("rmag", final_repeats=10,
                                  final_max_iterations=200)

    def stoppers(self):
        return StopperSpec(patience=50, max_iters=200)

    def trial_metric(self):
        return Metric("val_acc", "max")

    def search_strategy(self):
        # fixed hparams: an empty grid (reference rmag/configs.py:118-119)
        from egc_tpu_torch.exp.search import GridSearchStrategy
        return GridSearchStrategy({})

    def hyperparams(self):
        # reference rmag/configs.py:137-139
        return {
            "lr": ChoiceHyperParam([0.001, 0.01, 0.05, 0.1], default=0.01),
            "wd": ChoiceHyperParam([5e-5, 1e-4, 5e-4, 1e-3], default=1e-3),
            "dropout": ChoiceHyperParam([0.3, 0.5, 0.7], default=0.5),
        }

    def plateau(self, hparams):
        return plateau_init(hparams["lr"], mode="max", factor=0.5,
                            patience=10, min_lr=1e-5)

    def load_hetero(self) -> Dict[str, Any]:
        if self.synthetic:
            return synthetic.synthetic_rmag()
        from egc_tpu_torch.data.ondisk import load_ogbn_mag_hetero
        return load_ogbn_mag_hetero()

    def data(self, hparams):
        d = hetero_to_device_dict(self.load_hetero(), self.device)
        hg = d["hetero"]
        self._schema = dict(
            node_types=hg.node_types, relations=hg.relations,
            num_nodes={t: hg.num_nodes(t) for t in hg.node_types},
            num_classes=d["num_classes"], in_features=d["in_features"],
            featureless_types=d["featureless"])
        return d

    def model(self, hparams, *, seed: int = 0):
        """``REGCNet`` over the schema of the last ``data`` (read first if
        there is none), initialised from ``seed`` on the CPU and moved to
        the config's device."""
        if self._schema is None:
            self.data(hparams)
        net = REGCNet(self.hidden, num_layers=self.num_layers,
                      dropout=float(hparams.get("dropout", 0.5)),
                      use_egc=self.use_egc, heads=self.heads,
                      bases=self.bases, **self._schema,
                      generator=torch.Generator().manual_seed(seed))
        return net.to(self.device)

    def train(self, model, state, data, rng, iteration: int):
        loss = train_step(model, state, data, rng)
        return state, {"train_loss": float(loss)}

    @torch.no_grad()
    def val(self, model, state, data):
        model.eval()
        out = model(data["hetero"])
        return split_accuracies(out, data["y"], data["masks"])

    def test(self, model, state, data):
        return self.val(model, state, data)
