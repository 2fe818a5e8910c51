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
``PartitionedRMagConfig`` trains the same net over a process group, every
node type partitioned with a halo exchange a type a layer
(``parallel/hetero_halo.py``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

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
from egc_tpu_torch.parallel.halo import partitioned_accuracies
from egc_tpu_torch.parallel.hetero_halo import (
    DistributedREGCNet, full_optimizer_state, load_full_optimizer_state,
    partitioned_rmag_eval, partitioned_rmag_train_step,
)
from egc_tpu_torch.parallel.hetero_partition import partition_hetero
from egc_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from egc_tpu_torch.train.loop import fold_in
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


class PartitionedRMagConfig(RMagConfig):
    """rmag trained over a process group of ``partitions`` ranks
    (counterpart of ``egc_tpu.exp.hetero.PartitionedRMagConfig``): every
    node type partitioned (``parallel/hetero_partition.py``), a halo
    exchange a type a layer, the hooks of ``RMagConfig``. Every rank of
    ``mesh`` builds one, on its own device; the numerics equal the
    single-device config's.

    - ``data``: the whole plan on every rank, then the rank's own part:
      each type's extended rows (``x_ext``), ``send_idx`` a type, the
      paper labels and split masks of its owned rows, and on the card its
      relations' kernel plans (owned destination rows only).
    - ``model``: ``DistributedREGCNet`` from the seed on every rank, the
      embeddings the rank's rows of ``REGCNet``'s tables.
    - ``train``: ``partitioned_rmag_train_step``, the trial's generator
      folded with the iteration (and, inside, with the rank).
    - ``val``: the accuracies over the whole graph.
    - ``persist_trial``: ``REGCNet``'s state dict and its optimizer's (the
      embeddings and their moments gathered to full tables, on every
      rank), written by rank 0 behind a barrier; ``restore_trial`` reads
      the same files on every rank and keeps its rows.
    """

    def __init__(self, *args, partitions: int = 0, mesh=None, **kwargs):
        if mesh is None:
            raise ValueError(
                "PartitionedRMagConfig runs on each rank of a process "
                "group: start the ranks with parallel.mesh.spawn (the "
                "CLI's --partitions does)")
        if partitions and partitions != mesh.world_size:
            raise ValueError(f"{partitions} partitions on a process group "
                             f"of {mesh.world_size} ranks")
        kwargs["device"] = mesh.device
        super().__init__(*args, **kwargs)
        self.mesh = mesh
        self.partitions = mesh.world_size
        self._plan = None

    def data(self, hparams):
        raw = self.load_hetero()
        hg = hetero_from_numpy(raw["nodes"], raw["edges"])
        num_nodes = {t: hg.num_nodes(t) for t in hg.node_types}
        plan = partition_hetero(num_nodes, raw["edges"], self.partitions)
        rank, dev = self.mesh.rank, self.device
        x_ext = {}
        for t in hg.node_types:
            tp, x = plan.types[t], hg.nodes[t].numpy()
            x_ext[t] = np.zeros((tp.n_ext,) + x.shape[1:], x.dtype)
            x_ext[t][:tp.n_local] = tp.rank_rows(x, rank)
        kplans = plan.build_kernel_plans(rank) if dev.type == "cuda" \
            else None
        pp = plan.types["paper"]
        y = np.zeros(num_nodes["paper"], np.int64)
        y[:len(raw["y"])] = raw["y"]
        masks = {}
        for split in ("train", "val", "test"):
            m = np.zeros(num_nodes["paper"], bool)
            m[raw[f"{split}_idx"]] = True
            masks[split] = torch.from_numpy(pp.rank_rows(m, rank)).to(dev)
        featureless = tuple(sorted(t for t, x in raw["nodes"].items()
                                   if x.shape[-1] == 0))
        in_features = raw["nodes"]["paper"].shape[-1]
        self._plan = plan
        self._schema = dict(
            node_types=hg.node_types, relations=hg.relations,
            num_nodes=num_nodes, num_classes=raw["num_classes"],
            in_features=in_features, featureless_types=featureless)
        return {"plan": plan,
                "hetero": plan.extended_hetero_graph(rank, x_ext,
                                                     kplans).to(dev),
                "send_idx": {t: torch.from_numpy(tp.send_idx[rank]).to(dev)
                             for t, tp in plan.types.items()},
                "y": torch.from_numpy(pp.rank_rows(y, rank)).to(dev),
                "masks": masks, "num_classes": raw["num_classes"],
                "featureless": featureless, "in_features": in_features,
                "num_edges": sum(len(s) for s, _ in raw["edges"].values()),
                "device": dev}

    def model(self, hparams, *, seed: int = 0):
        """``DistributedREGCNet`` over the last ``data``'s plan (read first
        if there is none), initialised from ``seed`` on the CPU and moved
        to the rank's device."""
        if self._plan is None:
            self.data(hparams)
        net = DistributedREGCNet(
            self.hidden, type_plans=self._plan.types, rank=self.mesh.rank,
            group=self.mesh.group, num_layers=self.num_layers,
            dropout=float(hparams.get("dropout", 0.5)),
            use_egc=self.use_egc, heads=self.heads, bases=self.bases,
            **self._schema, generator=torch.Generator().manual_seed(seed))
        return net.to(self.device)

    def train(self, model, state, data, rng, iteration: int):
        loss = partitioned_rmag_train_step(
            model, state, data["hetero"], data["send_idx"], data["y"],
            data["masks"]["train"], generator=fold_in(rng, iteration))
        return state, {"train_loss": float(loss)}

    def val(self, model, state, data):
        out = partitioned_rmag_eval(model, data["hetero"], data["send_idx"])
        return partitioned_accuracies(out, data["y"], data["masks"],
                                      self.mesh.group)

    def persist_trial(self, ckpt_dir, model, state, plateau, hparams,
                      extra=None):
        states = (model.full_state_dict(), full_optimizer_state(model, state))
        if self.mesh.rank == 0:
            save_checkpoint(Path(ckpt_dir), model=model, optimizer=state,
                            plateau=plateau, hparams=hparams, extra=extra,
                            states=states)
        dist.barrier(group=self.mesh.group)

    def restore_trial(self, ckpt_dir, data=None, seed: int = 0):
        meta = json.loads((Path(ckpt_dir) / "checkpoint.json").read_text())
        hparams = meta.get("hparams", {})
        if data is None:
            data = self.data(hparams)
        model = self.model(hparams, seed=seed)
        state = self.init_state(model, hparams, data, seed)

        def load_states(model_sd, opt_sd):
            model.load_full_state_dict(model_sd)
            load_full_optimizer_state(model, state, opt_sd)

        _, plateau, _ = load_checkpoint(Path(ckpt_dir), model=model,
                                        optimizer=state,
                                        load_states=load_states)
        return model, state, plateau, hparams, data
