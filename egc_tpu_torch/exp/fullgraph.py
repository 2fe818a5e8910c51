"""Full-graph (transductive) training of the arxiv nets (counterpart of
``egc_tpu.exp.fullgraph``): the data build, ``FullGraphConfig`` and
``ArxivConfig`` (the experiment surface the runner and the CLI drive),
and ``train_full_graph``, a bare step loop over any of the nine kinds:
EGC-M (``kind="egc"``, the default: h128 H4 B4 symnorm/max/mean), GAT
(``kind="gat"``: h152 H8, the last layer single-head, is the reference's
tuned arxiv width), GATv2 (``kind="gatv2"``, ``gat_version=2``: h112
H8, the last layer single-head, at lr 0.0087876 and wd 0.001 is the
reference's tuned arxiv configuration), and GCN, GIN, SAGE, MPNN-sum,
MPNN-max and PNA (reference arxiv widths h156, h156, h115, h116, h116
and h76, ``egc_tpu/exp/pretrained.py:59-70``).

One step is the ``ArxivConfig`` epoch: a full-graph forward in training
mode, the NLL averaged over the train split, backward, and one
``torch.optim.Adam(lr, weight_decay=wd)`` step (L2 added to the gradient,
as the reference and ``egc_tpu.train.optim`` do). The ``train`` hook is
the span ``egc.step`` (``float(loss)``'s read included), and
``train_step`` splits it into ``egc.forward``, ``egc.loss``,
``egc.backward`` and ``egc.optimizer`` (``utils.profiling.span``).

``ArxivConfig`` follows the JAX one: the synthetic graph of 4,000 nodes
at degree 12 and 40 classes (or ``load_ogbn_arxiv`` with ``synthetic =
False``), its search space, grid (10 x 2 x 2), plateau (patience 40) and
stopper (80, 1000). ``MagConfig`` is homogeneous ogbn-mag (reference
``mag/configs.py``): ``MagNet`` (2 optimized EGC layers, symnorm unless
told otherwise), the synthetic graph of 6,000 nodes at degree 10 and 349
classes (or ``load_ogbn_mag_homogeneous``), fixed hyperparameters (an
empty grid), plateau patience 10, stopper (50, 200), no checkpoint at a
trial's end. ``SampledMagConfig`` trains the same net on neighbour-sampled
batches (fanouts (15, 10), batch 512; ``device_sampler`` samples on the
card) and evaluates on the full graph. ``PartitionedArxivConfig`` trains
arxiv over a process group of ranks, the graph partitioned with a halo
exchange a layer (``parallel/halo.py``). The TPU plan knobs (``wide_aggrs``,
PNA's ``bwd_narrow_window_rows``) are layout machinery and are not
carried over.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from egc_tpu_torch.data import synthetic
from egc_tpu_torch.data.device_sampling import (
    DeviceNeighborSampler, epoch_seeds,
)
from egc_tpu_torch.data.sampling import NeighborSampler, SampledNodeLoader
from egc_tpu_torch.device import DeviceLike, resolve_device
from egc_tpu_torch.exp.config import (
    ExperimentConfig, ExperimentSettings, Metric, StopperSpec,
)
from egc_tpu_torch.exp.hyperparams import (
    LogUniformHyperParam, UniformHyperParam,
)
from egc_tpu_torch.graph.structure import Graph, pad_graph
from egc_tpu_torch.graph.transforms import symnorm_weight
from egc_tpu_torch.models.nets import ArxivNet, ConvSpec, MagNet
from egc_tpu_torch.nn.conv.pna import avg_log_degree
from egc_tpu_torch.ops.dispatch import (
    build_kernel_plan, build_kernel_plan_device,
)
from egc_tpu_torch.parallel.halo import (
    DistributedNodeClassifier, partitioned_accuracies, partitioned_eval,
    partitioned_train_step,
)
from egc_tpu_torch.parallel.partition import partition_graph
from egc_tpu_torch.train.loop import fold_in
from egc_tpu_torch.train.losses import gather_label_scores
from egc_tpu_torch.train.metrics import split_accuracies
from egc_tpu_torch.train.optim import plateau_init
from egc_tpu_torch.utils.profiling import span


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def full_graph_to_device_dict(raw: Dict[str, Any],
                              device: DeviceLike = None) -> Dict[str, Any]:
    """Pad a host full-graph dict, attach global symnorm weights and the
    kernel plan, and move it to ``device``. Padding follows ``egc_tpu``'s
    plan-free layout: one padding node (rounded to 8 rows) and edges
    rounded to 128; padded edges are masked and stay out of the plan.
    ``avg_log_deg`` is PNA's statistic of the in-degrees."""
    dev = resolve_device(device)
    n = raw["x"].shape[0]
    senders = torch.as_tensor(raw["senders"], dtype=torch.int32)
    receivers = torch.as_tensor(raw["receivers"], dtype=torch.int32)
    ew, sw = symnorm_weight(senders, receivers, n)
    g = Graph.from_coo(raw["x"], senders, receivers, edge_weight=ew)
    g = g.replace(self_weight=sw)
    g = pad_graph(g, num_nodes=_round_up(n + 1, 8),
                  num_edges=_round_up(len(raw["senders"]), 128))
    plan = build_kernel_plan(g.senders.numpy(), g.receivers.numpy(),
                             g.num_nodes, edge_mask=g.edge_mask.numpy(),
                             edge_weight=g.edge_weight.numpy())
    g = g.replace(kernel_plan=plan).to(dev)
    npad = g.num_nodes
    y = torch.zeros(npad, dtype=torch.int64)
    y[:n] = torch.as_tensor(raw["y"], dtype=torch.int64)
    masks = {}
    for split in ("train", "val", "test"):
        m = torch.zeros(npad, dtype=torch.bool)
        m[torch.as_tensor(raw[f"{split}_idx"], dtype=torch.int64)] = True
        masks[split] = m.to(dev)
    deg = np.bincount(np.asarray(raw["receivers"], np.int64), minlength=n)
    return {"graph": g, "y": y.to(dev), "masks": masks,
            "num_classes": raw["num_classes"],
            "num_edges": int(len(raw["senders"])), "device": dev,
            "avg_log_deg": avg_log_degree(np.bincount(deg))}


def arxiv_net(spec: ConvSpec, hidden: int, *, num_layers: int = 3,
              dropout: float = 0.2, num_features: int = 128,
              num_classes: int = 40, seed: int = 0,
              device: DeviceLike = None) -> ArxivNet:
    """The ``ArxivConfig`` net of ``spec`` convs, initialised from
    ``seed`` on the CPU and moved to ``device`` (so every device starts
    from the same weights)."""
    dev = resolve_device(device)
    model = ArxivNet(spec, hidden, num_layers=num_layers, dropout=dropout,
                     num_features=num_features,
                     num_classes=num_classes,
                     generator=torch.Generator().manual_seed(seed))
    return model.to(dev)


def masked_nll(out: torch.Tensor, y: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """``ArxivConfig.loss_fn``: NLL of log-probabilities over ``mask``."""
    m = mask.to(out.dtype)
    nll = -gather_label_scores(out, y)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def train_step(model: ArxivNet, optimizer: torch.optim.Optimizer,
               data: Dict[str, Any],
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One full-graph training step; returns the loss (a device scalar).
    The parameters' ``.grad`` hold this step's gradients afterwards."""
    model.train()
    with span("egc.optimizer"):
        optimizer.zero_grad(set_to_none=True)
    with span("egc.forward"):
        out = model(data["graph"], generator=generator)
    with span("egc.loss"):
        loss = masked_nll(out, data["y"], data["masks"]["train"])
    with span("egc.backward"):
        loss.backward()
    with span("egc.optimizer"):
        optimizer.step()
    return loss.detach()


@dataclasses.dataclass
class TrainRun:
    losses: List[float]
    step_seconds: List[float]
    model: ArxivNet
    optimizer: torch.optim.Optimizer
    data: Dict[str, Any]


def train_full_graph(raw: Dict[str, Any], *, steps: int, kind: str = "egc",
                     hidden: int = 128, heads: int = 4, bases: int = 4,
                     aggrs: Sequence[str] = ("symnorm", "max", "mean"),
                     lr: float = 0.01, wd: float = 5e-4,
                     dropout: float = 0.2, seed: int = 0,
                     device: DeviceLike = None,
                     data: Optional[Dict[str, Any]] = None) -> TrainRun:
    """Train the arxiv net with ``kind`` convs for ``steps`` full-graph
    steps.

    ``data``: a ``full_graph_to_device_dict`` result to reuse (``raw`` is
    then not read again). Each step's time is taken on the host clock
    around work that ends in a device synchronise."""
    dev = resolve_device(device)
    if data is None:
        data = full_graph_to_device_dict(raw, dev)
    elif data["device"] != dev:
        raise ValueError(f"data lives on {data['device']}, not {dev}")
    spec = ConvSpec(kind=kind, heads=heads, bases=bases, aggrs=tuple(aggrs),
                    avg_log_deg=data["avg_log_deg"])
    model = arxiv_net(spec, hidden, dropout=dropout,
                      num_features=data["graph"].nodes.shape[1],
                      num_classes=data["num_classes"], seed=seed, device=dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, weight_decay=wd)
    gen = torch.Generator(device=dev).manual_seed(seed)
    losses, seconds = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = train_step(model, optimizer, data, gen)
        losses.append(float(loss))        # synchronises with the device
        seconds.append(time.perf_counter() - t0)
    if not np.all(np.isfinite(losses)):
        raise FloatingPointError(f"non-finite training loss: {losses}")
    return TrainRun(losses, seconds, model, optimizer, data)


class FullGraphConfig(ExperimentConfig):
    """Shared machinery of transductive node classification: one epoch is
    one full-graph step (``train_step``), evaluation the argmax accuracy
    of every split in eval mode (BatchNorm's running statistics)."""

    num_layers: int = 3

    def __init__(self, model_kind: str, hidden: int, *, heads: int = 8,
                 bases: int = 8, softmax: bool = False,
                 aggrs: Optional[Sequence[str]] = None,
                 gat_version: int = 1, device: DeviceLike = None):
        self.model_kind = model_kind
        self.hidden = hidden
        self.heads = heads
        self.bases = bases
        self.softmax = softmax
        self.aggrs = tuple(aggrs) if aggrs else None
        self.gat_version = gat_version
        self.device = resolve_device(device)
        self._avg_log_deg = 1.0
        self._num_features = 128

    def load_full_graph(self) -> Dict[str, Any]:
        raise NotImplementedError

    def data(self, hparams):
        return self.full_data(self.load_full_graph())

    def full_data(self, raw: Dict[str, Any]) -> Dict[str, Any]:
        """``full_graph_to_device_dict`` of ``raw`` on the config's device;
        records the statistics the model is built from."""
        d = full_graph_to_device_dict(raw, self.device)
        self._avg_log_deg = d["avg_log_deg"]
        self._num_features = d["graph"].nodes.shape[1]
        return d

    def conv_spec(self) -> ConvSpec:
        kind = self.model_kind
        if kind in ("gat", "gatv2"):
            kind = "gat" if self.gat_version == 1 else "gatv2"
        return ConvSpec(kind=kind, heads=self.heads, bases=self.bases,
                        softmax=self.softmax, aggrs=self.aggrs,
                        avg_log_deg=self._avg_log_deg)

    def train(self, model, state, data, rng, iteration: int):
        with span("egc.step"):
            loss = train_step(model, state, data, rng)
            return state, {"train_loss": float(loss)}

    @torch.no_grad()
    def val(self, model, state, data):
        model.eval()
        out = model(data["graph"])
        return split_accuracies(out, data["y"], data["masks"])

    def test(self, model, state, data):
        return self.val(model, state, data)


class ArxivConfig(FullGraphConfig):
    name = "arxiv"
    num_layers = 3                     # reference arxiv/configs.py:29

    def settings(self):
        return ExperimentSettings("arxiv", final_repeats=10,
                                  final_max_iterations=1000)

    def stoppers(self):
        return StopperSpec(patience=80, max_iters=1000)

    def trial_metric(self):
        return Metric("val_acc", "max")

    def search_strategy(self):
        # reference arxiv/configs.py:122-123 (FIFO scheduler: no pruner)
        from egc_tpu_torch.exp.search import GridSearchStrategy
        return GridSearchStrategy({"lr": 10, "wd": 2, "dropout": 2})

    def hyperparams(self):
        # reference arxiv/configs.py:140-144
        return {
            "lr": LogUniformHyperParam(0.001, 0.05, default=0.01),
            "wd": LogUniformHyperParam(0.0001, 0.001, default=0.0005),
            "dropout": UniformHyperParam(0.0, 0.2, default=0.2),
        }

    def plateau(self, hparams):
        # ReduceLROnPlateau(patience=40): reference arxiv/configs.py:153-157
        return plateau_init(hparams["lr"], mode="max", factor=0.5,
                            patience=40, min_lr=1e-5)

    def load_full_graph(self):
        if self.synthetic:
            return synthetic.synthetic_full_graph(
                num_nodes=4000, avg_degree=12, num_classes=40,
                num_features=128)
        from egc_tpu_torch.data.ondisk import load_ogbn_arxiv
        return load_ogbn_arxiv()

    def model(self, hparams, *, seed: int = 0):
        return arxiv_net(self.conv_spec(), self.hidden,
                         num_layers=self.num_layers,
                         dropout=float(hparams.get("dropout", 0.2)),
                         num_features=self._num_features, seed=seed,
                         device=self.device)


class MagConfig(FullGraphConfig):
    """Homogeneous ogbn-mag (paper-cites-paper) with ``MagNet``; fixed
    hyperparameters (an empty grid, reference mag/configs.py:108-109)."""

    name = "mag"
    num_layers = 2                     # reference mag/configs.py:25

    def settings(self):
        return ExperimentSettings("mag", final_repeats=10,
                                  final_max_iterations=200,
                                  checkpoint_at_end=False)

    def stoppers(self):
        return StopperSpec(patience=50, max_iters=200)

    def trial_metric(self):
        return Metric("val_acc", "max")

    def search_strategy(self):
        from egc_tpu_torch.exp.search import GridSearchStrategy
        return GridSearchStrategy({})

    def hyperparams(self):
        return {
            "lr": LogUniformHyperParam(0.001, 0.05, default=0.01),
            "wd": LogUniformHyperParam(0.0001, 0.001, default=0.0),
            "dropout": UniformHyperParam(0.0, 0.5, default=0.5),
        }

    def plateau(self, hparams):
        # ReduceLROnPlateau(patience=10): reference mag/configs.py:140-142
        return plateau_init(hparams["lr"], mode="max", factor=0.5,
                            patience=10, min_lr=1e-5)

    def load_full_graph(self):
        if self.synthetic:
            return synthetic.synthetic_full_graph(
                num_nodes=6000, avg_degree=10, num_classes=349,
                num_features=128)
        from egc_tpu_torch.data.ondisk import load_ogbn_mag_homogeneous
        return load_ogbn_mag_homogeneous()

    def model(self, hparams, *, seed: int = 0):
        """``MagNet``, initialised from ``seed`` on the CPU and moved to
        the config's device."""
        net = MagNet(self.hidden, num_layers=self.num_layers,
                     dropout=float(hparams.get("dropout", 0.5)),
                     heads=self.heads, bases=self.bases,
                     aggrs=self.aggrs or ("symnorm",),
                     num_features=self._num_features,
                     generator=torch.Generator().manual_seed(seed))
        return net.to(self.device)


class PartitionedArxivConfig(ArxivConfig):
    """Arxiv trained over a process group of ``partitions`` ranks
    (counterpart of ``egc_tpu.exp.fullgraph.PartitionedArxivConfig``):
    the nodes partitioned with a halo exchange a layer
    (``parallel/halo.py``), the hooks of ``ArxivConfig``. Every rank of
    ``mesh`` builds one, on its own device; the numerics equal the
    single-device config's (sync-BN, global symnorm weights, summed
    gradients).

    - ``data``: the whole plan on every rank (BFS cuts, the global symnorm
      weights), then the rank's own part: its extended graph (with its
      kernel plan on the card), ``send_idx``, labels and split masks.
    - ``model``: ``DistributedNodeClassifier`` from the seed on every
      rank, so the replicas start equal; its state dict is ``ArxivNet``'s.
    - ``train``: ``partitioned_train_step``, the trial's generator folded
      with the iteration (and, inside, with the rank).
    - ``val``: the accuracies over the whole graph.
    - ``persist_trial``: rank 0 writes, behind a barrier; ``restore_trial``
      reads the same files on every rank.
    """

    def __init__(self, *args, partitions: int = 0, mesh=None, **kwargs):
        if mesh is None:
            raise ValueError(
                "PartitionedArxivConfig runs on each rank of a process "
                "group: start the ranks with parallel.mesh.spawn (the "
                "CLI's --partitions does)")
        if partitions and partitions != mesh.world_size:
            raise ValueError(f"{partitions} partitions on a process group "
                             f"of {mesh.world_size} ranks")
        kwargs["device"] = mesh.device
        super().__init__(*args, **kwargs)
        self.mesh = mesh
        self.partitions = mesh.world_size
        self._num_classes = 40
        self._e_interior = None

    def data(self, hparams):
        raw = self.load_full_graph()
        n, f = raw["x"].shape
        ew, sw = symnorm_weight(torch.as_tensor(raw["senders"]),
                                torch.as_tensor(raw["receivers"]), n)
        plan = partition_graph(raw["senders"], raw["receivers"], n,
                               self.partitions, method="bfs",
                               sym_edge_w=ew.numpy(), sym_self_w=sw.numpy())
        rank, dev = self.mesh.rank, self.device
        gids = plan.node_gids[rank]
        own = gids >= 0
        x_ext = np.zeros((plan.n_ext, f), np.float32)
        x_ext[:plan.n_local][own] = np.asarray(raw["x"])[gids[own]]
        kplan = plan.build_kernel_plan(rank) if dev.type == "cuda" else None
        y = np.zeros(plan.n_local, np.int64)
        y[own] = np.asarray(raw["y"])[gids[own]]
        masks = {}
        for split in ("train", "val", "test"):
            m = np.zeros(n, bool)
            m[raw[f"{split}_idx"]] = True
            masks[split] = torch.from_numpy(m[np.maximum(gids, 0)]
                                            & own).to(dev)
        self._num_features, self._num_classes = f, raw["num_classes"]
        self._e_interior = plan.e_interior
        return {"plan": plan,
                "graph": plan.extended_graph(rank, x_ext, kplan).to(dev),
                "send_idx": torch.from_numpy(plan.send_idx[rank]).to(dev),
                "y": torch.from_numpy(y).to(dev), "masks": masks,
                "num_classes": raw["num_classes"], "device": dev}

    def model(self, hparams, *, seed: int = 0):
        net = DistributedNodeClassifier(
            self.conv_spec(), self.hidden, num_layers=self.num_layers,
            dropout=float(hparams.get("dropout", 0.2)),
            num_features=self._num_features, num_classes=self._num_classes,
            e_interior=self._e_interior, group=self.mesh.group,
            generator=torch.Generator().manual_seed(seed))
        return net.to(self.device)

    def train(self, model, state, data, rng, iteration: int):
        loss = partitioned_train_step(
            model, state, data["graph"], data["send_idx"], data["y"],
            data["masks"]["train"], generator=fold_in(rng, iteration))
        return state, {"train_loss": float(loss)}

    def val(self, model, state, data):
        out = partitioned_eval(model, data["graph"], data["send_idx"])
        return partitioned_accuracies(out, data["y"], data["masks"],
                                      self.mesh.group)

    def persist_trial(self, ckpt_dir, model, state, plateau, hparams,
                      extra=None):
        if self.mesh.rank == 0:
            super().persist_trial(ckpt_dir, model, state, plateau, hparams,
                                  extra=extra)
        dist.barrier(group=self.mesh.group)


class SampledMagConfig(MagConfig):
    """ogbn-mag (homogeneous) trained on neighbour-sampled mini-batches
    (BASELINE's "EGC-M on ogbn-mag, neighbor-sampled"; counterpart of
    ``egc_tpu.exp.fullgraph.SampledMagConfig``).

    Training uses the sampled subgraph's own symnorm weights (GraphSAGE
    style); evaluation is ``MagConfig``'s deterministic full-graph forward
    (reference ``mag/configs.py:34``), so the accuracies are exact.

    The feature matrix lives on the device once, as the eval graph's
    node storage (``x_full`` is a view of it); a step gathers its batch's
    rows. Batches come from ``data/sampling.SampledNodeLoader`` on host
    threads (4 ahead on the card, none on the CPU), or, with
    ``device_sampler=True``, from ``data/device_sampling`` on the device,
    the host giving only the shuffled seed ids. On the card each batch's
    kernel plan is built there (``build_kernel_plan_device``), enqueued
    with the step; on the CPU there is none and the convs take the
    segment path. The epoch's losses are read once, at its end.
    """

    def __init__(self, *args, fanouts=(15, 10), batch_size: int = 512,
                 device_sampler: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.fanouts = tuple(fanouts)
        self.batch_size = batch_size
        self.device_sampler = device_sampler

    def data(self, hparams):
        raw = self.load_full_graph()
        return self.sampling_data(raw, self.full_data(raw))

    def sampling_data(self, raw: Dict[str, Any],
                      full: Dict[str, Any]) -> Dict[str, Any]:
        """The data dict over ``full``, ``raw``'s ``full_data``: the eval
        dict, ``x_full`` (a view of its node storage), and the train
        split's loader (``loader``) or device sampler (``dsampler``,
        ``train_ids``, ``y_full``)."""
        n = raw["x"].shape[0]
        out = {"full": full, "x_full": full["graph"].nodes[:n],
               "num_classes": raw["num_classes"], "device": self.device}
        if self.device_sampler:
            out["dsampler"] = DeviceNeighborSampler(
                raw["senders"], raw["receivers"], n, fanouts=self.fanouts,
                device=self.device)
            out["train_ids"] = np.asarray(raw["train_idx"])
            out["y_full"] = full["y"][:n]
            return out
        cuda = self.device.type == "cuda"
        sampler = NeighborSampler(raw["senders"], raw["receivers"], n,
                                  fanouts=self.fanouts)
        out["loader"] = SampledNodeLoader(
            sampler, raw["x"], raw["y"], raw["train_idx"], self.batch_size,
            rng_seed=zlib.crc32(b"train") % (2 ** 31),
            prefetch=4 if cuda else 0, gather_on_device=True,
            pin_memory=cuda)
        return out

    def sampled_step(self, model, optimizer, x_full: torch.Tensor,
                     graph: Graph, y: torch.Tensor, seed_mask: torch.Tensor,
                     gids: torch.Tensor,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """One step on one sampled batch (on ``x_full``'s device): the
        batch's rows of ``x_full`` (ids clamped, zero where ``node_mask``
        is false), on the card its kernel plan, the NLL over the seeds and
        one Adam step. Returns the loss, a device scalar; the parameters'
        ``.grad`` hold this step's gradients afterwards."""
        n = x_full.shape[0]
        nodes = x_full[gids.long().clamp(max=n - 1)]
        g = graph.replace(nodes=torch.where(graph.node_mask[:, None], nodes,
                                            0.0))
        if nodes.is_cuda:
            g = g.replace(kernel_plan=build_kernel_plan_device(
                g.senders, g.receivers, g.num_nodes, edge_mask=g.edge_mask))
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = masked_nll(model(g, generator=generator), y.long(), seed_mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    def batches(self, data, rng: torch.Generator, iteration: int):
        """The epoch's batches on the device, each ``(generator, graph, y,
        seed_mask, gids)``: ``generator`` is folded from the trial's
        ``rng``, the iteration and the batch; the device sampler draws its
        sample from it, and the step its dropout."""
        epoch_gen = fold_in(rng, iteration)
        dev = self.device
        if not self.device_sampler:
            for i, item in enumerate(data["loader"]):
                yield (fold_in(epoch_gen, i),
                       *(t.to(dev, non_blocking=True) for t in item))
            return
        ds = data["dsampler"]
        order = data["train_ids"].copy()
        np.random.default_rng(epoch_gen.initial_seed()).shuffle(order)
        for i, seeds in enumerate(epoch_seeds(order, self.batch_size,
                                              ds.num_nodes, dev)):
            gen = fold_in(epoch_gen, i)
            yield (gen, *ds.sample_batch(seeds, data["y_full"],
                                         generator=gen))

    def train(self, model, state, data, rng, iteration: int):
        losses = [self.sampled_step(model, state, data["x_full"], g, y,
                                    seed_mask, gids, generator=gen)
                  for gen, g, y, seed_mask, gids
                  in self.batches(data, rng, iteration)]
        mean = float(torch.stack(losses).mean()) if losses else 0.0
        return state, {"train_loss": mean}

    def val(self, model, state, data):
        return super().val(model, state, data["full"])
