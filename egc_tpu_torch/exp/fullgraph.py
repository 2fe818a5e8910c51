"""Full-graph (transductive) training of the arxiv nets (counterpart of
``egc_tpu.exp.fullgraph``'s data build and ``ArxivConfig`` step): EGC-M
(``kind="egc"``, the default: h128 H4 B4 symnorm/max/mean), GAT
(``kind="gat"``: h152 H8, the last layer single-head, is the reference's
tuned arxiv width) and GATv2 (``kind="gatv2"``, ``gat_version=2``: h112
H8, the last layer single-head, at lr 0.0087876 and wd 0.001 is the
reference's tuned arxiv configuration).

One step is the ``ArxivConfig`` epoch: a full-graph forward in training
mode, the NLL averaged over the train split, backward, and one
``torch.optim.Adam(lr, weight_decay=wd)`` step (L2 added to the gradient,
as the reference and ``egc_tpu.train.optim`` do).

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from egc_tpu_torch.device import DeviceLike, resolve_device
from egc_tpu_torch.graph.structure import Graph, pad_graph
from egc_tpu_torch.graph.transforms import symnorm_weight
from egc_tpu_torch.models.nets import ArxivNet, ConvSpec
from egc_tpu_torch.ops.dispatch import build_kernel_plan
from egc_tpu_torch.train.losses import gather_label_scores


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def full_graph_to_device_dict(raw: Dict[str, Any],
                              device: DeviceLike = None) -> Dict[str, Any]:
    """Pad a host full-graph dict, attach global symnorm weights and the
    kernel plan, and move it to ``device``. Padding follows ``egc_tpu``'s
    plan-free layout: one padding node (rounded to 8 rows) and edges
    rounded to 128; padded edges are masked and stay out of the plan."""
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
    return {"graph": g, "y": y.to(dev), "masks": masks,
            "num_classes": raw["num_classes"],
            "num_edges": int(len(raw["senders"])), "device": dev}


def build_model(*, kind: str = "egc", hidden: int = 128, heads: int = 4,
                bases: int = 4,
                aggrs: Sequence[str] = ("symnorm", "max", "mean"),
                num_layers: int = 3, dropout: float = 0.2,
                num_features: int = 128, num_classes: int = 40,
                seed: int = 0, device: DeviceLike = None) -> ArxivNet:
    """The ``ArxivConfig`` net with ``kind`` convs (``bases`` and
    ``aggrs`` are EGC's), initialised from ``seed`` on the CPU and moved
    to ``device`` (so every device starts from the same weights)."""
    dev = resolve_device(device)
    spec = ConvSpec(kind=kind, heads=heads, bases=bases, aggrs=tuple(aggrs))
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
    optimizer.zero_grad(set_to_none=True)
    out = model(data["graph"], generator=generator)
    loss = masked_nll(out, data["y"], data["masks"]["train"])
    loss.backward()
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
    model = build_model(kind=kind, hidden=hidden, heads=heads, bases=bases,
                        aggrs=aggrs, dropout=dropout,
                        num_features=data["graph"].nodes.shape[1],
                        num_classes=data["num_classes"], seed=seed,
                        device=dev)
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
