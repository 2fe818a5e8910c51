"""Reference of the homogeneous ogbn-mag net: L optimized EGC layers (a
self-loop for every aggregator), ReLU and dropout between them, no
BatchNorm; the last layer's ``out_rounded`` columns (a multiple of the
heads) are cut to the classes before the log-softmax.

``param_specs`` as in ``arxiv_net``: the upstream ``EGConv``'s names, one
``bases_weight`` [in, B*L] drawn with Glorot's bound per basis,
``comb_weight`` with ``Linear``'s.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from gnnbench.reference import common


def _dims(cfg: dict) -> List[int]:
    net = cfg["net"]
    return [cfg["graph"]["num_features"]] \
        + [net["hidden"]] * (net["num_layers"] - 1) + [net["out_rounded"]]


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    net = cfg["net"]
    H, B, A = net["heads"], net["bases"], len(net["aggrs"])
    dims = _dims(cfg)
    specs = []
    for i in range(net["num_layers"]):
        fin, fout = dims[i], dims[i + 1]
        L = fout // H
        lin = 1.0 / math.sqrt(fin)
        p = f"convs.{i}."
        specs += [(p + "bases_weight", (fin, B * L), 0.0,
                   math.sqrt(6.0 / (fin + L))),
                  (p + "bias", (fout,), 0.0, lin),
                  (p + "comb_weight.weight", (H * B * A, fin), 0.0, lin),
                  (p + "comb_weight.bias", (H * B * A,), 0.0, lin)]
    return specs


def init_running(cfg: dict, device) -> Dict[str, torch.Tensor]:
    return {}


def forward(P: Dict[str, torch.Tensor], g: common.RefGraph, cfg: dict,
            running: Dict[str, torch.Tensor], training: bool,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    net = cfg["net"]
    x = g.x
    for i in range(net["num_layers"]):
        x = common.egc_layer(x, P, f"convs.{i}.", g, heads=net["heads"],
                             bases=net["bases"], aggrs=net["aggrs"],
                             optimized=True)
        if i < net["num_layers"] - 1:
            x = common.dropout(torch.relu(x), cfg["hparams"]["dropout"],
                               gen if training else None)
    return torch.log_softmax(x[:, :cfg["graph"]["num_classes"]], -1)
