"""Reference of the arxiv net: Linear -> L x [EGC layer, masked
BatchNorm, ReLU, dropout, + residual] -> Linear -> log-softmax, with the
EGC layers in their original form (a self-loop inside symnorm only).

``param_specs`` lists every parameter with its shape and how the
benchmark draws it: ``(centre, half-width)`` of a uniform draw (PyTorch's
``Linear`` bound 1/sqrt(fan_in), Glorot's per basis, BatchNorm's scale
around 1). Names follow the published model's state dict.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from gnnbench.reference import common


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    net, graph = cfg["net"], cfg["graph"]
    h, H, B = net["hidden"], net["heads"], net["bases"]
    A, L, f = len(net["aggrs"]), net["hidden"] // net["heads"], \
        graph["num_features"]
    lin = 1.0 / math.sqrt(h)
    specs = [("embed.0.weight", (h, f), 0.0, 1.0 / math.sqrt(f)),
             ("embed.0.bias", (h,), 0.0, 1.0 / math.sqrt(f))]
    for i in range(net["num_layers"]):
        p = f"convs.{i}."
        specs.append((p + "bias", (h,), 0.0, lin))
        specs += [(f"{p}bases_weight.{b}", (h, L), 0.0,
                   math.sqrt(6.0 / (h + L))) for b in range(B)]
        specs += [(p + "comb_weights.weight", (H * B * A, h), 0.0, lin),
                  (p + "comb_weights.bias", (H * B * A,), 0.0, lin)]
    for i in range(net["num_layers"]):
        specs += [(f"bns.{i}.weight", (h,), 1.0, 0.1),
                  (f"bns.{i}.bias", (h,), 0.0, 0.1)]
    specs += [("out.weight", (graph["num_classes"], h), 0.0, lin),
              ("out.bias", (graph["num_classes"],), 0.0, lin)]
    return specs


def init_running(cfg: dict, device) -> Dict[str, torch.Tensor]:
    h = cfg["net"]["hidden"]
    out = {}
    for i in range(cfg["net"]["num_layers"]):
        out[f"bns.{i}.mean"] = torch.zeros(h, device=device)
        out[f"bns.{i}.var"] = torch.ones(h, device=device)
    return out


def forward(P: Dict[str, torch.Tensor], g: common.RefGraph, cfg: dict,
            running: Dict[str, torch.Tensor], training: bool,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    net = cfg["net"]
    x = g.x @ P["embed.0.weight"].t() + P["embed.0.bias"]
    for i in range(net["num_layers"]):
        identity = x
        x = common.egc_layer(x, P, f"convs.{i}.", g, heads=net["heads"],
                             bases=net["bases"], aggrs=net["aggrs"],
                             optimized=False)
        x = torch.relu(common.batch_norm(x, P, f"bns.{i}.", running,
                                         g.node_mask, training))
        x = common.dropout(x, cfg["hparams"]["dropout"],
                           gen if training else None)
        x = x + identity
    return torch.log_softmax(x @ P["out.weight"].t() + P["out.bias"], -1)
