"""The arxiv net's step: the input Linear (no gradient for the features),
L EGC layers (a self-loop inside symnorm only), the output Linear."""

from __future__ import annotations

from typing import Dict

from gnnbench.counts import egc


def step_counts(cfg: dict, rows: int, edges: int) -> Dict[str, float]:
    net, graph = cfg["net"], cfg["graph"]
    h = net["hidden"]
    parts = [{"flops": egc.linear_flops(rows, graph["num_features"], h,
                                        False)}]
    for _ in range(net["num_layers"]):
        parts.append(egc.egc_layer(rows, edges, h, h, net["heads"],
                                   net["bases"], net["aggrs"], False, True))
    parts.append({"flops": egc.linear_flops(rows, h, graph["num_classes"],
                                            True)})
    return egc.add(*parts)
