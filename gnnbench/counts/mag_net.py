"""The mag net's step: L optimized EGC layers (a self-loop for every
aggregator); the first takes the features, which need no gradient."""

from __future__ import annotations

from typing import Dict

from gnnbench.counts import egc


def step_counts(cfg: dict, rows: int, edges: int) -> Dict[str, float]:
    net = cfg["net"]
    dims = [cfg["graph"]["num_features"]] \
        + [net["hidden"]] * (net["num_layers"] - 1) + [net["out_rounded"]]
    return egc.add(*(
        egc.egc_layer(rows, edges, dims[i], dims[i + 1], net["heads"],
                      net["bases"], net["aggrs"], True, i > 0)
        for i in range(net["num_layers"])))
