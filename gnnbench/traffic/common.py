"""What the traffic modes share: the benchmark's graph and weights from
the seed, and the program's configuration fed with them."""

from __future__ import annotations

import importlib
from typing import Tuple

from gnnbench import graph, port, weights
from gnnbench.reference import common
from gnnbench.reference.train import model_module


def inputs(ctx) -> Tuple[dict, dict]:
    """The host graph and the initial weights (on the device) of the
    run's seed."""
    cfg = ctx.cell.config
    raw = graph.synthetic_full_graph(**cfg["graph"], seed=ctx.seed)
    specs = model_module(cfg).param_specs(cfg)
    return raw, weights.make_weights(specs, ctx.weights_seed, ctx.device)


def program_config(ctx, raw: dict, w0: dict, mixin: type = None):
    cell = ctx.cell
    return port.bench_config(cell.config, cell.traffic, raw, w0, ctx.device,
                             mixin=mixin)


def graph_counts(ctx, raw: dict) -> dict:
    """A full-graph step's operations and kernel bytes, from the
    configuration's shapes and the graph's rows (with the padding row,
    to a multiple of 8) and real edges."""
    n = raw["x"].shape[0]
    rows = common.round_up(n + 1, 8)
    cfg = ctx.cell.config
    mod = importlib.import_module(f"gnnbench.counts.{cfg['model']}")
    return mod.step_counts(cfg, rows, len(raw["senders"]))
