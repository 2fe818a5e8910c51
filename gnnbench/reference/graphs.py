"""The reference's graphs, worked out from the benchmark's host graph:
the full graph as the full-graph cells train on it, and a sampled batch,
which is the program's output and is judged here against the graph
before the reference trains on it.

Full graph: one padding row after the real nodes, rows rounded up to a
multiple of 8 (the program's layout, so that dropout draws the same
shapes from the same stream); symnorm over the real nodes.

Sampled batch (GraphSAGE-style, ``fanouts`` per hop): the seeds take
the first slots; hop k gives each node of its frontier ``min(fanout_k,
in-degree)`` distinct in-edges of the graph; the nodes first reached at
hop k form the next frontier, in ascending global id; the batch is padded
to its worst case, nodes rounded up to 8 and edges to 128.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from gnnbench.reference import common


def full_graph(raw: dict, device) -> Tuple[common.RefGraph, torch.Tensor,
                                           Dict[str, torch.Tensor]]:
    n, f = raw["x"].shape
    rows = common.round_up(n + 1, 8)
    x = torch.zeros(rows, f, device=device)
    x[:n] = torch.from_numpy(raw["x"]).to(device)
    mask = torch.zeros(rows, dtype=torch.bool, device=device)
    mask[:n] = True
    g = common.ref_graph(x, raw["senders"], raw["receivers"], mask,
                         sym_rows=n)
    y = torch.zeros(rows, dtype=torch.long, device=device)
    y[:n] = torch.from_numpy(raw["y"].astype(np.int64)).to(device)
    masks = {}
    for split in ("train", "val", "test"):
        m = torch.zeros(rows, dtype=torch.bool, device=device)
        m[torch.from_numpy(raw[f"{split}_idx"]).to(device)] = True
        masks[split] = m
    return g, y, masks


def batch_budget(batch_size: int, fanouts: Sequence[int]) -> Tuple[int, int]:
    """Node and edge slots of a padded batch: every seed's worst case,
    one padding node, nodes to a multiple of 8 and edges of 128."""
    nodes, frontier, edges = batch_size, batch_size, 0
    for f in fanouts:
        edges += frontier * f
        frontier *= f
        nodes += frontier
    return common.round_up(nodes + 1, 8), common.round_up(edges, 128)


def judge_batch(raw: dict, batch: Dict[str, np.ndarray], *,
                fanouts: Sequence[int], batch_size: int,
                seeds_expected: int) -> list:
    """The faults of one sampled batch (host arrays ``senders``,
    ``receivers``, ``edge_mask``, ``node_mask``, ``gids``, ``y``,
    ``seed_mask``) against the graph; an empty list when it is sound."""
    faults = []
    n = raw["x"].shape[0]
    rows, slots = batch_budget(batch_size, fanouts)
    nm, em = batch["node_mask"].astype(bool), batch["edge_mask"].astype(bool)
    if nm.shape[0] != rows or em.shape[0] != slots:
        return [f"shape: {nm.shape[0]} node and {em.shape[0]} edge slots, "
                f"want {rows} and {slots}"]
    nv, ev = int(nm.sum()), int(em.sum())
    if not nm[:nv].all() or not em[:ev].all():
        faults.append("valid nodes or edges are not a prefix")
    gids = batch["gids"][:nv].astype(np.int64)
    if len(np.unique(gids)) != nv or gids.min() < 0 or gids.max() >= n:
        faults.append("node ids repeat or lie outside the graph")
    sm = batch["seed_mask"].astype(bool)
    if int(sm.sum()) != seeds_expected or not sm[:seeds_expected].all():
        faults.append(f"{int(sm.sum())} seeds, want {seeds_expected} first")
    train = np.zeros(n, bool)
    train[raw["train_idx"]] = True
    if not train[gids[:seeds_expected]].all():
        faults.append("a seed is not a training node")
    if not np.array_equal(batch["y"][:nv].astype(np.int64),
                          raw["y"][gids].astype(np.int64)):
        faults.append("labels differ from the graph's")
    s = batch["senders"][:ev].astype(np.int64)
    r = batch["receivers"][:ev].astype(np.int64)
    if ev and (s.max() >= nv or r.max() >= nv or min(s.min(), r.min()) < 0):
        return faults + ["an edge leaves the valid nodes"]
    gs, gr = gids[s], gids[r]
    keys = raw["receivers"].astype(np.int64) * n + raw["senders"]
    want = gr * n + gs
    pos = np.minimum(np.searchsorted(keys, want), len(keys) - 1)
    if not (keys[pos] == want).all():
        faults.append(f"{int((keys[pos] != want).sum())} edges are not "
                      f"in the graph")
    if len(np.unique(r * nv + s)) != ev:
        faults.append("an edge is sampled twice")
    deg = np.bincount(raw["receivers"], minlength=n)
    got = np.bincount(r, minlength=nv)
    start, end = 0, seeds_expected
    reached = np.zeros(nv, bool)
    reached[:end] = True
    counted = 0
    for f in fanouts:
        frontier = np.arange(start, end)
        if not (got[frontier] == np.minimum(f, deg[gids[frontier]])).all():
            faults.append(f"a node of frontier [{start}, {end}) has the "
                          f"wrong number of in-edges for fanout {f}")
        hop = (r >= start) & (r < end)
        counted += int(hop.sum())
        new = np.unique(s[hop][~reached[s[hop]]])
        if not np.array_equal(new, np.arange(end, end + len(new))) or \
                (len(new) > 1 and (np.diff(gids[new]) <= 0).any()):
            faults.append(f"the nodes reached from [{start}, {end}) are "
                          f"not the next slots in ascending id")
        reached[new] = True
        start, end = end, end + len(new)
    if end != nv or counted != ev or got[start:end].any():
        faults.append("nodes or edges outside the hops")
    return faults


def sampled_batch(raw: dict, batch: Dict[str, np.ndarray], device
                  ) -> Tuple[common.RefGraph, torch.Tensor, torch.Tensor]:
    """The reference's graph of a judged batch: the features and labels
    of its node ids, its valid edges, symnorm over the batch's rows."""
    nm = batch["node_mask"].astype(bool)
    em = batch["edge_mask"].astype(bool)
    rows, nv = nm.shape[0], int(nm.sum())
    gids = torch.from_numpy(batch["gids"][:nv].astype(np.int64))
    x = torch.zeros(rows, raw["x"].shape[1], device=device)
    x[:nv] = torch.from_numpy(raw["x"])[gids].to(device)
    g = common.ref_graph(x, batch["senders"][em], batch["receivers"][em],
                         torch.from_numpy(nm).to(device))
    y = torch.zeros(rows, dtype=torch.long, device=device)
    y[:nv] = torch.from_numpy(raw["y"].astype(np.int64))[gids].to(device)
    mask = torch.from_numpy(batch["seed_mask"].astype(bool)).to(device)
    return g, y, mask
