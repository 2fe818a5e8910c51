"""Neighbour-sampled mini-batches on the host (counterpart of
``egc_tpu.data.sampling``).

GraphSAGE-style layered sampling for graphs trained on sampled subgraphs
(``exp/fullgraph.SampledMagConfig``). Each batch holds:

- seeds: ``batch_size`` target nodes in local slots ``[0, batch_size)``
  (the loss reads these only);
- per hop k, up to ``fanouts[k]`` in-neighbours of each frontier node,
  drawn without replacement; sampled edges point INTO the frontier, so
  messages flow as in full-graph training;
- padding to the worst-case budget, so every batch has one shape.

``NeighborSampler`` is the JAX package's numpy sampler line for line: from
the same ``np.random.default_rng`` stream it gives the same arrays.
``SampledNodeLoader`` yields port ``Graph``s on the host; the consumer moves
them to the card (pinned with ``pin_memory=True``, then non-blocking
copies, as ``data/loaders.GraphLoader`` does).
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from egc_tpu_torch.data.prefetch import prefetched
from egc_tpu_torch.graph.structure import Graph, pad_graph


def _segmented_arange(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenation of arange(starts[i], starts[i]+counts[i]), vectorized
    (``egc_tpu.parallel.partition._segmented_arange``)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    keep = counts > 0
    starts, counts = starts[keep], counts[keep]
    step = np.ones(total, np.int64)
    step[0] = starts[0]
    cum = np.cumsum(counts)
    step[cum[:-1]] = starts[1:] - (starts[:-1] + counts[:-1] - 1)
    return np.cumsum(step)


def sample_budgets(batch_size: int,
                   fanouts: Sequence[int]) -> Tuple[int, int]:
    """Worst-case (nodes, edges) of a batch before padding multiples; the
    node count includes one padding node."""
    nodes, frontier, edges = batch_size, batch_size, 0
    for f in fanouts:
        edges += frontier * f
        frontier = frontier * f
        nodes += frontier
    return nodes + 1, edges


class NeighborSampler:
    """Layered in-neighbour sampler over a static COO graph (numpy)."""

    def __init__(self, senders: np.ndarray, receivers: np.ndarray,
                 num_nodes: int, fanouts: Sequence[int] = (10, 5),
                 seed: int = 0):
        self.num_nodes = num_nodes
        self.fanouts = tuple(fanouts)
        order = np.argsort(receivers, kind="stable")
        self._in_senders = senders[order].astype(np.int64)
        self._rowptr = np.searchsorted(receivers[order],
                                       np.arange(num_nodes + 1))
        self._rng = np.random.default_rng(seed)

    def budgets(self, batch_size: int) -> Tuple[int, int]:
        """Worst-case (nodes, edges) for a batch (before padding
        multiples)."""
        return sample_budgets(batch_size, self.fanouts)

    def sample(self, seeds: np.ndarray, rng=None):
        """Returns (global_node_ids, senders_local, receivers_local,
        seed_count); seeds occupy local slots [0, len(seeds)).

        Per hop, every candidate in-edge of the frontier gets a random key
        and each receiver keeps its ``fanout`` smallest keys (exact
        without-replacement sampling). ``rng``: a per-call generator, so
        prefetch threads do not race on the shared stream."""
        rng = self._rng if rng is None else rng
        seeds = np.asarray(seeds, np.int64)
        loc = np.full(self.num_nodes, -1, np.int32)   # per-call scratch
        loc[seeds] = np.arange(len(seeds))
        node_ids = seeds.copy()
        s_parts, r_parts = [], []
        frontier = seeds
        for fanout in self.fanouts:
            if not len(frontier):
                break
            deg = self._rowptr[frontier + 1] - self._rowptr[frontier]
            cand = _segmented_arange(self._rowptr[frontier], deg)
            if not len(cand):    # the frontier has no in-edges: done
                break
            recv = np.repeat(frontier, deg)
            keys = rng.random(len(cand))
            order = np.lexsort((keys, recv))
            rs = recv[order]
            change = np.r_[True, rs[1:] != rs[:-1]]
            seg = np.maximum.accumulate(
                np.where(change, np.arange(len(rs)), 0))
            keep = (np.arange(len(rs)) - seg) < fanout
            sel = cand[order][keep]
            rsel = rs[keep]
            u = self._in_senders[sel]
            new_nodes = np.unique(u[loc[u] < 0])
            loc[new_nodes] = len(node_ids) + np.arange(len(new_nodes))
            node_ids = np.concatenate([node_ids, new_nodes])
            s_parts.append(loc[u].astype(np.int32))
            r_parts.append(loc[rsel].astype(np.int32))
            frontier = new_nodes
        s_loc = (np.concatenate(s_parts) if s_parts
                 else np.zeros(0, np.int32))
        r_loc = (np.concatenate(r_parts) if r_parts
                 else np.zeros(0, np.int32))
        return node_ids, s_loc, r_loc, len(seeds)


class SampledNodeLoader:
    """Yields padded subgraph batches ``(Graph, y, seed_mask)`` for node
    classification over a seed split, all on the host.

    ``gather_on_device=True``: graphs carry zero-width node features and
    each item appends the padded global ids (``[node_budget]`` int32, 0 on
    padding); the step gathers its rows from the device-resident feature
    matrix, so a batch moves its ids to the card, not its features.
    ``kernel_plans=True``: each graph carries the host-built
    ``ops.dispatch.KernelPlan`` of its valid edges. ``prefetch=N``: N
    batches are built ahead on threads; each batch draws from its own
    ``SeedSequence([rng_seed, batch_id])`` stream, so the items equal the
    synchronous loader's. ``pin_memory=True``: every tensor of an item is
    page-locked (on the building thread), ready for a non-blocking copy.
    Budgets round up to 8 nodes and 128 edges.
    """

    def __init__(self, sampler: NeighborSampler, x: np.ndarray,
                 y: np.ndarray, seed_ids: np.ndarray, batch_size: int,
                 *, shuffle: bool = True, rng_seed: int = 0,
                 kernel_plans: bool = False, prefetch: int = 0,
                 gather_on_device: bool = False, pin_memory: bool = False):
        self.sampler = sampler
        self.x, self.y = x, y
        self.gather_on_device = gather_on_device
        self.seed_ids = np.asarray(seed_ids)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng_seed = rng_seed
        self._rng = np.random.default_rng(rng_seed)
        self.kernel_plans = kernel_plans
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        n_budget, e_budget = sampler.budgets(batch_size)
        self.node_budget = ((n_budget + 7) // 8) * 8
        self.edge_budget = ((e_budget + 127) // 128) * 128
        self._batch_counter = 0

    def __len__(self):
        return (len(self.seed_ids) + self.batch_size - 1) // self.batch_size

    def _build(self, seeds: np.ndarray, batch_id: int):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.rng_seed, batch_id]))
        gids, s, r, n_seed = self.sampler.sample(seeds, rng=rng)
        if self.gather_on_device:
            nodes = np.zeros((len(gids), 0), np.float32)
        else:
            nodes = self.x[gids]
        g = Graph.from_coo(nodes, s, r)
        g = pad_graph(g, num_nodes=self.node_budget,
                      num_edges=self.edge_budget)
        if self.kernel_plans:
            from egc_tpu_torch.ops.dispatch import build_kernel_plan
            g = g.replace(kernel_plan=build_kernel_plan(
                g.senders.numpy(), g.receivers.numpy(), self.node_budget,
                edge_mask=g.edge_mask.numpy()))
        y = np.zeros(self.node_budget, self.y.dtype)
        y[:len(gids)] = self.y[gids]
        seed_mask = np.zeros(self.node_budget, bool)
        seed_mask[:n_seed] = True
        item = (g, torch.from_numpy(y), torch.from_numpy(seed_mask))
        if self.gather_on_device:
            gids_pad = np.zeros(self.node_budget, np.int32)
            gids_pad[:len(gids)] = gids
            item += (torch.from_numpy(gids_pad),)
        if self.pin_memory:
            item = tuple(t.pin_memory() for t in item)
        return item

    def __iter__(self) -> Iterator:
        order = self.seed_ids.copy()
        if self.shuffle:
            self._rng.shuffle(order)
        base = self._batch_counter
        chunks = [(order[i:i + self.batch_size], base + k)
                  for k, i in enumerate(
                      range(0, len(order), self.batch_size))]
        self._batch_counter = base + len(chunks)
        yield from prefetched(self._build, chunks, self.prefetch)
