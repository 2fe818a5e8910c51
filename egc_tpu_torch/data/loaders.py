"""Host-side batched graph loader with static padding budgets (counterpart
of ``egc_tpu.data.loaders``).

Every batch is padded to the same (nodes, edges, graphs) budget, as in the
JAX package; the last short batch of an epoch is padded with empty graph
slots rather than dropped. The shuffle (``np.random.default_rng(seed)``),
the budget and the eval cache are the JAX loader's, so the same seed gives
the same batches, array for array, as its ``kernel_plans=False`` batches.

A loader bound for a CUDA device gives every batch a ``KernelPlan``
(``ops.dispatch.build_kernel_plan``, masked padding edges left out),
built on the host beside the batch, in the prefetch threads; there is no
option that leaves it out, since the attention convs raise on CUDA without
one. The TPU plan's block alignment (``PLAN_BLOCK``), its masked-edge
shadow block and ``keep_masked_edges`` have no counterpart: the node
budget rounds to 8 rows, the value the JAX loader uses off the TPU. Host
tensors are pinned where they are built and copied to the card with
``non_blocking=True`` on the consuming thread.
"""

from __future__ import annotations

import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from egc_tpu_torch.data.prefetch import prefetched
from egc_tpu_torch.device import DeviceLike, resolve_device
from egc_tpu_torch.graph.structure import Graph, batch_np
from egc_tpu_torch.ops.dispatch import build_kernel_plan

CACHE_LIMIT_BYTES = 4 << 30   # an eval loader keeps its batches below this


def padding_budget(graphs: Sequence[dict], batch_size: int, *,
                   node_multiple: int = 8,
                   edge_multiple: int = 128) -> Tuple[int, int, int]:
    """A static (nodes, edges, graphs) budget that covers any batch of the
    dataset: the ``batch_size`` largest graphs plus one padding node and
    one padding graph slot, rounded up to the multiples."""
    node_counts = sorted(int(np.asarray(g["nodes"]).shape[0])
                         for g in graphs)
    edge_counts = sorted(len(g["senders"]) for g in graphs)

    def round_up(x, m):
        return ((x + m - 1) // m) * m

    num_nodes = round_up(sum(node_counts[-batch_size:]) + 1, node_multiple)
    num_edges = round_up(max(sum(edge_counts[-batch_size:]), 1),
                         edge_multiple)
    return num_nodes, num_edges, batch_size + 1


def _nbytes(item) -> int:
    g, y = item
    plan = g.kernel_plan
    tensors = [getattr(g, k) for k in vars(g) if k != "kernel_plan"]
    if plan is not None:
        tensors += [v for v in vars(plan).values()
                    if isinstance(v, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in tensors + [y]
               if isinstance(t, torch.Tensor))


class GraphLoader:
    """Iterates fixed-shape padded ``(Graph, y)`` batches over a list of
    graph dicts, on ``device`` (``None``: the card; raises without one).

    ``y`` is the ``[num_graphs, ...]`` label tensor (zeros in the padding
    slots). ``prefetch`` host threads build batches ahead of the step.
    Eval loaders (``shuffle=False``) build their batches once and keep
    them while they fit in ``CACHE_LIMIT_BYTES``. ``build_seconds`` sums
    the host time spent building the batches and plans yielded so far:
    each batch's build counts when the batch is yielded, so the change
    over a window of steps is the build time of exactly its batches.
    """

    def __init__(self, graphs: List[dict], batch_size: int, *,
                 shuffle: bool = False, seed: int = 0,
                 budget: Optional[Tuple[int, int, int]] = None,
                 prefetch: int = 0, device: DeviceLike = None):
        self.graphs = graphs
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self.budget = budget or padding_budget(graphs, batch_size)
        self.device = resolve_device(device)
        self.kernel_plans = self.device.type == "cuda"
        self.prefetch = prefetch
        self._cache = None if shuffle else []
        self._cache_bytes = 0
        self._cache_complete = False
        self.build_seconds = 0.0

    def __len__(self) -> int:
        return (len(self.graphs) + self.batch_size - 1) // self.batch_size

    def _build(self, idx) -> Tuple[Tuple[Graph, torch.Tensor], float]:
        """One host batch: padded graph and labels, and on CUDA its kernel
        plan, every tensor pinned; and the seconds it took."""
        t0 = time.perf_counter()
        bn, be, bg = self.budget
        g, y = batch_np([self.graphs[i] for i in idx], num_nodes=bn,
                        num_edges=be, num_graphs=bg)
        y = torch.from_numpy(y)
        if self.kernel_plans:
            g = g.replace(kernel_plan=build_kernel_plan(
                g.senders.numpy(), g.receivers.numpy(), bn,
                edge_mask=g.edge_mask.numpy()))
            g, y = g.pin_memory(), y.pin_memory()
        return (g, y), time.perf_counter() - t0

    def _to_device(self, item) -> Tuple[Graph, torch.Tensor]:
        if self.device.type != "cuda":
            return item
        g, y = item
        return (g.to(self.device, non_blocking=True),
                y.to(self.device, non_blocking=True))

    def _host_batches(self) -> Iterator[Tuple[Graph, torch.Tensor]]:
        """The epoch's batches as built on the host (the eval cache's
        items), in order; a train loader shuffles its order first."""
        if self._cache_complete:
            yield from self._cache
            return
        if self._cache is not None:
            self._cache, self._cache_bytes = [], 0   # restart a partial one
        order = np.arange(len(self.graphs))
        if self.shuffle:
            self._rng.shuffle(order)
        starts = range(0, len(order), self.batch_size)
        for item, seconds in prefetched(
                self._build, ((order[i:i + self.batch_size],) for i in starts),
                self.prefetch):
            self.build_seconds += seconds
            yield self._maybe_cache(item)
        if self._cache is not None:
            self._cache_complete = True

    def __iter__(self) -> Iterator[Tuple[Graph, torch.Tensor]]:
        for item in self._host_batches():
            yield self._to_device(item)

    def _maybe_cache(self, item):
        if self._cache is not None:
            self._cache_bytes += _nbytes(item)
            if self._cache_bytes > CACHE_LIMIT_BYTES:
                self._cache = None          # too big: rebuild per epoch
            else:
                self._cache.append(item)
        return item
