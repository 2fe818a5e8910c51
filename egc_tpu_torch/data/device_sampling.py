"""Neighbour sampling on the card (counterpart of
``egc_tpu.data.device_sampling``).

The layered sample of ``data/sampling.NeighborSampler`` as a fixed
sequence of torch ops on the device, over static budgets, with no host
sync:

- the graph's in-edge CSR (``rowptr``, ``in_senders``) lives on the card
  once;
- per hop, every frontier node draws a uniform without-replacement
  ``fanout``-subset of its in-edges with a vectorised Floyd sampler
  (``fanout`` rounds of draw-and-remap; membership is a ``[fb, k]``
  compare). Same distribution as the host sampler (both uniform
  k-subsets); the draws differ;
- new nodes get dense local ids by sort, run starts and a cumulative sum;
  a ``[num_nodes + 2]`` table maps global ids to local ones per batch, the
  node count ``n_cur`` stays a device scalar.

JAX's ``.at[...].set(..., mode="drop")`` scatters become scatters into one
extra trash slot past the end of each target (torch has no drop mode).
The draws come from one function, ``uniform(n) -> [n] float32``, called in
the JAX sampler's order (hop by hop, Floyd round by round), by default
``torch.rand(n, generator=gen, device=dev)``; a test can hand it the
uniforms of the JAX key splits and get the JAX sample.

The output mirrors ``SampledNodeLoader(gather_on_device=True)``: a padded
zero-width-feature ``Graph``, the padded global ids (sentinel
``num_nodes`` on padding), labels and the seed mask.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from egc_tpu_torch.data.sampling import sample_budgets
from egc_tpu_torch.device import DeviceLike, resolve_device
from egc_tpu_torch.graph.structure import Graph

Uniform = Callable[[int], torch.Tensor]


def as_graph(gids, s, r, em, nm, *, x_width: int = 0) -> Graph:
    """Wrap sampler outputs as a padded ``Graph`` with ``x_width``-wide
    zero node features."""
    nb = nm.shape[0]
    dev = nm.device
    return Graph(nodes=torch.zeros(nb, x_width, device=dev), senders=s,
                 receivers=r, node_mask=nm, edge_mask=em,
                 graph_ids=torch.zeros(nb, dtype=torch.int32, device=dev),
                 graph_mask=torch.ones(1, dtype=torch.bool, device=dev))


def _floyd_subset(uniform: Uniform, deg: torch.Tensor, k: int):
    """Per-row uniform without-replacement k-subset of ``[0, deg)``.

    Floyd's algorithm, vectorised over rows: for j = 0..k-1 draw t ~
    U[0, deg-k+j], replaced by deg-k+j when it collides with an earlier
    pick. Rows with deg <= k take slots 0..deg-1 (all edges, CSR order).
    The arithmetic is JAX's: ``floor(u * (i + 1))`` in float32. Returns
    (sel [R, k] int64, slot_valid [R, k] bool)."""
    r = deg.shape[0]
    deg = deg.to(torch.int32)
    sel = torch.zeros(r, k, dtype=torch.int64, device=deg.device)
    for j in range(k):
        u = uniform(r)
        i_val = deg - k + j                       # >= 0 iff deg >= k - j
        t = torch.minimum(torch.floor(u * (i_val + 1)).to(torch.int32),
                          i_val.clamp(min=0)).long()
        if j:
            member = (sel[:, :j] == t[:, None]).any(dim=1)
            t = torch.where(member, i_val.long(), t)
        sel[:, j] = torch.where(deg <= k, j, t)
    slot_valid = torch.arange(k, device=deg.device)[None, :] < \
        deg.clamp(max=k)[:, None]
    return sel, slot_valid


class DeviceNeighborSampler:
    """Layered in-neighbour sampler running on ``device`` (the card unless
    the caller asks for the CPU). Same contract as ``NeighborSampler``:
    in-edges of the frontier, without replacement per receiver, the loss
    seeds in local slots ``[0, batch)``."""

    def __init__(self, senders: np.ndarray, receivers: np.ndarray,
                 num_nodes: int, fanouts: Sequence[int] = (10, 5), *,
                 device: DeviceLike = None):
        self.num_nodes = int(num_nodes)
        self.fanouts = tuple(int(f) for f in fanouts)
        self.device = resolve_device(device)
        order = np.argsort(receivers, kind="stable")
        self.in_senders = torch.as_tensor(
            senders[order].astype(np.int64), device=self.device)
        self.rowptr = torch.as_tensor(
            np.searchsorted(receivers[order], np.arange(num_nodes + 1)),
            dtype=torch.int64, device=self.device)

    def budgets(self, batch_size: int) -> Tuple[int, int]:
        """Worst-case (nodes, edges), the host sampler's."""
        return sample_budgets(batch_size, self.fanouts)

    def padded_budgets(self, batch_size: int) -> Tuple[int, int]:
        """The budgets rounded up to 8 nodes and 128 edges."""
        nb, eb = self.budgets(batch_size)
        return ((nb + 7) // 8) * 8, ((eb + 127) // 128) * 128

    def sample(self, seeds: torch.Tensor, *,
               generator: Optional[torch.Generator] = None,
               uniform: Optional[Uniform] = None):
        """One sample. ``seeds``: ``[S]`` on the device (sentinel
        ``num_nodes`` pads a short final batch). Draws from ``uniform``,
        else ``torch.rand`` on ``generator``. Returns (gids
        [node_budget], senders / receivers / edge_mask [edge_budget],
        node_mask [node_budget], n_nodes: a device scalar); int32 ids."""
        dev = self.device
        if uniform is None:
            def uniform(n):
                return torch.rand(n, generator=generator, device=dev)
        N, S = self.num_nodes, seeds.shape[0]
        node_budget, edge_budget = self.padded_budgets(S)
        pad_node = node_budget - 1
        rowptr, in_senders = self.rowptr, self.in_senders
        i64 = dict(dtype=torch.int64, device=dev)
        seeds = seeds.long()
        # global -> local ids, and local -> global; the last slot of each
        # takes the writes JAX drops
        loc = torch.full((N + 2,), -1, **i64)
        loc[torch.where(seeds < N, seeds, N + 1)] = torch.arange(S, **i64)
        gids = torch.full((node_budget + 1,), N, **i64)
        gids[:S] = seeds
        n_cur = torch.tensor(S, **i64)

        f = seeds                                 # frontier gids [fb]
        floc = torch.arange(S, **i64)             # frontier local ids
        fb = S
        es, er, em = [], [], []
        for fanout in self.fanouts:
            fvalid = f < N
            fc = f.clamp(max=N - 1)
            deg = torch.where(fvalid, rowptr[fc + 1] - rowptr[fc], 0)
            sel, slot_ok = _floyd_subset(uniform, deg, fanout)
            eidx = (rowptr[fc][:, None] + sel).clamp(
                max=in_senders.shape[0] - 1)
            valid = slot_ok & fvalid[:, None]
            u = torch.where(valid, in_senders[eidx], N)     # [fb, fanout]

            # dense local ids for first-seen senders
            cand = torch.where(valid & (loc[u] < 0), u, N).reshape(-1)
            ss = torch.sort(cand).values
            isnew = (ss < N) & torch.cat(
                [torch.ones(1, dtype=torch.bool, device=dev),
                 ss[1:] != ss[:-1]])
            ranks = torch.cumsum(isnew, 0) - 1
            loc[torch.where(isnew, ss, N + 1)] = n_cur + ranks
            gids[torch.where(isnew, n_cur + ranks, node_budget)] = ss

            s_loc = loc[u]                        # after the update
            es.append(torch.where(valid, s_loc, pad_node).reshape(-1))
            er.append(torch.where(valid, floc[:, None],
                                  pad_node).reshape(-1))
            em.append(valid.reshape(-1))

            nfb = fb * fanout
            nxt = torch.full((nfb + 1,), N, **i64)
            nxt[torch.where(isnew, ranks, nfb)] = ss
            f = nxt[:nfb]
            floc = n_cur + torch.arange(nfb, **i64)
            fb = nfb
            n_cur = n_cur + isnew.sum()

        pad_e = edge_budget - sum(x.shape[0] for x in es)
        s_all = torch.cat(es + [torch.full((pad_e,), pad_node, **i64)])
        r_all = torch.cat(er + [torch.full((pad_e,), pad_node, **i64)])
        m_all = torch.cat(em + [torch.zeros(pad_e, dtype=torch.bool,
                                            device=dev)])
        gids = gids[:node_budget]
        node_mask = (torch.arange(node_budget, device=dev) < n_cur) & \
            (gids < N)
        i32 = torch.int32
        return (gids.to(i32), s_all.to(i32), r_all.to(i32), m_all,
                node_mask, n_cur.to(i32))

    def sample_graph(self, seeds: torch.Tensor, *,
                     generator: Optional[torch.Generator] = None,
                     x_width: int = 0):
        """Sample and wrap as a padded zero-width-feature ``Graph`` and the
        gids, as ``SampledNodeLoader(gather_on_device=True)`` items."""
        gids, s, r, em, nm, _ = self.sample(seeds, generator=generator)
        return as_graph(gids, s, r, em, nm, x_width=x_width), gids

    def sample_batch(self, seeds: torch.Tensor, y_full: torch.Tensor, *,
                     generator: Optional[torch.Generator] = None):
        """One training item ``(graph, y, seed_mask, gids)``: the sampled
        graph, the labels of its nodes from the device-resident
        ``y_full``, and the mask of the real seeds."""
        g, gids = self.sample_graph(seeds, generator=generator)
        y = y_full[gids.long().clamp(max=self.num_nodes - 1)]
        seed_mask = (torch.arange(g.num_nodes, device=self.device)
                     < seeds.shape[0]) & g.node_mask
        return g, y, seed_mask, gids


class DeviceSampledLoader:
    """Epoch iterator over batches sampled on the card.

    Yields ``(graph, y, seed_mask, gids)``, the item contract of
    ``SampledNodeLoader(gather_on_device=True)`` on the device
    (``DeviceNeighborSampler.sample_batch``). The seed order is shuffled
    on the host (a permutation of the ids only); each batch's draws come
    from ``generator`` in turn."""

    def __init__(self, sampler: DeviceNeighborSampler, y: np.ndarray,
                 seed_ids: np.ndarray, batch_size: int, *,
                 shuffle: bool = True, rng_seed: int = 0):
        self.sampler = sampler
        dev = sampler.device
        self.y_full = torch.as_tensor(np.asarray(y), device=dev)
        self.seed_ids = np.asarray(seed_ids)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(rng_seed)
        self.generator = torch.Generator(device=dev).manual_seed(rng_seed)

    def __len__(self):
        return (len(self.seed_ids) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = self.seed_ids.copy()
        if self.shuffle:
            self._rng.shuffle(order)
        for seeds in epoch_seeds(order, self.batch_size,
                                 self.sampler.num_nodes,
                                 self.sampler.device):
            yield self.sampler.sample_batch(seeds, self.y_full,
                                            generator=self.generator)


def epoch_seeds(order: np.ndarray, batch_size: int, num_nodes: int,
                device: torch.device) -> torch.Tensor:
    """An epoch's seed ids as ``[batches, batch_size]`` int64 on
    ``device``, the last batch padded with the sentinel ``num_nodes``:
    one non-blocking copy from pinned memory, not one copy a batch (a
    pageable copy waits for the stream)."""
    batches = (len(order) + batch_size - 1) // batch_size
    seeds = np.full(batches * batch_size, num_nodes, np.int64)
    seeds[:len(order)] = order
    seeds = torch.from_numpy(seeds.reshape(batches, batch_size))
    if device.type == "cuda":
        seeds = seeds.pin_memory()
    return seeds.to(device, non_blocking=True)
