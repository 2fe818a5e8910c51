"""Partitioned heterogeneous (typed) graphs: the rmag task over ranks
(counterpart of ``egc_tpu.parallel.hetero_partition``; its numpy, copied
so the port imports no part of ``egc_tpu``).

The homogeneous partitioner (``parallel/partition.py``) extended to typed
node spaces and per-relation bipartite edges:

- ownership per NODE TYPE: a BFS locality order over the typed-union
  graph, cut per type into degree-balanced contiguous chunks (every rank
  holds one ``[n_local_t, F]`` array a type, ``n_local_t`` the same on
  every rank);
- every relation edge is assigned to its DESTINATION's owner, so each
  owned destination's in-neighbourhood is complete once the halo arrives;
- per-type halo send lists, deduplicated across all the relations that
  share the source type: one all-to-all a type a layer refreshes every
  relation's remote senders at once (``parallel/hetero_halo.py``).

The plan's arrays are stacked with a leading partition axis P, as JAX's
are. Every rank builds the whole plan and keeps its own part:
``extended_hetero_graph(rank, ...)`` (a ``HeteroGraph`` over each type's
``[owned | P * H_t halo]`` rows) and ``build_kernel_plans(rank)`` (one
bipartite kernel plan a relation, over the source type's ``n_ext`` rows
and the destination type's ``n_local`` rows only: receivers are always
owned, so the conv zero-pads the output up to ``n_ext``;
``nn/conv/hetero._rel_multi_aggregate``). Masked padding edges stay out
of the plans, the port's default: JAX keeps them only because its
stacked plans need one geometry on every device.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from egc_tpu_torch.graph.hetero import HeteroGraph, split_rel_key
from egc_tpu_torch.ops.dispatch import KernelPlan, build_bipartite_kernel_plan
from egc_tpu_torch.parallel.partition import _bfs_order


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _cumcount(keys: np.ndarray) -> np.ndarray:
    """Position of each element within its key group (keys need not be
    sorted; stable order within groups)."""
    if not len(keys):
        return np.zeros(0, np.int64)
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    change = np.r_[True, ks[1:] != ks[:-1]]
    seg = np.maximum.accumulate(np.where(change, np.arange(len(ks)), 0))
    pos_sorted = np.arange(len(ks)) - seg
    pos = np.empty(len(keys), np.int64)
    pos[order] = pos_sorted
    return pos


@dataclasses.dataclass
class TypePlan:
    owner: np.ndarray        # [N_t] partition per node
    local_index: np.ndarray  # [N_t]
    n_local: int
    halo: int                # padded per-(src, dst) halo size H_t
    node_gids: np.ndarray    # [P, n_local] (-1 pad)
    node_mask: np.ndarray    # [P, n_local]
    send_idx: np.ndarray     # [P, P, H_t]
    send_mask: np.ndarray    # [P, P, H_t]
    # sorted unique halo keys (pair * N + sender) and their ext slots
    uniq_key: np.ndarray
    uniq_slot: np.ndarray    # ext-space slot (>= n_local) per unique key

    @property
    def n_ext(self) -> int:
        return self.n_local + self.send_idx.shape[0] * self.halo

    def scatter(self, values: np.ndarray, fill=0) -> np.ndarray:
        """[N_t, ...] -> [P, n_local, ...]."""
        P = self.send_idx.shape[0]
        out = np.full((P, self.n_local) + values.shape[1:], fill,
                      dtype=values.dtype)
        valid = self.node_gids >= 0
        out[valid] = values[self.node_gids[valid]]
        return out

    def rank_rows(self, values: np.ndarray, rank: int, fill=0) -> np.ndarray:
        """``scatter(values)[rank]`` without the other ranks' rows:
        [N_t, ...] -> [n_local, ...]."""
        gids = self.node_gids[rank]
        out = np.full((self.n_local,) + values.shape[1:], fill,
                      dtype=values.dtype)
        out[gids >= 0] = values[gids[gids >= 0]]
        return out

    def gather(self, local_values: np.ndarray, num_global: int) -> np.ndarray:
        """[P, n_local, ...] -> [num_global, ...] (rows no rank owns: 0)."""
        out = np.zeros((num_global,) + local_values.shape[2:],
                       local_values.dtype)
        valid = self.node_gids >= 0
        out[self.node_gids[valid]] = local_values[valid]
        return out


@dataclasses.dataclass
class RelPlan:
    e_local: int
    senders_ext: np.ndarray    # [P, e_local] into src-type ext space
    receivers_loc: np.ndarray  # [P, e_local] into dst-type local space
    edge_mask: np.ndarray      # [P, e_local]


@dataclasses.dataclass
class HeteroPartitionPlan:
    num_parts: int
    types: Dict[str, TypePlan]
    rels: Dict[str, RelPlan]

    def extended_hetero_graph(self, rank: int, x_ext: Dict[str, object],
                              kernel_plans: Optional[Dict[str, KernelPlan]]
                              = None) -> HeteroGraph:
        """Partition ``rank``'s ``HeteroGraph`` on the host: ``x_ext[t]``
        its ``[n_ext_t, F_t]`` rows of each type (the owned ones filled,
        the halo ones refreshed by the net), the node mask of the owned
        real rows, each relation's senders into the source type's extended
        rows and owned receivers, and ``kernel_plans``
        (``build_kernel_plans(rank)``)."""
        node_mask = {}
        for t, tp in self.types.items():
            m = np.zeros(tp.n_ext, bool)
            m[:tp.n_local] = tp.node_mask[rank]
            node_mask[t] = torch.from_numpy(m)
        return HeteroGraph(
            nodes={t: torch.as_tensor(np.asarray(x)) for t, x in
                   x_ext.items()},
            node_mask=node_mask,
            senders={k: torch.from_numpy(r.senders_ext[rank])
                     for k, r in self.rels.items()},
            receivers={k: torch.from_numpy(r.receivers_loc[rank])
                       for k, r in self.rels.items()},
            edge_mask={k: torch.from_numpy(r.edge_mask[rank])
                       for k, r in self.rels.items()},
            kernel_plans=kernel_plans)

    def build_kernel_plans(self, rank: int) -> Dict[str, KernelPlan]:
        """Partition ``rank``'s share of JAX's ``build_kernel_plans``: one
        bipartite plan a relation over the source type's ``n_ext`` rows
        and the destination type's ``n_local`` rows (masked padding edges
        dropped), built on host threads (numpy's sorts release the GIL),
        on the host; move them with the graph."""
        def build(key):
            src, _, dst = split_rel_key(key)
            rp = self.rels[key]
            return build_bipartite_kernel_plan(
                rp.senders_ext[rank], rp.receivers_loc[rank],
                self.types[src].n_ext, self.types[dst].n_local,
                edge_mask=rp.edge_mask[rank])

        keys = sorted(self.rels)
        workers = max(1, min(len(keys), os.cpu_count() or 1))
        with ThreadPoolExecutor(workers) as pool:
            return dict(zip(keys, pool.map(build, keys)))


def partition_hetero(num_nodes: Dict[str, int],
                     edges: Dict[str, Tuple[np.ndarray, np.ndarray]],
                     num_parts: int,
                     *,
                     method: str = "bfs",
                     node_multiple: int = 8,
                     edge_multiple: int = 128,
                     halo_multiple: int = 8) -> HeteroPartitionPlan:
    """``num_nodes``: padded per-type node counts (those of the
    ``HeteroGraph`` the single-device path builds, so feature scatter lines
    up); ``edges``: rel_key -> (senders, receivers) in per-type id
    spaces."""
    types = sorted(num_nodes)
    offset, total = {}, 0
    for t in types:
        offset[t] = total
        total += int(num_nodes[t])

    # typed-union graph for the locality order
    us, ur = [], []
    for key, (s, r) in edges.items():
        src, _, dst = split_rel_key(key)
        us.append(np.asarray(s, np.int64) + offset[src])
        ur.append(np.asarray(r, np.int64) + offset[dst])
    us = np.concatenate(us) if us else np.zeros(0, np.int64)
    ur = np.concatenate(ur) if ur else np.zeros(0, np.int64)

    if method == "bfs":
        order = _bfs_order(us, ur, total)
    elif method == "block":
        order = np.arange(total)
    else:
        raise ValueError(f"unknown hetero partition method {method!r}")
    in_deg = np.bincount(ur, minlength=total)

    # per-type degree-balanced contiguous cut of the type-restricted order
    type_of = np.empty(total, np.int64)
    for i, t in enumerate(types):
        type_of[offset[t]:offset[t] + num_nodes[t]] = i
    owner_union = np.empty(total, np.int64)
    for i, t in enumerate(types):
        t_order = order[type_of[order] == i]
        if not len(t_order):   # zero-node type: nothing to assign
            continue
        cw = np.cumsum(in_deg[t_order] + 1)
        bounds = cw[-1] * (np.arange(1, num_parts) / num_parts)
        cuts = np.searchsorted(cw, bounds)
        owner_union[t_order] = np.searchsorted(cuts, np.arange(len(t_order)),
                                               side="right")

    tplans: Dict[str, TypePlan] = {}
    for t in types:
        n_t = int(num_nodes[t])
        owner = owner_union[offset[t]:offset[t] + n_t]
        counts = np.bincount(owner, minlength=num_parts)
        local_index = _cumcount(owner)
        n_local = _round_up(int(counts.max()) + 1, node_multiple)

        # halo: union over relations with src type t of remote
        # (src_owner -> dst_owner, sender) pairs
        keys = []
        for key, (s, r) in edges.items():
            src, _, dst = split_rel_key(key)
            if src != t:
                continue
            s = np.asarray(s, np.int64)
            r = np.asarray(r, np.int64)
            so = owner[s]
            eo = owner_union[offset[dst] + r]
            rem = so != eo
            keys.append((so[rem] * num_parts + eo[rem]) * n_t + s[rem])
        key_all = (np.concatenate(keys) if keys else np.zeros(0, np.int64))
        uniq = np.unique(key_all)
        u_src = uniq // (num_parts * n_t)
        u_dst = (uniq // n_t) % num_parts
        u_sender = uniq % n_t
        pair_counts = np.zeros((num_parts, num_parts), np.int64)
        np.add.at(pair_counts, (u_src, u_dst), 1)
        halo = _round_up(max(int(pair_counts.max()), 1), halo_multiple)
        send_idx = np.zeros((num_parts, num_parts, halo), np.int32)
        send_mask = np.zeros((num_parts, num_parts, halo), bool)
        halo_pos = _cumcount(u_src * num_parts + u_dst)
        send_idx[u_src, u_dst, halo_pos] = \
            local_index[u_sender].astype(np.int32)
        send_mask[u_src, u_dst, halo_pos] = True
        # ext slot per unique halo key: [n_local + src_part * halo + pos]
        uniq_slot = n_local + u_src * halo + halo_pos

        node_gids = np.full((num_parts, n_local), -1, np.int64)
        node_mask = np.zeros((num_parts, n_local), bool)
        node_gids[owner, local_index] = np.arange(n_t)
        node_mask[owner, local_index] = True
        tplans[t] = TypePlan(owner=owner, local_index=local_index,
                             n_local=n_local, halo=halo,
                             node_gids=node_gids, node_mask=node_mask,
                             send_idx=send_idx, send_mask=send_mask,
                             uniq_key=uniq, uniq_slot=uniq_slot)

    rplans: Dict[str, RelPlan] = {}
    for key, (s, r) in edges.items():
        src, _, dst = split_rel_key(key)
        s = np.asarray(s, np.int64)
        r = np.asarray(r, np.int64)
        sp, dp = tplans[src], tplans[dst]
        n_src = int(num_nodes[src])
        so = sp.owner[s]
        eo = dp.owner[r]
        per = np.bincount(eo, minlength=num_parts)
        e_local = _round_up(max(int(per.max()), 1), edge_multiple)
        # pad targets: last local slot of each space (masked, sliced away)
        senders_ext = np.full((num_parts, e_local), sp.n_ext - 1, np.int32)
        receivers_loc = np.full((num_parts, e_local), dp.n_local - 1,
                                np.int32)
        edge_mask = np.zeros((num_parts, e_local), bool)
        epos = _cumcount(eo)
        rem_key = (so * num_parts + eo) * n_src + s
        pos = np.searchsorted(sp.uniq_key, rem_key)
        pos = np.clip(pos, 0, max(len(sp.uniq_key) - 1, 0))
        ext_remote = (sp.uniq_slot[pos] if len(sp.uniq_key)
                      else np.zeros(len(s), np.int64))
        sender_ext = np.where(so == eo, sp.local_index[s], ext_remote)
        senders_ext[eo, epos] = sender_ext.astype(np.int32)
        receivers_loc[eo, epos] = dp.local_index[r].astype(np.int32)
        edge_mask[eo, epos] = True
        rplans[key] = RelPlan(e_local=e_local, senders_ext=senders_ext,
                              receivers_loc=receivers_loc,
                              edge_mask=edge_mask)

    return HeteroPartitionPlan(num_parts=num_parts, types=tplans,
                               rels=rplans)
