"""Heterogeneous (typed) graph container for the rmag task (counterpart of
``egc_tpu.graph.hetero``).

Per node type a padded feature tensor and mask; per relation (the
"src__rel__dst" key) a padded COO edge list whose senders index the
source-type rows and receivers the destination-type rows. The padding is
``egc_tpu``'s: ``n + 1`` rows rounded to 8 a type, edges rounded to 128
a relation, pad edges masked and pointing at the last (padding) row of
each side. The featureless types' embedding tables have the padded row
count, so a JAX net's ``emb_{t}`` loads as it is.

``attach_hetero_kernel_plans`` builds one bipartite ``KernelPlan`` a
relation (``ops.dispatch.build_bipartite_kernel_plan``) on the host; the
hetero convs need them on a CUDA tensor.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def rel_key(src: str, rel: str, dst: str) -> str:
    return f"{src}__{rel}__{dst}"


def split_rel_key(key: str) -> Tuple[str, str, str]:
    src, rel, dst = key.split("__")
    return src, rel, dst


@dataclasses.dataclass
class HeteroGraph:
    """Dicts keyed by node type / relation key; tensors throughout."""

    nodes: Dict[str, torch.Tensor]       # type -> [N_t, F] ([N_t, 0] for a
    #                                      featureless type)
    node_mask: Dict[str, torch.Tensor]   # type -> [N_t] bool
    senders: Dict[str, torch.Tensor]     # key -> [E_r] int32, src rows
    receivers: Dict[str, torch.Tensor]   # key -> [E_r] int32, dst rows
    edge_mask: Dict[str, torch.Tensor]   # key -> [E_r] bool
    # key -> ops.dispatch.KernelPlan over (src rows, dst rows)
    kernel_plans: Optional[Dict[str, object]] = None

    @property
    def node_types(self) -> List[str]:
        return sorted(self.node_mask)

    @property
    def relations(self) -> List[str]:
        return sorted(self.senders)

    def num_nodes(self, ntype: str) -> int:
        return self.node_mask[ntype].shape[0]

    def replace(self, **changes) -> "HeteroGraph":
        return dataclasses.replace(self, **changes)

    def to(self, device, non_blocking: bool = False) -> "HeteroGraph":
        def move(d):
            return None if d is None else {
                k: v.to(device, non_blocking=non_blocking)
                for k, v in d.items()}
        return HeteroGraph(**{f.name: move(getattr(self, f.name))
                              for f in dataclasses.fields(self)})


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def hetero_from_numpy(nodes: Dict[str, np.ndarray],
                      edges: Dict[str, Tuple[np.ndarray, np.ndarray]],
                      *, node_multiple: int = 8,
                      edge_multiple: int = 128) -> HeteroGraph:
    """Pad per-type / per-relation host arrays (``egc_tpu``'s layout) into
    a CPU ``HeteroGraph``."""
    padded_nodes, masks, n_pad = {}, {}, {}
    for t, x in nodes.items():
        n = x.shape[0]
        n_pad[t] = _round_up(n + 1, node_multiple)
        padded = np.zeros((n_pad[t],) + x.shape[1:], x.dtype)
        padded[:n] = x
        m = np.zeros(n_pad[t], bool)
        m[:n] = True
        padded_nodes[t], masks[t] = torch.from_numpy(padded), \
            torch.from_numpy(m)

    senders, receivers, emasks = {}, {}, {}
    for key, (s, r) in edges.items():
        src, _, dst = split_rel_key(key)
        e = len(s)
        ep = _round_up(max(e, 1), edge_multiple)
        ss = np.full(ep, n_pad[src] - 1, np.int32)
        rr = np.full(ep, n_pad[dst] - 1, np.int32)
        ss[:e] = s
        rr[:e] = r
        em = np.zeros(ep, bool)
        em[:e] = True
        senders[key], receivers[key], emasks[key] = (
            torch.from_numpy(ss), torch.from_numpy(rr), torch.from_numpy(em))
    return HeteroGraph(nodes=padded_nodes, node_mask=masks, senders=senders,
                       receivers=receivers, edge_mask=emasks)


def attach_hetero_kernel_plans(hg: HeteroGraph) -> HeteroGraph:
    """One bipartite kernel plan a relation over the padded source and
    destination row counts, built on the host from a CPU graph (masked
    edges dropped), the relations on threads of their own (numpy's sorts
    release the GIL); move the graph to the card afterwards."""
    from egc_tpu_torch.ops.dispatch import build_bipartite_kernel_plan

    def build(key):
        src, _, dst = split_rel_key(key)
        return build_bipartite_kernel_plan(
            hg.senders[key].numpy(), hg.receivers[key].numpy(),
            hg.num_nodes(src), hg.num_nodes(dst),
            edge_mask=hg.edge_mask[key].numpy())

    keys = hg.relations
    workers = max(1, min(len(keys), os.cpu_count() or 1))
    with ThreadPoolExecutor(workers) as pool:
        plans = dict(zip(keys, pool.map(build, keys)))
    return hg.replace(kernel_plans=plans)
