"""Static-shape graph container (counterpart of ``egc_tpu.graph.structure``).

The fields and the padding convention are ``egc_tpu``'s: ``senders`` and
``receivers`` are int32 COO endpoints (messages flow sender -> receiver),
``node_mask`` / ``edge_mask`` mark the real rows, and padded edges point at
the last (padding) node. Fields are torch tensors; ``Graph.to`` moves them
all, the kernel plan included.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch


def _as_tensor(x, dtype=None) -> Optional[torch.Tensor]:
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@dataclasses.dataclass
class Graph:
    nodes: torch.Tensor                  # [N, ...] node features
    senders: torch.Tensor                # [E] int32
    receivers: torch.Tensor              # [E] int32
    node_mask: torch.Tensor              # [N] bool
    edge_mask: torch.Tensor              # [E] bool
    graph_ids: torch.Tensor              # [N] int32
    graph_mask: torch.Tensor             # [G] bool
    edges: Optional[torch.Tensor] = None          # [E, ...] edge features
    edge_weight: Optional[torch.Tensor] = None    # [E] precomputed symnorm
    self_weight: Optional[torch.Tensor] = None    # [N] its self-loop weight
    kernel_plan: Optional[Any] = None    # ops.dispatch.KernelPlan

    @property
    def num_nodes(self) -> int:
        return self.node_mask.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_mask.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[0]

    def replace(self, **changes) -> "Graph":
        return dataclasses.replace(self, **changes)

    def to(self, device, non_blocking: bool = False) -> "Graph":
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            moved[f.name] = None if v is None else v.to(
                device, non_blocking=non_blocking)
        return Graph(**moved)

    def pin_memory(self) -> "Graph":
        """Every tensor (the kernel plan's too) in page-locked host memory,
        so that ``to(cuda, non_blocking=True)`` copies without a stall."""
        pinned = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            pinned[f.name] = None if v is None else v.pin_memory()
        return Graph(**pinned)

    @staticmethod
    def from_coo(nodes, senders, receivers, *, edges=None, edge_weight=None,
                 num_nodes: Optional[int] = None) -> "Graph":
        """One unpadded graph (the full-graph training path)."""
        nodes = _as_tensor(nodes)
        n = int(nodes.shape[0]) if num_nodes is None else num_nodes
        senders = _as_tensor(senders, torch.int32)
        dev = senders.device
        return Graph(
            nodes=nodes,
            senders=senders,
            receivers=_as_tensor(receivers, torch.int32),
            node_mask=torch.ones(n, dtype=torch.bool, device=dev),
            edge_mask=torch.ones(senders.shape[0], dtype=torch.bool,
                                 device=dev),
            graph_ids=torch.zeros(n, dtype=torch.int32, device=dev),
            graph_mask=torch.ones(1, dtype=torch.bool, device=dev),
            edges=_as_tensor(edges),
            edge_weight=_as_tensor(edge_weight),
        )


def pad_graph(g: Graph, *, num_nodes: int, num_edges: int,
              num_graphs: Optional[int] = None) -> Graph:
    """Pad to fixed sizes: padded edges point at the last (padding) node,
    padded nodes belong to the last (padding) graph, features and weights
    pad with zeros. Padding edges need at least one padding node."""
    n, e, gcount = g.num_nodes, g.num_edges, g.num_graphs
    num_graphs = gcount if num_graphs is None else num_graphs
    if num_nodes < n or num_edges < e or num_graphs < gcount:
        raise ValueError(
            f"pad_graph target sizes ({num_nodes},{num_edges},{num_graphs}) "
            f"smaller than actual ({n},{e},{gcount})")
    dn, de, dg = num_nodes - n, num_edges - e, num_graphs - gcount
    if de > 0 and dn == 0:
        raise ValueError("padding edges require at least one padding node")

    def pad_rows(x, count, value=0):
        if x is None or count == 0:
            return x
        pad = torch.full((count,) + tuple(x.shape[1:]), value, dtype=x.dtype,
                         device=x.device)
        return torch.cat([x, pad])

    last = num_nodes - 1
    return Graph(
        nodes=pad_rows(g.nodes, dn),
        senders=pad_rows(g.senders, de, last),
        receivers=pad_rows(g.receivers, de, last),
        node_mask=pad_rows(g.node_mask, dn, False),
        edge_mask=pad_rows(g.edge_mask, de, False),
        graph_ids=pad_rows(g.graph_ids, dn, max(num_graphs - 1, 0)),
        graph_mask=pad_rows(g.graph_mask, dg, False),
        edges=pad_rows(g.edges, de),
        edge_weight=pad_rows(g.edge_weight, de),
        self_weight=pad_rows(g.self_weight, dn),
        kernel_plan=g.kernel_plan,
    )


def batch_np(graphs: Sequence[dict], *, num_nodes: int, num_edges: int,
             num_graphs: int) -> Tuple[Graph, Optional[np.ndarray]]:
    """Concatenate host graph dicts (``nodes``, ``senders``, ``receivers``
    and optionally ``edges`` and ``y``, numpy arrays) into one padded
    batch, as ``egc_tpu.graph.structure.batch_np`` does: graph i's
    endpoints shift by the nodes before it, padding nodes and edges go to
    the last (padding) graph and node. Returns ``(Graph, ys)``: ``ys`` is
    the ``[num_graphs, ...]`` zero-padded numpy labels (or None).

    ``num_graphs`` must exceed ``len(graphs)`` (one padding graph slot),
    and ``num_nodes`` the total node count whenever padding edges are
    needed."""
    if len(graphs) >= num_graphs:
        raise ValueError("need at least one padding graph slot")
    nodes, senders, receivers, edges, gids, ys = [], [], [], [], [], []
    offset = 0
    for i, gd in enumerate(graphs):
        nd = np.asarray(gd["nodes"])
        nodes.append(nd)
        senders.append(np.asarray(gd["senders"], dtype=np.int32) + offset)
        receivers.append(np.asarray(gd["receivers"], dtype=np.int32) + offset)
        if gd.get("edges") is not None:
            edges.append(np.asarray(gd["edges"]))
        gids.append(np.full((nd.shape[0],), i, dtype=np.int32))
        if gd.get("y") is not None:
            ys.append(np.asarray(gd["y"]))
        offset += nd.shape[0]
    s = np.concatenate(senders).astype(np.int32)
    g = Graph(
        nodes=torch.from_numpy(np.concatenate(nodes, axis=0)),
        senders=torch.from_numpy(s),
        receivers=torch.from_numpy(np.concatenate(receivers).astype(np.int32)),
        node_mask=torch.ones(offset, dtype=torch.bool),
        edge_mask=torch.ones(len(s), dtype=torch.bool),
        graph_ids=torch.from_numpy(np.concatenate(gids)),
        graph_mask=torch.ones(len(graphs), dtype=torch.bool),
        edges=torch.from_numpy(np.concatenate(edges, axis=0))
        if edges else None)
    g = pad_graph(g, num_nodes=num_nodes, num_edges=num_edges,
                  num_graphs=num_graphs)
    y_out = None
    if ys:
        y_arr = np.stack(ys, axis=0)
        y_out = np.pad(y_arr, [(0, num_graphs - y_arr.shape[0])]
                       + [(0, 0)] * (y_arr.ndim - 1))
    return g, y_out
