"""Graph preprocessing transforms (counterpart of ``egc_tpu.graph.transforms``).

Host side (numpy, at ingestion): dedup and symmetrisation, copied from the
JAX package so the port does not import it. Device side (torch): in-degree
and GCN symmetric-normalisation weights.

Self-loops are virtual, as in ``egc_tpu``: the edge list stays fixed and
the self contribution is folded analytically into each reduction, so graphs
are expected to carry no explicit self-loops. ``symnorm_weight`` dedups any
that remain into the one canonical loop (PyG ``add_remaining_self_loops``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def coalesce_np(senders: np.ndarray, receivers: np.ndarray, num_nodes: int):
    """Sort edges by (receiver, sender) and drop duplicates; returns
    ``(senders, receivers, kept_original_index)``."""
    key = receivers.astype(np.int64) * num_nodes + senders.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key = key[order]
    keep = np.ones(len(key), dtype=bool)
    keep[1:] = key[1:] != key[:-1]
    idx = order[keep]
    return senders[idx].astype(np.int32), receivers[idx].astype(np.int32), idx


def to_undirected_np(senders: np.ndarray, receivers: np.ndarray,
                     num_nodes: int):
    """Union of edges and reversed edges, deduplicated and receiver-sorted."""
    s = np.concatenate([senders, receivers])
    r = np.concatenate([receivers, senders])
    s, r, _ = coalesce_np(s, r, num_nodes)
    return s, r


def in_degree(receivers: torch.Tensor, num_nodes: int,
              edge_mask: Optional[torch.Tensor] = None,
              dtype=torch.float32) -> torch.Tensor:
    """Number of valid incoming edges per node (virtual loops excluded)."""
    ones = torch.ones(receivers.shape, dtype=dtype, device=receivers.device)
    if edge_mask is not None:
        ones = ones * edge_mask.to(dtype)
    return torch.zeros(num_nodes, dtype=dtype, device=receivers.device
                       ).index_add_(0, receivers.long(), ones)


def symnorm_weight(senders: torch.Tensor, receivers: torch.Tensor,
                   num_nodes: int, *,
                   edge_mask: Optional[torch.Tensor] = None,
                   add_self_loops: bool = True, dtype=torch.float32):
    """GCN symmetric-normalisation weights (PyG ``gcn_norm`` semantics).

    Returns ``(edge_w [E], self_w [N])`` with
    ``out_i = self_w[i] * x_i + sum_j edge_w[ij] * x_j``. deg_i counts the
    valid non-loop in-edges plus one for the self-loop; masked edges and
    pre-existing loop edges get weight 0 (the loop is deduped into the
    canonical one). With ``add_self_loops=False``, ``self_w`` is zeros.
    """
    senders, receivers = senders.long(), receivers.long()
    if add_self_loops:
        nonloop = senders != receivers
        dmask = nonloop if edge_mask is None else (edge_mask & nonloop)
    else:
        dmask = edge_mask
    deg = in_degree(receivers, num_nodes, dmask, dtype)
    if add_self_loops:
        deg = deg + 1.0
    inv_sqrt = torch.where(deg > 0, torch.rsqrt(deg), torch.zeros_like(deg))
    edge_w = inv_sqrt[senders] * inv_sqrt[receivers]
    if dmask is not None:
        edge_w = torch.where(dmask, edge_w, torch.zeros_like(edge_w))
    if add_self_loops:
        self_w = inv_sqrt * inv_sqrt
    else:
        self_w = torch.zeros(num_nodes, dtype=dtype, device=deg.device)
    return edge_w, self_w
