"""Synthetic full graph (counterpart of ``egc_tpu.data.synthetic``).

A copy of ``synthetic_full_graph`` in numpy: the same seed gives arrays
equal to the JAX package's, so both packages train on the same graph.
``synthetic_full_graph(num_nodes=169_343, avg_degree=14, seed=0)`` is the
ogbn-arxiv-shaped graph of the main path (2,368,458 directed edges).
"""

from __future__ import annotations

import numpy as np

from egc_tpu_torch.graph.transforms import to_undirected_np


def synthetic_full_graph(num_nodes=4000, avg_degree=12, num_classes=40,
                         num_features=128, homophily=0.7, seed=0,
                         noise=0.8):
    """Homophilous citation-style graph (arxiv/mag stand-in), undirected."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, num_nodes).astype(np.int32)
    mu = rng.normal(size=(num_classes, num_features)).astype(np.float32)
    x = (mu[labels] + noise * rng.normal(size=(num_nodes, num_features))
         ).astype(np.float32)
    num_edges = num_nodes * avg_degree // 2
    src = rng.integers(0, num_nodes, num_edges).astype(np.int32)
    same = rng.random(num_edges) < homophily
    dst = np.where(
        same,
        _same_class_partner(rng, labels, src, num_classes),
        rng.integers(0, num_nodes, num_edges).astype(np.int32),
    ).astype(np.int32)
    keep = src != dst
    s, r = to_undirected_np(src[keep], dst[keep], num_nodes)

    idx = rng.permutation(num_nodes)
    n_tr, n_va = int(0.6 * num_nodes), int(0.2 * num_nodes)
    return {
        "x": x, "y": labels, "senders": s, "receivers": r,
        "train_idx": np.sort(idx[:n_tr]),
        "val_idx": np.sort(idx[n_tr:n_tr + n_va]),
        "test_idx": np.sort(idx[n_tr + n_va:]),
        "num_classes": num_classes,
    }


def _same_class_partner(rng, labels, src, num_classes):
    """For each source node, a random node of the same class."""
    order = np.argsort(labels, kind="stable")
    sorted_labels = labels[order]
    starts = np.searchsorted(sorted_labels, np.arange(num_classes), "left")
    ends = np.searchsorted(sorted_labels, np.arange(num_classes), "right")
    c = labels[src]
    span = np.maximum(ends[c] - starts[c], 1)
    pick = starts[c] + (rng.random(len(src)) * span).astype(np.int64)
    return order[np.minimum(pick, len(order) - 1)]
