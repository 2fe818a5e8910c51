"""Synthetic datasets (counterpart of ``egc_tpu.data.synthetic``).

Copies, in numpy, of ``synthetic_full_graph`` and ``synthetic_code`` (with
its ``_split``): the same seed gives arrays equal to the JAX package's, so
both packages train on the same data.
``synthetic_full_graph(num_nodes=169_343, avg_degree=14, seed=0)`` is the
ogbn-arxiv-shaped graph of the full-graph paths (2,368,458 directed
edges); ``synthetic_code(vocab_size=5000, num_attrs=10030)`` has
ogbg-code2's vocabulary and attribute count.
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


def synthetic_code(num_graphs=900, seed=0, vocab_size=120, seq_len=5,
                   num_types=98, num_attrs=500, max_depth=20):
    """ogbg-code2 stand-in: random ASTs of 20-119 nodes (child -> parent
    edges), nodes ``[N, 3]`` int32 (type, attribute, depth clamped to
    ``max_depth``), and a 5-token target ``y`` learnable from the type
    histogram; split 70/15/15 in order."""
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(21).normal(size=(num_types, vocab_size + 2))
    graphs = []
    for _ in range(num_graphs):
        n = int(rng.integers(20, 120))
        # random tree: parent[i] < i
        parents = np.array([rng.integers(0, max(i, 1)) for i in range(1, n)],
                           dtype=np.int32)
        s = np.arange(1, n, dtype=np.int32)      # child -> parent AST edges
        r = parents
        depth = np.zeros(n, np.int32)
        for i in range(1, n):
            depth[i] = depth[parents[i - 1]] + 1
        types = rng.integers(0, num_types, n).astype(np.int32)
        attrs = rng.integers(0, num_attrs, n).astype(np.int32)
        hist = np.bincount(types, minlength=num_types).astype(np.float64)
        tokens = np.argsort(-(hist @ w))[:seq_len].astype(np.int32)
        graphs.append({
            "nodes": np.stack([types, attrs, np.minimum(depth, max_depth)],
                              1),
            "senders": s, "receivers": r,
            "y": tokens,
        })
    return _split(graphs)


def _split(graphs, frac_train=0.7, frac_val=0.15):
    n = len(graphs)
    n_tr, n_va = int(n * frac_train), int(n * frac_val)
    return {
        "train": graphs[:n_tr],
        "val": graphs[n_tr:n_tr + n_va],
        "test": graphs[n_tr + n_va:],
    }
