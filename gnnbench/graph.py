"""The benchmark's graphs: a frozen copy of the port's synthetic
full-graph generator (``egc_tpu_torch/data/synthetic.py``
``synthetic_full_graph`` with ``_same_class_partner``, and
``egc_tpu_torch/graph/transforms.py`` ``coalesce_np`` /
``to_undirected_np``), so that a later change to the program's generator
leaves the benchmark's inputs as they are.

A homophilous citation-style graph: labels uniform over the classes,
features the class mean plus noise, ``num_nodes * avg_degree // 2``
random edges (a share ``homophily`` to a node of the same class),
self-loops dropped, symmetrised and deduplicated, receiver-sorted; the
splits are a permutation cut at the configuration's shares.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def coalesce_np(senders: np.ndarray, receivers: np.ndarray, num_nodes: int):
    """Sort edges by (receiver, sender) and drop duplicates."""
    key = receivers.astype(np.int64) * num_nodes + senders.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key = key[order]
    keep = np.ones(len(key), dtype=bool)
    keep[1:] = key[1:] != key[:-1]
    idx = order[keep]
    return senders[idx].astype(np.int32), receivers[idx].astype(np.int32)


def to_undirected_np(senders: np.ndarray, receivers: np.ndarray,
                     num_nodes: int):
    """Union of edges and reversed edges, deduplicated, receiver-sorted."""
    return coalesce_np(np.concatenate([senders, receivers]),
                       np.concatenate([receivers, senders]), num_nodes)


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


def synthetic_full_graph(*, num_nodes: int, avg_degree: int,
                         num_classes: int, num_features: int,
                         homophily: float, noise: float,
                         splits: Sequence[float], seed: int
                         ) -> Dict[str, object]:
    """The host graph dict the port's full-graph configs load: ``x``,
    ``y``, ``senders``, ``receivers``, ``{train,val,test}_idx`` and
    ``num_classes``."""
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
    n_tr, n_va = int(splits[0] * num_nodes), int(splits[1] * num_nodes)
    return {
        "x": x, "y": labels, "senders": s, "receivers": r,
        "train_idx": np.sort(idx[:n_tr]),
        "val_idx": np.sort(idx[n_tr:n_tr + n_va]),
        "test_idx": np.sort(idx[n_tr + n_va:]),
        "num_classes": num_classes,
    }
