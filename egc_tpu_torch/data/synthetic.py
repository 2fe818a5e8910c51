"""Synthetic datasets (counterpart of ``egc_tpu.data.synthetic``).

Copies, in numpy, of ``synthetic_full_graph``, ``synthetic_code``,
``synthetic_zinc``, ``synthetic_cifar`` and ``synthetic_molhiv`` (with
``_random_molecule`` and ``_split``): the same seed gives arrays equal to
the JAX package's, so both packages train on the same data.
``synthetic_full_graph(num_nodes=169_343, avg_degree=14, seed=0)`` is the
ogbn-arxiv-shaped graph of the full-graph paths (2,368,458 directed
edges); ``synthetic_code(vocab_size=5000, num_attrs=10030)`` has
ogbg-code2's vocabulary and attribute count. The molecule-shaped sets
(``egc_tpu/data/synthetic.py:33-101``): zinc, 1,200 graphs of 10-37 atoms
of 28 types and a scalar target; cifar, 900 graphs of 80-149 superpixels
with 5 features and 10 classes; molhiv, 1,200 graphs of 10-39 atoms with
the 9 OGB atom features and a binary label; each split 70/15/15 in order.
``synthetic_rmag`` is the heterogeneous ogbn-mag stand-in: four node types
(paper with features, featureless author, institution and
field_of_study) and the seven relations of the reference
(``rmag/models.py:18-26``), coalesced random edges beside a homophilous
paper-cites-paper graph.
"""

from __future__ import annotations

import numpy as np

from egc_tpu_torch.graph.hetero import rel_key
from egc_tpu_torch.graph.transforms import to_undirected_np
from egc_tpu_torch.models.encoders import ATOM_FEATURE_DIMS


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


def synthetic_rmag(num_paper=800, num_author=400, num_inst=40, num_fos=80,
                   num_classes=20, num_features=64, seed=0):
    """Hetero ogbn-mag stand-in (``egc_tpu.data.synthetic.synthetic_rmag``,
    array for array): ``nodes`` (featureless types as ``[n, 0]``),
    ``edges`` by relation key, paper labels and splits."""
    rng = np.random.default_rng(seed)
    base = synthetic_full_graph(num_nodes=num_paper, avg_degree=8,
                                num_classes=num_classes,
                                num_features=num_features, seed=seed)

    def rand_edges(n_src, n_dst, count):
        # coalesced, like the real OGB relations: the max backward gives
        # the full cotangent to every tied edge
        s = rng.integers(0, n_src, count).astype(np.int32)
        r = rng.integers(0, n_dst, count).astype(np.int32)
        return tuple(np.unique(np.stack([s, r]), axis=1))

    aw_s, aw_r = rand_edges(num_author, num_paper, num_paper * 3)
    ai_s, ai_r = rand_edges(num_author, num_inst, num_author)
    ht_s, ht_r = rand_edges(num_paper, num_fos, num_paper * 2)
    edges = {
        rel_key("author", "affiliated_with", "institution"): (ai_s, ai_r),
        rel_key("institution", "to", "author"): (ai_r, ai_s),
        rel_key("author", "writes", "paper"): (aw_s, aw_r),
        rel_key("paper", "to", "author"): (aw_r, aw_s),
        rel_key("paper", "cites", "paper"): (base["senders"],
                                             base["receivers"]),
        rel_key("paper", "has_topic", "field_of_study"): (ht_s, ht_r),
        rel_key("field_of_study", "to", "paper"): (ht_r, ht_s),
    }
    nodes = {
        "paper": base["x"],
        "author": np.zeros((num_author, 0), np.float32),
        "institution": np.zeros((num_inst, 0), np.float32),
        "field_of_study": np.zeros((num_fos, 0), np.float32),
    }
    return {
        "nodes": nodes, "edges": edges, "y": base["y"],
        "train_idx": base["train_idx"], "val_idx": base["val_idx"],
        "test_idx": base["test_idx"], "num_classes": num_classes,
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


def _random_molecule(rng, n, num_types, extra_edge_frac=0.3):
    """Connected molecule-like graph: a ring + random chords, undirected."""
    types = rng.integers(0, num_types, n)
    ring_s = np.arange(n, dtype=np.int32)
    ring_r = (ring_s + 1) % n
    n_extra = max(int(n * extra_edge_frac), 1)
    ex_s = rng.integers(0, n, n_extra).astype(np.int32)
    ex_r = rng.integers(0, n, n_extra).astype(np.int32)
    s = np.concatenate([ring_s, ex_s])
    r = np.concatenate([ring_r, ex_r])
    keep = s != r
    s, r = to_undirected_np(s[keep], r[keep], n)
    return types, s, r


def synthetic_zinc(num_graphs=1200, seed=0, num_types=28):
    """ZINC stand-in: atom types ``[N, 1]`` int32 and a learnable scalar
    target from the type and degree statistics."""
    rng = np.random.default_rng(seed)
    type_w = np.random.default_rng(99).normal(size=(num_types,))
    graphs = []
    for _ in range(num_graphs):
        n = int(rng.integers(10, 38))
        types, s, r = _random_molecule(rng, n, num_types)
        deg = np.zeros(n)
        np.add.at(deg, r, 1.0)
        y = float(type_w[types].mean() + 0.2 * deg.std() + 0.1 * len(s) / n)
        graphs.append({
            "nodes": types.astype(np.int32).reshape(n, 1),
            "senders": s, "receivers": r,
            "y": np.array([y], np.float32),
        })
    return _split(graphs)


def synthetic_cifar(num_graphs=900, seed=0):
    """CIFAR10-superpixel stand-in: 5 float features (colour and position)
    a node, dense chords, the class a linear function of the mean
    feature."""
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(7).normal(size=(5, 10))
    graphs = []
    for _ in range(num_graphs):
        n = int(rng.integers(80, 150))
        feats = rng.normal(size=(n, 5)).astype(np.float32)
        _, s, r = _random_molecule(rng, n, 2, extra_edge_frac=3.0)
        label = int(np.argmax(feats.mean(0) @ w))
        graphs.append({
            "nodes": feats, "senders": s, "receivers": r,
            "y": np.array([label], np.int32),
        })
    return _split(graphs)


def synthetic_molhiv(num_graphs=1200, seed=0):
    """ogbg-molhiv stand-in: the 9 categorical OGB atom features ``[N, 9]``
    int32 and a balanced binary label."""
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(13).normal(size=(len(ATOM_FEATURE_DIMS),))
    graphs = []
    for _ in range(num_graphs):
        n = int(rng.integers(10, 40))
        feats = np.stack(
            [rng.integers(0, d, n) for d in ATOM_FEATURE_DIMS], axis=1
        ).astype(np.int32)
        _, s, r = _random_molecule(rng, n, 2)
        score = ((feats.mean(0) / np.asarray(ATOM_FEATURE_DIMS)) - 0.5) @ w
        label = int(score > 0.0)
        graphs.append({
            "nodes": feats, "senders": s, "receivers": r,
            "y": np.array([label], np.int32),
        })
    return _split(graphs)


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
