"""On-disk readers for the real datasets (counterpart of
``egc_tpu.data.ondisk``).

They read local files only, already in the standard layouts under
``data_location()`` (``$DATASET_LOC``, default ``~/datasets``, the
reference's key, ``experiments/utils.py:20-27``):

- OGB node property sets: ogbn-arxiv as ``<root>/ogbn_arxiv/raw/{edge,
  node-feat,node-label}.csv.gz`` and ``split/time/{train,valid,test}
  .csv.gz``; ogbn-mag's paper-cites-paper graph as ``<root>/ogbn_mag/raw/
  node-feat/paper``, ``node-label/paper``, ``relations/
  paper___cites___paper`` and ``split/time/paper``, and the whole
  heterogeneous set (``load_ogbn_mag_hetero``: the four relations under
  ``relations/``, ``num-node-dict.json``);
- OGB graph property sets (``ogbg_molhiv``, ``ogbg_code2``): ``raw/``
  ``num-node-list``, ``num-edge-list``, ``edge``, ``node-feat`` and
  ``graph-label`` (code2 also ``node_is_attributed`` and ``node_depth``),
  with the ``scaffold`` / ``project`` splits;
- ZINC as PyG's raw ``ZINC/raw/{train,val,test}.pickle`` with the subset
  index files; CIFAR10 superpixels as ``CIFAR10/raw/CIFAR10_{train,val,
  test}.pt``.

The CSV parse is the port's native parser (``egc_tpu_torch.native``, a
copy of ``egc_tpu.native``'s: multithreaded, a float32 rounded once from
the text), and the first parse of a file leaves a ``<file>.npy`` cache
beside it. code2's preprocessing is the reference's
(``experiments/code/utils.py``): the top-5000 vocabulary of the train
targets (+ UNK, + EOS), the AST edge augmentation and the 5-token target.
"""

from __future__ import annotations

import gzip
import json
import os
import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from egc_tpu_torch.graph.hetero import rel_key
from egc_tpu_torch.graph.transforms import to_undirected_np
from egc_tpu_torch.native import csv_rows_consistent, parse_csv_bytes


def data_location() -> Path:
    return Path(os.environ.get("DATASET_LOC", str(Path.home() / "datasets")))


def _parse_csv_bytes(data: bytes, dtype) -> np.ndarray:
    """Decompressed numeric CSV text -> [rows, cols] through the native
    parser (``egc_tpu_torch.native``): every row must have the first
    row's number of fields, and every field must be a number."""
    text = data.strip()
    if not text:
        return np.zeros((0, 1), dtype)
    cols = text.split(b"\n", 1)[0].count(b",") + 1
    rows = csv_rows_consistent(data, cols)
    if rows < 0:
        raise ValueError(f"CSV rows differ from the first row's {cols} "
                         "fields")
    flat = parse_csv_bytes(data, dtype)
    if flat.size != rows * cols:
        raise ValueError(f"CSV holds {flat.size} fields, not {rows} rows "
                         f"of {cols}")
    return flat.reshape(rows, cols)


def _read_csv_gz(path: Path, dtype=np.int64) -> np.ndarray:
    """Read a (gzipped) numeric CSV, with an ``.npy`` sidecar cache: the
    first parse writes ``<file>.npy`` next to the source (best effort) and
    later loads read it while it is newer than the source."""
    path = Path(path)
    cache = Path(str(path) + ".npy")
    if cache.exists() and cache.stat().st_mtime >= path.stat().st_mtime:
        arr = np.load(cache, allow_pickle=False)
        if arr.dtype == np.dtype(dtype):
            return arr
    if path.suffix == ".gz":
        with gzip.open(path, "rb") as f:
            data = f.read()
    else:
        data = path.read_bytes()
    arr = _parse_csv_bytes(data, dtype)
    del data
    try:
        # atomic: a concurrent reader never loads a half-written cache
        tmp = cache.with_name(f"{cache.name}.tmp{os.getpid()}.npy")
        np.save(tmp, arr)
        os.replace(tmp, cache)
    except OSError:
        pass  # a read-only dataset mount
    return arr


def load_ogbn_arxiv(root: Optional[Path] = None) -> Dict:
    """ogbn-arxiv as a host full-graph dict (``x``, ``y``, the undirected
    ``senders`` / ``receivers``, the time split's ``*_idx`` and
    ``num_classes``), as ``egc_tpu.data.ondisk.load_ogbn_arxiv`` gives it."""
    root = (root or data_location()) / "ogbn_arxiv"
    raw = root / "raw"
    edges = _read_csv_gz(raw / "edge.csv.gz")            # [E, 2] directed
    x = _read_csv_gz(raw / "node-feat.csv.gz", np.float32)
    y = _read_csv_gz(raw / "node-label.csv.gz").reshape(-1).astype(np.int32)
    n = x.shape[0]
    # the reference applies to_undirected (arxiv/configs.py:100)
    s, r = to_undirected_np(edges[:, 0].astype(np.int32),
                            edges[:, 1].astype(np.int32), n)
    split_dir = root / "split" / "time"
    splits = {k: _read_csv_gz(split_dir / f"{v}.csv.gz").reshape(-1)
              for k, v in (("train", "train"), ("val", "valid"),
                           ("test", "test"))}
    return {"x": x, "y": y, "senders": s, "receivers": r,
            "train_idx": splits["train"], "val_idx": splits["val"],
            "test_idx": splits["test"], "num_classes": int(y.max()) + 1}


def load_ogbn_mag_homogeneous(root: Optional[Path] = None) -> Dict:
    """ogbn-mag's paper-cites-paper graph, symmetrised (reference
    ``mag/configs.py:77-88``), as a host full-graph dict like
    ``load_ogbn_arxiv``'s."""
    root = (root or data_location()) / "ogbn_mag"
    raw = root / "raw"
    x = _read_csv_gz(raw / "node-feat" / "paper" / "node-feat.csv.gz",
                     np.float32)
    y = _read_csv_gz(raw / "node-label" / "paper" / "node-label.csv.gz"
                     ).reshape(-1).astype(np.int32)
    edges = _read_csv_gz(
        raw / "relations" / "paper___cites___paper" / "edge.csv.gz")
    n = x.shape[0]
    s, r = to_undirected_np(edges[:, 0].astype(np.int32),
                            edges[:, 1].astype(np.int32), n)
    splits = _load_split(root, "time/paper")
    return {"x": x, "y": y, "senders": s, "receivers": r,
            "train_idx": splits["train"], "val_idx": splits["val"],
            "test_idx": splits["test"], "num_classes": int(y.max()) + 1}


def load_ogbn_mag_hetero(root: Optional[Path] = None) -> Dict:
    """The whole heterogeneous ogbn-mag (reference ``rmag/configs.py``), as
    ``egc_tpu.data.ondisk.load_ogbn_mag_hetero`` gives it: paper features,
    three featureless types (``[n, 0]``), the four raw relations and the
    reverse ("to") of each, paper-cites-paper symmetrised within its own
    key; labels, the time split and the class count."""
    root = (root or data_location()) / "ogbn_mag"
    raw = root / "raw"
    x_paper = _read_csv_gz(raw / "node-feat" / "paper" / "node-feat.csv.gz",
                           np.float32)
    y_paper = _read_csv_gz(raw / "node-label" / "paper" / "node-label.csv.gz"
                           ).reshape(-1).astype(np.int32)
    nodes_file = raw / "num-node-dict.json"
    counts = {k: int(v) for k, v in json.loads(
        nodes_file.read_text()).items()} if nodes_file.exists() else {}
    rels = (("author", "affiliated_with", "institution"),
            ("author", "writes", "paper"), ("paper", "cites", "paper"),
            ("paper", "has_topic", "field_of_study"))
    edges, max_id = {}, {}
    for src, rel, dst in rels:
        e = _read_csv_gz(raw / "relations" / f"{src}___{rel}___{dst}"
                         / "edge.csv.gz")
        s, r = e[:, 0].astype(np.int32), e[:, 1].astype(np.int32)
        max_id[src] = max(max_id.get(src, 0), int(s.max()) + 1)
        max_id[dst] = max(max_id.get(dst, 0), int(r.max()) + 1)
        if src == dst:
            edges[rel_key(src, rel, dst)] = (
                np.concatenate([s, r]), np.concatenate([r, s]))
        else:
            edges[rel_key(src, rel, dst)] = (s, r)
            edges[rel_key(dst, "to", src)] = (r, s)
    n_of = {t: counts.get(t, max_id.get(t, 1)) for t in
            ("paper", "author", "institution", "field_of_study")}
    n_of["paper"] = max(n_of["paper"], x_paper.shape[0])
    nodes = {"paper": x_paper}
    for t in ("author", "institution", "field_of_study"):
        nodes[t] = np.zeros((n_of[t], 0), np.float32)
    splits = _load_split(root, "time/paper")
    return {"nodes": nodes, "edges": edges, "y": y_paper,
            "train_idx": splits["train"], "val_idx": splits["val"],
            "test_idx": splits["test"],
            "num_classes": int(y_paper.max()) + 1}


def _load_ogbg_raw(root: Path):
    """The graph-property layout's per-graph node and edge offsets."""
    raw = root / "raw"
    num_nodes = _read_csv_gz(raw / "num-node-list.csv.gz").reshape(-1)
    num_edges = _read_csv_gz(raw / "num-edge-list.csv.gz").reshape(-1)
    edges = _read_csv_gz(raw / "edge.csv.gz")
    node_feat = _read_csv_gz(raw / "node-feat.csv.gz")
    node_off = np.concatenate([[0], np.cumsum(num_nodes)])
    edge_off = np.concatenate([[0], np.cumsum(num_edges)])
    return raw, num_nodes, edges, node_feat, node_off, edge_off


def _load_split(root: Path, split_type: str) -> Dict[str, np.ndarray]:
    split_dir = root / "split" / split_type
    return {k: _read_csv_gz(split_dir / f"{v}.csv.gz").reshape(-1)
            for k, v in (("train", "train"), ("val", "valid"),
                         ("test", "test"))}


def _by_split(graphs: List[dict], split) -> Dict[str, List[dict]]:
    return {k: [graphs[i] for i in split[k]] for k in ("train", "val",
                                                      "test")}


def load_ogbg_molhiv(root: Optional[Path] = None) -> Dict[str, List[dict]]:
    """ogbg-molhiv: per graph its 9 atom features, local edge ids and the
    label, split by scaffold."""
    root = (root or data_location()) / "ogbg_molhiv"
    raw, num_nodes, edges, node_feat, node_off, edge_off = \
        _load_ogbg_raw(root)
    labels = _read_csv_gz(raw / "graph-label.csv.gz").reshape(-1)
    graphs = []
    for i in range(len(num_nodes)):
        ns, ne = node_off[i], node_off[i + 1]
        es, ee = edge_off[i], edge_off[i + 1]
        graphs.append({
            "nodes": node_feat[ns:ne].astype(np.int32),
            "senders": edges[es:ee, 0].astype(np.int32),
            "receivers": edges[es:ee, 1].astype(np.int32),
            "y": np.array([labels[i]], np.int32),
        })
    return _by_split(graphs, _load_split(root, "scaffold"))


def augment_ast_edges_np(senders, receivers, is_attributed):
    """Reference ``augment_edge`` (``code/utils.py:74-145``), connectivity
    only: AST + inverse-AST + next-token + inverse-next-token edges (nodes
    are in DFS order)."""
    att = np.where(is_attributed.reshape(-1) == 1)[0].astype(np.int32)
    nt_s, nt_r = att[:-1], att[1:]
    s = np.concatenate([senders, receivers, nt_s, nt_r])
    r = np.concatenate([receivers, senders, nt_r, nt_s])
    return s.astype(np.int32), r.astype(np.int32)


def build_vocab(train_seqs: List[List[str]], num_vocab: int = 5000):
    """Reference ``get_vocab_mapping`` (``code/utils.py:31-71``): the
    ``num_vocab`` most frequent words, ties in order of first appearance,
    then ``__UNK__`` and ``__EOS__``."""
    vocab_cnt: Dict[str, int] = {}
    vocab_list: List[str] = []
    for seq in train_seqs:
        for w in seq:
            if w in vocab_cnt:
                vocab_cnt[w] += 1
            else:
                vocab_cnt[w] = 1
                vocab_list.append(w)
    cnt = np.array([vocab_cnt[w] for w in vocab_list])
    top = np.argsort(-cnt, kind="stable")[:num_vocab]
    idx2vocab = [vocab_list[i] for i in top] + ["__UNK__", "__EOS__"]
    vocab2idx = {w: i for i, w in enumerate(idx2vocab)}
    return vocab2idx, idx2vocab


def encode_seq(seq: List[str], vocab2idx, seq_len: int = 5) -> np.ndarray:
    """The first ``seq_len`` words as ids (``__UNK__`` for unknown ones),
    padded with ``__EOS__``."""
    unk = vocab2idx["__UNK__"]
    out = seq[:seq_len] + ["__EOS__"] * max(0, seq_len - len(seq))
    return np.array([vocab2idx.get(w, unk) for w in out], np.int32)


def decode_arr(arr, idx2vocab) -> List[str]:
    """Reference ``decode_arr_to_seq``: the words up to the first
    ``__EOS__``."""
    eos = len(idx2vocab) - 1
    out = []
    for t in arr:
        if int(t) == eos:
            break
        out.append(idx2vocab[int(t)])
    return out


def load_ogbg_code2(root: Optional[Path] = None, num_vocab: int = 5000,
                    seq_len: int = 5) -> Dict:
    """ogbg-code2: per graph the (type, attribute, depth clamped to 20)
    node rows, the augmented AST edges, the encoded target and its words
    (``y_raw``), split by project; with the vocabulary both ways."""
    root = (root or data_location()) / "ogbg_code2"
    raw, num_nodes, edges, node_feat, node_off, edge_off = \
        _load_ogbg_raw(root)
    is_att = _read_csv_gz(raw / "node_is_attributed.csv.gz").reshape(-1)
    depth = _read_csv_gz(raw / "node_depth.csv.gz").reshape(-1)
    # one method name per graph, its subtokens comma-separated
    with gzip.open(raw / "graph-label.csv.gz", "rt") as f:
        seqs = [line.strip().split(",") for line in f]
    split = _load_split(root, "project")
    vocab2idx, idx2vocab = build_vocab(
        [seqs[i] for i in split["train"]], num_vocab)
    graphs = []
    for i in range(len(num_nodes)):
        ns, ne = node_off[i], node_off[i + 1]
        es, ee = edge_off[i], edge_off[i + 1]
        s, r = augment_ast_edges_np(
            edges[es:ee, 0].astype(np.int32),
            edges[es:ee, 1].astype(np.int32), is_att[ns:ne])
        nodes = np.stack([
            node_feat[ns:ne, 0], node_feat[ns:ne, 1],
            np.minimum(depth[ns:ne], 20)], axis=1).astype(np.int32)
        graphs.append({
            "nodes": nodes, "senders": s, "receivers": r,
            "y": encode_seq(seqs[i], vocab2idx, seq_len),
            "y_raw": seqs[i],
        })
    return {"splits": _by_split(graphs, split), "vocab2idx": vocab2idx,
            "idx2vocab": idx2vocab}


def load_cifar10_superpixels(root: Optional[Path] = None
                             ) -> Dict[str, List[dict]]:
    """CIFAR10 superpixel graphs (reference ``cifar/configs.py:37-45``:
    ``GNNBenchmarkDataset`` with ``pos`` concatenated onto ``x``, 5
    features). Each ``CIFAR10_{split}.pt`` is a list of per-graph dicts or
    objects with ``x`` [N, 3], ``pos`` [N, 2], ``edge_index`` [2, E] and
    ``y``."""
    import torch

    raw = (root or data_location()) / "CIFAR10" / "raw"
    out: Dict[str, List[dict]] = {}
    for split in ("train", "val", "test"):
        items = torch.load(raw / f"CIFAR10_{split}.pt", map_location="cpu",
                           weights_only=False)
        graphs = []
        for it in items:
            get = it.get if isinstance(it, dict) else \
                (lambda k, _it=it: getattr(_it, k, None))
            x = np.asarray(get("x"), np.float32)
            pos = np.asarray(get("pos"), np.float32)
            ei = np.asarray(get("edge_index"), np.int64)
            graphs.append({
                "nodes": np.concatenate([x, pos], axis=1),
                "senders": ei[0].astype(np.int32),
                "receivers": ei[1].astype(np.int32),
                "y": np.asarray(get("y")).reshape(-1)[:1].astype(np.int32),
            })
        out[split] = graphs
    return out


def load_zinc(root: Optional[Path] = None, subset: bool = True
              ) -> Dict[str, List[dict]]:
    """ZINC from PyG's raw pickles (``atom_type``, the ``bond_type``
    adjacency and ``logP_SA_cycle_normalized`` a molecule), the 12 k
    subset by the ``{split}.index`` files unless ``subset=False``."""
    import torch  # noqa: F401 -- the pickles hold torch tensors

    raw = (root or data_location()) / "ZINC" / "raw"
    out = {}
    for split in ("train", "val", "test"):
        with open(raw / f"{split}.pickle", "rb") as f:
            mols = pickle.load(f)
        if subset:
            idx = [int(line) for line in
                   (raw / f"{split}.index").read_text().split(",")]
            mols = [mols[i] for i in idx]
        graphs = []
        for mol in mols:
            s, r = np.nonzero(np.asarray(mol["bond_type"]))
            graphs.append({
                "nodes": np.asarray(mol["atom_type"], np.int32).reshape(-1,
                                                                       1),
                "senders": s.astype(np.int32),
                "receivers": r.astype(np.int32),
                "y": np.array([float(mol["logP_SA_cycle_normalized"])],
                              np.float32),
            })
        out[split] = graphs
    return out
