"""On-disk readers for the real datasets (counterpart of
``egc_tpu.data.ondisk``): the ogbn-arxiv reader.

They read local files only, already in the standard OGB layout under
``data_location()`` (``$DATASET_LOC``, default ``~/datasets``, the
reference's key, ``experiments/utils.py:20-27``): ogbn-arxiv as
``<root>/ogbn_arxiv/raw/{edge,node-feat,node-label}.csv.gz`` and
``split/time/{train,valid,test}.csv.gz``. The CSV parse is numpy only,
and the first parse of a file leaves a ``<file>.npy`` cache beside it.
"""

from __future__ import annotations

import gzip
import os
import warnings
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from egc_tpu_torch.graph.transforms import to_undirected_np


def data_location() -> Path:
    return Path(os.environ.get("DATASET_LOC", str(Path.home() / "datasets")))


def _parse_csv_bytes(data: bytes, dtype) -> np.ndarray:
    """Decompressed numeric CSV text -> [rows, cols]; every row must have
    the first row's number of fields."""
    text = data.decode().strip()
    if not text:
        return np.zeros((0, 1), dtype)
    lines = text.split("\n")
    rows, cols = len(lines), lines[0].count(",") + 1
    if any(line.count(",") != cols - 1 for line in lines):
        raise ValueError(f"CSV rows differ from the first row's {cols} "
                         "fields")
    del lines
    # floats parse to f64 and round once to ``dtype``; a field that is not
    # a number stops the parse short
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        try:
            flat = np.fromstring(text.replace("\n", ","), sep=",",
                                 dtype=np.float64
                                 if np.dtype(dtype).kind == "f" else dtype)
        except (DeprecationWarning, ValueError):
            flat = None
    if flat is None or flat.size != rows * cols:
        raise ValueError("CSV holds a field that is not a number")
    return flat.astype(dtype).reshape(rows, cols)


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
