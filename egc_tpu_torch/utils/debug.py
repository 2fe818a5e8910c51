"""Determinism and numerical guards (counterpart of
``egc_tpu.utils.debug``).

- ``enable_determinism``: deterministic algorithms (an op without one
  raises), cuDNN autotuning off, and the cuBLAS workspace that
  deterministic cuBLAS needs.
- ``check_finite``: a NaN / Inf guard over nested dicts, lists and tuples
  of tensors and arrays that names the path of the bad leaf.
- ``seed_all``: python, numpy and torch (every device) RNGs.
"""

from __future__ import annotations

import os
import random
from typing import Any

import numpy as np
import torch


def enable_determinism() -> None:
    """Bit-reproducible runs on one card and software stack. Call it
    before the first cuBLAS call of the process: cuBLAS reads
    ``CUBLAS_WORKSPACE_CONFIG`` when its handle is created (an explicit
    setting is kept)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True


def seed_all(seed: int) -> None:
    """Seed python's, numpy's and torch's global RNGs (``torch.manual_seed``
    seeds every CUDA device too). Dropout and sampling in the port draw
    from explicit generators; this covers what does not."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def _leaves(tree: Any, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def check_finite(tree: Any, *, name: str = "value") -> Any:
    """Raise ``FloatingPointError`` naming the first floating leaf of
    ``tree`` that holds a NaN or Inf (e.g. ``value['a'][1]``); returns
    ``tree``. A tensor on the card is read once (a device sync)."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and \
                not bool(torch.isfinite(leaf).all())
        else:
            arr = np.asarray(leaf)
            bad = arr.dtype.kind == "f" and not np.isfinite(arr).all()
        if bad:
            raise FloatingPointError(f"non-finite values in {name}{path}")
    return tree
