"""Gather-reduce kernels 1 and 2 (counterpart of
``egc_tpu.ops.pallas.gather_reduce``), with their plain PyTorch versions.

- ``gather_reduce_fwd`` replaces ``windowed_gather_reduce``: per receiver,
  over its CSR in-edges, any of the primitives sum / wsum / sumsq / max /
  min; an empty receiver gives 0 for all of them.
- ``gather_reduce_bwd`` replaces ``windowed_gather_reduce_bwd``: per
  sender, over its out-edges in the transposed (CSC) layout, the gradient
  from the packed coefficients ``c_sum|c_wsum|c_sumsq2|mx|c_max|mn|c_min``.
- ``segment_gather_reduce`` replaces the JAX function of that name: the
  contract of kernel 1 over receiver-sorted COO edges, whose CSR row
  pointer it builds before it launches kernel 1.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel in
``csrc/gather_reduce.cu`` or raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from egc_tpu_torch.ops.cuda import _build

PRIMS = ("sum", "wsum", "sumsq", "max", "min")
SEGS = ("c_sum", "c_wsum", "c_sumsq2", "mx", "c_max", "mn", "c_min")
_PRIM_BIT = {p: 1 << i for i, p in enumerate(PRIMS)}

launches: Dict[str, int] = {"gather_reduce_fwd": 0, "gather_reduce_bwd": 0}


def _row_ids(ptr: torch.Tensor) -> torch.Tensor:
    n = ptr.shape[0] - 1
    counts = (ptr[1:] - ptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(n, device=ptr.device), counts)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def gather_reduce_fwd_plain(vals: torch.Tensor, rowptr: torch.Tensor,
                            senders: torch.Tensor,
                            edge_w: Optional[torch.Tensor],
                            prims: Sequence[str]) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of kernel 1 (any device). The output has one
    row per CSR row, ``rowptr.shape[0] - 1``."""
    n, f = rowptr.shape[0] - 1, vals.shape[1]
    rows = _row_ids(rowptr)
    g = vals[senders.long()]
    idx = rows[:, None].expand(-1, f)
    outs = []
    for p in prims:
        if p == "sum":
            outs.append(vals.new_zeros(n, f).index_add_(0, rows, g))
        elif p == "wsum":
            outs.append(vals.new_zeros(n, f).index_add_(
                0, rows, g * edge_w[:, None]))
        elif p == "sumsq":
            outs.append(vals.new_zeros(n, f).index_add_(0, rows, g * g))
        elif p in ("max", "min"):
            # include_self=False: a row with edges gets their extremum, an
            # empty row keeps the 0 it started from
            outs.append(vals.new_zeros(n, f).scatter_reduce_(
                0, idx, g, "amax" if p == "max" else "amin",
                include_self=False))
        else:
            raise ValueError(f"unknown primitive {p!r}")
    return tuple(outs)


def gather_reduce_bwd_plain(coeff: torch.Tensor, vals: torch.Tensor,
                            colptr: torch.Tensor, receivers: torch.Tensor,
                            edge_w: Optional[torch.Tensor],
                            segs: Sequence[str]) -> torch.Tensor:
    """Plain PyTorch version of kernel 2 (any device). ``coeff`` is
    ``[n, K*F]`` with the segments of ``segs`` side by side."""
    n, f = vals.shape
    pos = {s: k for k, s in enumerate(segs)}
    senders = _row_ids(colptr)
    r = receivers.long()

    def seg(name):
        k = pos[name]
        return coeff[r, k * f:(k + 1) * f]

    contrib = torch.zeros(r.shape[0], f, dtype=vals.dtype, device=vals.device)
    v = vals[senders] if {"c_sumsq2", "c_max", "c_min"} & pos.keys() \
        else None
    if "c_sum" in pos:
        contrib += seg("c_sum")
    if "c_wsum" in pos:
        contrib += seg("c_wsum") * edge_w[:, None]
    if "c_sumsq2" in pos:
        contrib += seg("c_sumsq2") * v
    if "c_max" in pos:
        contrib += torch.where(v >= seg("mx"), seg("c_max"), 0.0)
    if "c_min" in pos:
        contrib += torch.where(v <= seg("mn"), seg("c_min"), 0.0)
    return vals.new_zeros(n, f).index_add_(0, senders, contrib)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _vec4(f: int, *tensors) -> int:
    return int(f % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _check_plan(ptr_name, ptr, idx_name, idx, w, n, device):
    _build.check_tensor(ptr_name, ptr, torch.int32, device, (n + 1,))
    _build.check_tensor(idx_name, idx, torch.int32, device)
    if w is not None:
        _build.check_tensor("edge_w", w, torch.float32, device, idx.shape)


def _launch_fwd(vals, rowptr, senders, edge_w, prims):
    dev = vals.device
    if dev.type != "cuda":
        raise RuntimeError(f"gather_reduce_fwd kernel needs a CUDA tensor, "
                           f"got one on {dev}")
    n, f = rowptr.shape[0] - 1, vals.shape[1]
    _build.check_tensor("vals", vals, torch.float32, dev)
    _check_plan("rowptr", rowptr, "senders", senders, edge_w, n, dev)
    if "wsum" in prims and edge_w is None:
        raise ValueError("wsum requires edge_w")
    outs = {p: torch.empty(n, f, dtype=torch.float32, device=dev)
            for p in prims}
    lib = _build.library("gather_reduce")
    fn = lib.gather_reduce_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p])
    mask = sum(_PRIM_BIT[p] for p in prims)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(vals.data_ptr(), rowptr.data_ptr(), senders.data_ptr(),
                 _ptr(edge_w), n, f, mask,
                 *[_ptr(outs.get(p)) for p in PRIMS],
                 _vec4(f, vals, *outs.values()), stream)
    _build.check_launch(err, "gather_reduce_fwd", lib)
    launches["gather_reduce_fwd"] += 1
    return tuple(outs[p] for p in prims)


def _launch_bwd(coeff, vals, colptr, receivers, edge_w, segs):
    dev = vals.device
    if dev.type != "cuda":
        raise RuntimeError(f"gather_reduce_bwd kernel needs a CUDA tensor, "
                           f"got one on {dev}")
    n, f = vals.shape
    k = len(segs)
    _build.check_tensor("vals", vals, torch.float32, dev)
    _build.check_tensor("coeff", coeff, torch.float32, dev, (n, k * f))
    _check_plan("colptr", colptr, "receivers", receivers, edge_w, n, dev)
    if "c_wsum" in segs and edge_w is None:
        raise ValueError("c_wsum requires edge_w")
    for needs, pair in (("c_max", "mx"), ("c_min", "mn")):
        if (needs in segs) != (pair in segs):
            raise ValueError(f"{needs} and {pair} come together")
    pos = (ctypes.c_int * 7)(*[segs.index(s) if s in segs else -1
                               for s in SEGS])
    d_vals = torch.empty(n, f, dtype=torch.float32, device=dev)
    lib = _build.library("gather_reduce")
    fn = lib.gather_reduce_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(coeff.data_ptr(), vals.data_ptr(), colptr.data_ptr(),
                 receivers.data_ptr(), _ptr(edge_w), n, f, k, pos,
                 d_vals.data_ptr(), _vec4(f, coeff, vals, d_vals), stream)
    _build.check_launch(err, "gather_reduce_bwd", lib)
    launches["gather_reduce_bwd"] += 1
    return d_vals


# ---------------------------------------------------------------------------
# device dispatch
# ---------------------------------------------------------------------------

def gather_reduce_fwd(vals, rowptr, senders, edge_w, prims):
    """Primitives per receiver row of the CSR ``(rowptr, senders)``;
    returns one ``[rows, F]`` tensor per entry of ``prims``, with
    ``rows = rowptr.shape[0] - 1``."""
    prims = tuple(prims)
    if vals.device.type == "cpu":
        return gather_reduce_fwd_plain(vals, rowptr, senders, edge_w, prims)
    return _launch_fwd(vals, rowptr, senders, edge_w, prims)


def gather_reduce_bwd(coeff, vals, colptr, receivers, edge_w, segs):
    """Gradient w.r.t. ``vals`` over the transposed CSC
    ``(colptr, receivers)`` from the packed ``coeff`` rows."""
    segs = tuple(segs)
    if vals.device.type == "cpu":
        return gather_reduce_bwd_plain(coeff, vals, colptr, receivers,
                                       edge_w, segs)
    return _launch_bwd(coeff, vals, colptr, receivers, edge_w, segs)


def segment_gather_reduce(vals: torch.Tensor, senders: torch.Tensor,
                          receivers: torch.Tensor, *, num_out_rows: int,
                          ops: Sequence[str] = ("sum",),
                          edge_w: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, ...]:
    """``egc_tpu.ops.pallas.gather_reduce.segment_gather_reduce`` without
    its TPU grid arguments: ``ops`` (of ``PRIMS``) over edges sorted by
    receiver, one ``[num_out_rows, F]`` tensor each; an empty row gives 0.
    Runs kernel 1 (or its plain version on the CPU) over the CSR row
    pointer built here from ``receivers``."""
    r = receivers.to(torch.int32)
    if r.numel() and (bool((r[1:] < r[:-1]).any()) or int(r[0]) < 0
                      or int(r[-1]) >= num_out_rows):
        raise ValueError("receivers must be sorted and in "
                         "[0, num_out_rows)")
    rowptr = torch.searchsorted(
        r, torch.arange(num_out_rows + 1, dtype=torch.int32,
                        device=r.device)).to(torch.int32)
    return gather_reduce_fwd(vals, rowptr, senders.to(torch.int32), edge_w,
                             ops)
