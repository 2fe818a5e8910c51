"""Gather-reduce kernels 1 and 2 (counterpart of
``egc_tpu.ops.pallas.gather_reduce``), with their plain PyTorch versions.

- ``gather_reduce_fwd`` replaces ``windowed_gather_reduce``: per receiver,
  over its CSR in-edges, any of the primitives sum / wsum / sumsq / max /
  min; an empty receiver gives 0 for all of them. Asked for ``masks``, it
  also writes, for max and / or min, the extremum mask: one bit per plan
  edge s -> r and feature f, ``vals[s, f] == ext[r, f]``, packed in
  ``mask_words(F)`` int32 words per edge and stored in CSC (backward)
  order at ``fwd_to_bwd[e]``.
- ``gather_reduce_bwd`` replaces ``windowed_gather_reduce_bwd``: per
  sender, over its out-edges in the transposed (CSC) layout, the gradient
  from one ``[rows, F]`` tensor per coefficient (c_sum, c_wsum, c_sumsq2,
  c_max, c_min) and, for c_max and c_min, the forward's masks in place of
  the receivers' max and min.
- ``segment_gather_reduce`` replaces the JAX function of that name: the
  contract of kernel 1 over receiver-sorted COO edges, whose CSR row
  pointer it builds before it launches kernel 1.

The mask layout is that of the kernel's lanes (``csrc/gather_reduce.cu``):
a lane holds ``lane_vec(F)`` consecutive columns, and for each chunk of
``32 * vec`` columns an edge has ``vec`` words, bit l of word i being
column ``chunk * 32 * vec + l * vec + i``. Which lanes hold which rows and
columns is ``lane_geometry(F)``; it leaves the layout, the outputs and
their order of addition as they are.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel in
``csrc/gather_reduce.cu`` or raises. ``launches`` counts kernel launches:
``gather_reduce_fwd`` and ``gather_reduce_bwd`` every call, the ``_split``
and ``_split_tail`` counters those of that geometry.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from egc_tpu_torch.ops.cuda import _build

PRIMS = ("sum", "wsum", "sumsq", "max", "min")
EXTREMA = ("max", "min")
COEFFS = ("c_sum", "c_wsum", "c_sumsq2", "c_max", "c_min")
_PRIM_BIT = {p: 1 << i for i, p in enumerate(PRIMS)}

GEOMETRIES = ("chunks", "split", "split_tail")   # by the kernels' number
launches: Dict[str, int] = {
    "gather_reduce_fwd": 0, "gather_reduce_bwd": 0,
    "gather_reduce_fwd_split": 0, "gather_reduce_bwd_split": 0,
    "gather_reduce_fwd_split_tail": 0, "gather_reduce_bwd_split_tail": 0}


def _row_ids(ptr: torch.Tensor) -> torch.Tensor:
    n = ptr.shape[0] - 1
    counts = (ptr[1:] - ptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(n, device=ptr.device), counts)


# ---------------------------------------------------------------------------
# the lane layout (``lane_vec``, ``mask_words`` and ``lane_geometry`` in
# csrc/gather_reduce.cu)
# ---------------------------------------------------------------------------

def lane_vec(f: int) -> int:
    """Consecutive columns a lane holds at width ``f``."""
    return 4 if f % 4 == 0 else 1


def mask_words(f: int) -> int:
    """32-bit mask words per edge at width ``f``: ``lane_vec(f)`` for each
    chunk of ``32 * lane_vec(f)`` columns."""
    vec = lane_vec(f)
    return -(-f // (32 * vec)) * vec


def lane_geometry(f: int) -> str:
    """The kernels' lane geometry at width ``f``, of ``GEOMETRIES``. At
    ``lane_vec(f) == 4`` a tail of 1 to 16 float4 slots past the last full
    chunk of 128 columns walks in split groups (several rows a warp):
    "split" where the tail is the whole row (F <= 64), "split_tail" after
    a pass of one warp a row over the full chunks (F 132 to 192, 260 to
    320, ...); else "chunks", one warp a row walking once a chunk of
    ``32 * lane_vec(f)`` columns."""
    tail = f // 4 % 32 if lane_vec(f) == 4 else 0
    if tail == 0 or tail > 16:
        return "chunks"
    return "split" if f <= 64 else "split_tail"


def pack_mask(bits: torch.Tensor) -> torch.Tensor:
    """``[E, F]`` bool -> ``[E, mask_words(F)]`` int32 words."""
    e, f = bits.shape
    vec = lane_vec(f)
    chunks = mask_words(f) // vec
    padded = bits.new_zeros(e, chunks * 32 * vec)
    padded[:, :f] = bits
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) \
        << torch.arange(32, device=bits.device)
    words = (padded.view(e, chunks, 32, vec).transpose(2, 3).long()
             * weights).sum(-1).reshape(e, chunks * vec)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def unpack_mask(words: torch.Tensor, f: int) -> torch.Tensor:
    """``[E, mask_words(f)]`` int32 words -> ``[E, f]`` bool."""
    e = words.shape[0]
    vec = lane_vec(f)
    chunks = mask_words(f) // vec
    shifts = torch.arange(32, device=words.device)
    bits = (words.long().view(e, chunks, vec, 1) >> shifts) & 1
    return bits.transpose(2, 3).reshape(e, chunks * 32 * vec)[:, :f].bool()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def gather_reduce_fwd_plain(vals: torch.Tensor, rowptr: torch.Tensor,
                            senders: torch.Tensor,
                            edge_w: Optional[torch.Tensor],
                            prims: Sequence[str], masks: Sequence[str] = (),
                            fwd_to_bwd: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of kernel 1 (any device). The output has one
    row per CSR row, ``rowptr.shape[0] - 1``, for each of ``prims``, then
    one ``[E, mask_words(F)]`` mask in CSC order for each of ``masks``.
    As the kernel, it reads the edges ``[0, rowptr[-1])`` only: a plan
    built on the card keeps its masked edges past them (their mask words
    are 0 here, unwritten by the kernel)."""
    _check_masks(prims, masks, fwd_to_bwd)
    n, f = rowptr.shape[0] - 1, vals.shape[1]
    rows = _row_ids(rowptr)
    e = rows.shape[0]
    g = vals[senders[:e].long()]
    if edge_w is not None:
        edge_w = edge_w[:e]
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
    for m in masks:
        words = pack_mask(g == outs[prims.index(m)][rows])
        csc = words.new_zeros(senders.shape[0], words.shape[1])
        csc[fwd_to_bwd[:e].long()] = words
        outs.append(csc)
    return tuple(outs)


def gather_reduce_bwd_plain(colptr: torch.Tensor, receivers: torch.Tensor,
                            *, c_sum=None, c_wsum=None, edge_w=None,
                            c_sumsq2=None, vals=None, c_max=None,
                            max_mask=None, c_min=None, min_mask=None
                            ) -> torch.Tensor:
    """Plain PyTorch version of kernel 2 (any device): the gradient of the
    ``colptr.shape[0] - 1`` sender rows from the coefficients given, each
    ``[rows, F]`` indexed by receiver, over the edges ``[0, colptr[-1])``
    as the kernel reads them."""
    coeffs = _check_bwd(colptr, receivers, c_sum, c_wsum, edge_w, c_sumsq2,
                        vals, c_max, max_mask, c_min, min_mask)
    n, f = colptr.shape[0] - 1, coeffs[0].shape[1]
    senders = _row_ids(colptr)
    e = senders.shape[0]
    r = receivers[:e].long()
    edge_w = None if edge_w is None else edge_w[:e]
    max_mask = None if max_mask is None else max_mask[:e]
    min_mask = None if min_mask is None else min_mask[:e]
    contrib = coeffs[0].new_zeros(r.shape[0], f)
    if c_sum is not None:
        contrib += c_sum[r]
    if c_wsum is not None:
        contrib += c_wsum[r] * edge_w[:, None]
    if c_sumsq2 is not None:
        contrib += c_sumsq2[r] * vals[senders]
    if c_max is not None:
        contrib += torch.where(unpack_mask(max_mask, f), c_max[r], 0.0)
    if c_min is not None:
        contrib += torch.where(unpack_mask(min_mask, f), c_min[r], 0.0)
    return coeffs[0].new_zeros(n, f).index_add_(0, senders, contrib)


def _check_masks(prims, masks, fwd_to_bwd):
    for m in masks:
        if m not in EXTREMA or m not in prims:
            raise ValueError(f"mask {m!r} needs the primitive {m!r}")
    if masks and fwd_to_bwd is None:
        raise ValueError("masks need the plan's fwd_to_bwd")


def _check_bwd(colptr, receivers, c_sum, c_wsum, edge_w, c_sumsq2, vals,
               c_max, max_mask, c_min, min_mask):
    """The coefficients given; raises unless they agree in shape and come
    with what each needs."""
    coeffs = [c for c in (c_sum, c_wsum, c_sumsq2, c_max, c_min)
              if c is not None]
    if not coeffs:
        raise ValueError("gather_reduce_bwd needs a coefficient")
    shape = coeffs[0].shape
    if any(c.dim() != 2 or c.shape != shape for c in coeffs):
        raise ValueError(f"coefficients differ in shape: "
                         f"{[tuple(c.shape) for c in coeffs]}")
    if c_wsum is not None and edge_w is None:
        raise ValueError("c_wsum requires edge_w")
    if c_sumsq2 is not None and (vals is None or vals.shape != (
            colptr.shape[0] - 1, shape[1])):
        raise ValueError("c_sumsq2 requires vals of [senders, F]")
    e = receivers.shape[0]
    for name, c, m in (("c_max", c_max, max_mask), ("c_min", c_min,
                                                    min_mask)):
        if (c is None) != (m is None):
            raise ValueError(f"{name} and its mask come together")
        if m is not None and tuple(m.shape) != (e, mask_words(shape[1])):
            raise ValueError(f"{name}'s mask has shape {tuple(m.shape)}, "
                             f"expected {(e, mask_words(shape[1]))}")
    return coeffs


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES: Dict[str, ctypes._CFuncPtr] = {}


def _entry(name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``name`` of ``csrc/gather_reduce.cu``, its types set
    once."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(_build.library("gather_reduce"), name)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        _ENTRIES[name] = fn
    return fn


def _launched(err: int, kernel: str, f: int) -> None:
    if err:
        _build.check_launch(err, kernel, _build.library("gather_reduce"))
    launches[kernel] += 1
    geometry = lane_geometry(f)
    if geometry != "chunks":
        launches[f"{kernel}_{geometry}"] += 1


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _aligned(t: Optional[torch.Tensor], f: int) -> Optional[torch.Tensor]:
    """``t``, or a fresh copy where the kernel's float4 lanes
    (``lane_vec(f) == 4``) would meet a pointer off 16 bytes."""
    if t is None or f % 4 or t.data_ptr() % 16 == 0:
        return t
    return t.clone()


def _check_plan(ptr_name, ptr, idx_name, idx, w, n, device):
    _build.check_tensor(ptr_name, ptr, torch.int32, device, (n + 1,))
    _build.check_tensor(idx_name, idx, torch.int32, device)
    if w is not None:
        _build.check_tensor("edge_w", w, torch.float32, device, idx.shape)


def _needs_cuda(kernel, t):
    if t.device.type != "cuda":
        raise RuntimeError(f"{kernel} kernel needs a CUDA tensor, got one "
                           f"on {t.device}")


def _launch_fwd(vals, rowptr, senders, edge_w, prims, masks, fwd_to_bwd):
    _needs_cuda("gather_reduce_fwd", vals)
    dev = vals.device
    n, f = rowptr.shape[0] - 1, vals.shape[1]
    _build.check_tensor("vals", vals, torch.float32, dev)
    _check_plan("rowptr", rowptr, "senders", senders, edge_w, n, dev)
    _check_masks(prims, masks, fwd_to_bwd)
    if masks:
        _build.check_tensor("fwd_to_bwd", fwd_to_bwd, torch.int32, dev,
                            senders.shape)
    if "wsum" in prims and edge_w is None:
        raise ValueError("wsum requires edge_w")
    outs = {p: torch.empty(n, f, dtype=torch.float32, device=dev)
            for p in prims}
    words = {m: torch.empty(senders.shape[0], mask_words(f),
                            dtype=torch.int32, device=dev) for m in masks}
    vals = _aligned(vals, f)
    fn = _entry("gather_reduce_fwd", [_P] * 5 + [_I] * 3 + [_P] * 8)
    with torch.cuda.device(dev):
        err = fn(vals.data_ptr(), rowptr.data_ptr(), senders.data_ptr(),
                 _ptr(edge_w), _ptr(fwd_to_bwd if masks else None), n, f,
                 sum(_PRIM_BIT[p] for p in prims),
                 *[_ptr(outs.get(p)) for p in PRIMS],
                 *[_ptr(words.get(m)) for m in EXTREMA],
                 torch.cuda.current_stream(dev).cuda_stream)
    _launched(err, "gather_reduce_fwd", f)
    return tuple(outs[p] for p in prims) + tuple(words[m] for m in masks)


def _launch_bwd(colptr, receivers, *, c_sum=None, c_wsum=None, edge_w=None,
                c_sumsq2=None, vals=None, c_max=None, max_mask=None,
                c_min=None, min_mask=None):
    coeffs = _check_bwd(colptr, receivers, c_sum, c_wsum, edge_w, c_sumsq2,
                        vals, c_max, max_mask, c_min, min_mask)
    _needs_cuda("gather_reduce_bwd", coeffs[0])
    dev = coeffs[0].device
    n, f = colptr.shape[0] - 1, coeffs[0].shape[1]
    ins = []   # the C entry's first eight pointers, kept alive
    for name, t, dtype in (
            ("c_sum", c_sum, torch.float32), ("c_wsum", c_wsum, torch.float32),
            ("c_sumsq2", c_sumsq2, torch.float32),
            ("c_max", c_max, torch.float32), ("c_min", c_min, torch.float32),
            ("max_mask", max_mask, torch.int32),
            ("min_mask", min_mask, torch.int32),
            ("vals", vals if c_sumsq2 is not None else None, torch.float32)):
        if t is not None:
            _build.check_tensor(name, t, dtype, dev)
        ins.append(_aligned(t, f))
    if c_wsum is None:
        edge_w = None
    _check_plan("colptr", colptr, "receivers", receivers, edge_w, n, dev)
    d_vals = torch.empty(n, f, dtype=torch.float32, device=dev)
    fn = _entry("gather_reduce_bwd", [_P] * 11 + [_I] * 2 + [_P] * 2)
    with torch.cuda.device(dev):
        err = fn(*[_ptr(t) for t in ins], colptr.data_ptr(),
                 receivers.data_ptr(), _ptr(edge_w), n, f, d_vals.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _launched(err, "gather_reduce_bwd", f)
    return d_vals


def kernel_mask_words(f: int) -> int:
    """``mask_words(f)`` as the compiled kernels reckon it."""
    return _entry("gather_reduce_mask_words", [_I])(f)


def kernel_lane_geometry(f: int) -> str:
    """``lane_geometry(f)`` as the compiled kernels reckon it."""
    return GEOMETRIES[_entry("gather_reduce_geometry", [_I])(f)]


# ---------------------------------------------------------------------------
# device dispatch
# ---------------------------------------------------------------------------

def gather_reduce_fwd(vals, rowptr, senders, edge_w, prims, masks=(),
                      fwd_to_bwd=None):
    """Primitives per receiver row of the CSR ``(rowptr, senders)``: one
    ``[rows, F]`` tensor per entry of ``prims`` (``rows = rowptr.shape[0] -
    1``), then one ``[E, mask_words(F)]`` int32 mask in CSC order per entry
    of ``masks`` (of ``EXTREMA``, each also in ``prims``; they need the
    plan's ``fwd_to_bwd``)."""
    prims, masks = tuple(prims), tuple(masks)
    if vals.device.type == "cpu":
        return gather_reduce_fwd_plain(vals, rowptr, senders, edge_w, prims,
                                       masks, fwd_to_bwd)
    return _launch_fwd(vals, rowptr, senders, edge_w, prims, masks,
                       fwd_to_bwd)


def gather_reduce_bwd(colptr, receivers, *, c_sum=None, c_wsum=None,
                      edge_w=None, c_sumsq2=None, vals=None, c_max=None,
                      max_mask=None, c_min=None, min_mask=None):
    """Gradient w.r.t. the ``colptr.shape[0] - 1`` sender rows over the
    transposed CSC ``(colptr, receivers)``, from the coefficients given
    (each ``[rows, F]``, indexed by receiver; their row count need not be
    the senders'): ``c_wsum`` with the CSC ``edge_w``, ``c_sumsq2`` with
    the senders' ``vals``, ``c_max`` / ``c_min`` with the forward's
    ``max_mask`` / ``min_mask``."""
    kw = dict(c_sum=c_sum, c_wsum=c_wsum, edge_w=edge_w, c_sumsq2=c_sumsq2,
              vals=vals, c_max=c_max, max_mask=max_mask, c_min=c_min,
              min_mask=min_mask)
    first = next((c for c in (c_sum, c_wsum, c_sumsq2, c_max, c_min)
                  if c is not None), None)
    if first is not None and first.device.type == "cpu":
        return gather_reduce_bwd_plain(colptr, receivers, **kw)
    return _launch_bwd(colptr, receivers, **kw)


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
