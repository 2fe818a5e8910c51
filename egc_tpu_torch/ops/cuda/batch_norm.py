"""Masked BatchNorm as four CUDA kernels (``csrc/batch_norm.cu``), with
their plain PyTorch versions and the autograd function that runs them.

The function is ``egc_tpu.nn.norm.MaskedBatchNorm``'s:

- ``stats = (s, ssq, n)``, ``[2F + 1]``: the masked sums of x and x^2 and
  the count of valid rows (``bn_stats``);
- ``mean = s / n'``, ``var = max(ssq / n' - mean^2, 0)`` with
  ``n' = max(n, 1)``, the biased variance; ``y = ((x - mean) r) w + b``
  with ``r = 1 / sqrt(var + 1e-5)`` on every row (``bn_apply``), which in
  training also updates the running statistics (unbiased variance,
  momentum 0.1) and ``num_batches_tracked`` in place;
- backward: ``bn_grad_sums`` gives ``dweight``, ``dbias`` and
  ``d = (ds, dssq)``, the cotangents of s and ssq; ``bn_apply_bwd``
  ``dx = g (w r) + m (ds + 2 x dssq)``. The clamp passes its gradient
  where ``ssq / n' - mean^2 >= 0``, as ``torch.clamp`` does.

Evaluation takes mean and var from the running statistics, ``d = 0``.
With a process group (sync-BN) the forward all-reduces ``stats`` between
kernels 1 and 2 and the backward ``d`` between kernels 3 and 4;
``dweight`` and ``dbias`` stay local.

``masked_batch_norm`` is the entry: on a CPU tensor the plain versions,
on a CUDA tensor the kernels, or it raises. ``launches`` counts kernel
launches (read with the other kernels' through
``ops.cuda.launch_counts``). ``grid`` and ``variant`` are the rules by
which the wrapper sizes the grid and picks the float4 or the scalar
variant, which it passes to the kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from egc_tpu_torch.ops.cuda import _build

MOMENTUM = 0.1
EPS = 1e-5
THREADS = 512          # kThreads in csrc/batch_norm.cu
SUM_BLOCKS = 264       # bn_stats, bn_grad_sums: two blocks an H100 SM
APPLY_BLOCKS = 528     # bn_apply, bn_apply_bwd: four an SM
MIN_PASSES = 8         # row passes a thread makes at least, on short inputs

launches: Dict[str, int] = {"bn_stats": 0, "bn_apply": 0,
                            "bn_grad_sums": 0, "bn_apply_bwd": 0}


def variant(f: int, ptrs) -> str:
    """``"vector"`` (float4) when F is a multiple of 4 and every [N, F]
    pointer is 16-byte aligned, else ``"scalar"``; the launchers pass it
    to the kernels."""
    return "vector" if f % 4 == 0 and all(p % 16 == 0 for p in ptrs) \
        else "scalar"


def grid(n: int, f: int, vector: bool, max_blocks: int) -> Tuple[int, int]:
    """``(blocks, rows_per_block)`` for N rows of F columns: a thread keeps
    its columns and a pass of the block covers R = THREADS / C rows (C
    column groups, at most THREADS a pass); ``max_blocks`` blocks share
    the passes, each at least ``MIN_PASSES`` of them."""
    c = f // 4 if vector else f
    rows = THREADS // min(c, THREADS)
    passes = max(1, math.ceil(n / rows))
    blocks = max(1, min(max_blocks, math.ceil(passes / MIN_PASSES)))
    return blocks, math.ceil(passes / blocks) * rows


# ---------------------------------------------------------------------------
# plain versions (float32, or float64 for float64 input)
# ---------------------------------------------------------------------------

def _acc(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _columns(stats, running_mean, running_var, f: int):
    """``(mean, var, r, n, pos)``: from ``stats`` in training, from the
    running statistics with ``stats`` None (n, pos None)."""
    if stats is None:
        var = running_var
        return (running_mean, var, torch.reciprocal(torch.sqrt(var + EPS)),
                None, None)
    n = torch.clamp(stats[2 * f], min=1.0)
    mean = stats[:f] / n
    u = stats[f:2 * f] / n - mean * mean
    var = torch.clamp(u, min=0.0)
    return mean, var, torch.reciprocal(torch.sqrt(var + EPS)), n, u >= 0


def stats_plain(x, mask):
    """``[2F + 1]``: ``(sum m x, sum m x^2, sum m)`` (mask None: m = 1)."""
    xf = x.to(_acc(x))
    if mask is None:
        s, ssq = xf.sum(0), (xf * xf).sum(0)
        n = torch.tensor(float(x.shape[0]), dtype=xf.dtype, device=x.device)
    else:
        m = mask.to(xf.dtype)[:, None]
        s, ssq = (xf * m).sum(0), (xf * xf * m).sum(0)
        n = m.sum()
    return torch.cat([s, ssq, n.reshape(1)])


def apply_plain(x, stats, weight, bias, running_mean, running_var,
                num_batches_tracked):
    """y; with ``stats`` (training) the running statistics updated in
    place, with None (evaluation) read."""
    f = x.shape[1]
    mean, var, r, n, _ = _columns(stats, running_mean, running_var, f)
    if stats is not None:
        with torch.no_grad():
            unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
            running_mean.mul_(1 - MOMENTUM).add_(MOMENTUM * mean)
            running_var.mul_(1 - MOMENTUM).add_(MOMENTUM * unbiased)
            num_batches_tracked.add_(1)
    return (x.to(_acc(x)) - mean) * r * weight + bias


def grad_sums_plain(g, x, stats, running_mean, running_var, weight):
    """``(dweight, dbias, d)``, ``d = (ds, dssq)`` [2F] (0 in evaluation)."""
    f = x.shape[1]
    mean, _, r, n, pos = _columns(stats, running_mean, running_var, f)
    gf = g.to(_acc(x))
    sg = gf.sum(0)
    sgx = (gf * (x.to(gf.dtype) - mean)).sum(0)
    if stats is None:
        d = torch.zeros(2 * f, dtype=gf.dtype, device=g.device)
    else:
        dvar = torch.where(pos, -0.5 * r * r * r * weight * sgx, 0.0)
        d = torch.cat([-(r * weight * sg) / n - 2.0 * mean * dvar / n,
                       dvar / n])
    return r * sgx, sg, d


def apply_bwd_plain(g, x, mask, stats, running_mean, running_var, weight,
                    d):
    """``dx = g (w r) + m (ds + x (2 dssq))``."""
    f = x.shape[1]
    r = _columns(stats, running_mean, running_var, f)[2]
    t = d[:f] + x.to(_acc(x)) * (2.0 * d[f:])
    if mask is not None:
        t = mask.to(t.dtype)[:, None] * t
    return g.to(t.dtype) * (weight * r) + t


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(x, mask, vectors=(), rows=(), stats=None, d=None):
    """Raise unless the kernels take these tensors: float32, contiguous,
    on x's CUDA device; x and ``rows`` [N, F], the ``vectors`` [F] (None
    skipped), ``stats`` [2F + 1], ``d`` [2F], the mask bool [N]."""
    dev = x.device
    if dev.type != "cuda":
        raise RuntimeError(f"BatchNorm kernel needs a CUDA tensor, got one "
                           f"on {dev}")
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"x must be [N, F] with F >= 1, got "
                         f"{tuple(x.shape)}")
    n, f = x.shape
    _build.check_tensor("x", x, torch.float32, dev)
    if mask is not None:
        _build.check_tensor("mask", mask, torch.bool, dev, (n,))
    for name, t, shape in ([(k, t, (f,)) for k, t in vectors]
                           + [(k, t, (n, f)) for k, t in rows]
                           + [("stats", stats, (2 * f + 1,)),
                              ("d", d, (2 * f,))]):
        if t is not None:
            _build.check_tensor(name, t, torch.float32, dev, shape)
    return dev, n, f


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "bn_stats": [_P, _P, _L, _I, _I, _I, _L, _P, _P, _P, _P],
    "bn_apply": [_P] * 7 + [_L, _I, _I, _I, _L, _P, _P],
    "bn_grad_sums": [_P] * 6 + [_L, _I, _I, _I, _L] + [_P] * 6,
    "bn_apply_bwd": [_P] * 8 + [_L, _I, _I, _I, _L, _P, _P],
}
_fns: Dict[str, object] = {}     # name -> the library's function, typed


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("batch_norm"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _fns[name] = fn
    return fn


def _launch(name: str, dev: torch.device, *args) -> None:
    """Call entry ``name`` with ``args`` and the current stream of ``dev``
    (made the current device for the call if it is not)."""
    fn = _fn(name)
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, name, _build.library("batch_norm"))
    launches[name] += 1


def _geometry(n: int, f: int, rows, max_blocks: int):
    """``(vector, blocks, rows_per_block)`` for the [N, F] tensors
    ``rows``: the variant as the int the kernels take, and ``grid``."""
    vector = variant(f, [t.data_ptr() for t in rows]) == "vector"
    return (int(vector),) + grid(n, f, vector, max_blocks)


def _launch_stats(x, mask):
    dev, n, f = _check(x, mask)
    vector, blocks, rpb = _geometry(n, f, [x], SUM_BLOCKS)
    parts = blocks * (2 * f + 1)     # the partials, then the ticket
    scratch = torch.empty(parts + 1, dtype=torch.float32, device=dev)
    stats = torch.empty(2 * f + 1, dtype=torch.float32, device=dev)
    _launch("bn_stats", dev, x.data_ptr(), _ptr(mask), n, f, vector, blocks,
            rpb, scratch.data_ptr(), scratch.data_ptr() + 4 * parts,
            stats.data_ptr())
    return stats


def _launch_apply(x, stats, weight, bias, running_mean, running_var,
                  num_batches_tracked):
    dev, n, f = _check(x, None, (
        ("weight", weight), ("bias", bias), ("running_mean", running_mean),
        ("running_var", running_var)), stats=stats)
    if stats is not None:
        _build.check_tensor("num_batches_tracked", num_batches_tracked,
                            torch.long, dev, ())
    y = torch.empty_like(x)
    vector, blocks, rpb = _geometry(n, f, [x, y], APPLY_BLOCKS)
    nbt = None if stats is None else num_batches_tracked.data_ptr()
    _launch("bn_apply", dev, x.data_ptr(), _ptr(stats),
            running_mean.data_ptr(), running_var.data_ptr(), nbt,
            weight.data_ptr(), bias.data_ptr(), n, f, vector, blocks, rpb,
            y.data_ptr())
    return y


def _launch_grad_sums(g, x, stats, running_mean, running_var, weight):
    dev, n, f = _check(x, None, (
        ("weight", weight), ("running_mean", running_mean),
        ("running_var", running_var)), (("g", g),), stats=stats)
    vector, blocks, rpb = _geometry(n, f, [g, x], SUM_BLOCKS)
    parts = blocks * 2 * f
    scratch = torch.empty(parts + 1, dtype=torch.float32, device=dev)
    dweight = torch.empty(f, dtype=torch.float32, device=dev)
    dbias = torch.empty(f, dtype=torch.float32, device=dev)
    d = torch.empty(2 * f, dtype=torch.float32, device=dev)
    _launch("bn_grad_sums", dev, g.data_ptr(), x.data_ptr(), _ptr(stats),
            _ptr(running_mean), _ptr(running_var), weight.data_ptr(), n, f,
            vector, blocks, rpb, scratch.data_ptr(),
            scratch.data_ptr() + 4 * parts,
            dweight.data_ptr(), dbias.data_ptr(), d.data_ptr())
    return dweight, dbias, d


def _launch_apply_bwd(g, x, mask, stats, running_mean, running_var, weight,
                      d):
    dev, n, f = _check(x, mask, (
        ("weight", weight), ("running_mean", running_mean),
        ("running_var", running_var)), (("g", g),), stats=stats, d=d)
    dx = torch.empty_like(x)
    vector, blocks, rpb = _geometry(n, f, [g, x, dx], APPLY_BLOCKS)
    _launch("bn_apply_bwd", dev, g.data_ptr(), x.data_ptr(), _ptr(mask),
            _ptr(stats), _ptr(running_mean), _ptr(running_var),
            weight.data_ptr(), d.data_ptr(), n, f, vector, blocks, rpb,
            dx.data_ptr())
    return dx


# ---------------------------------------------------------------------------
# device dispatch
# ---------------------------------------------------------------------------

def bn_stats(x, mask):
    if x.device.type == "cpu":
        return stats_plain(x, mask)
    return _launch_stats(x, mask)


def bn_apply(x, stats, weight, bias, running_mean, running_var,
             num_batches_tracked):
    if x.device.type == "cpu":
        return apply_plain(x, stats, weight, bias, running_mean,
                           running_var, num_batches_tracked)
    return _launch_apply(x, stats, weight, bias, running_mean, running_var,
                         num_batches_tracked)


def bn_grad_sums(g, x, stats, running_mean, running_var, weight):
    if x.device.type == "cpu":
        return grad_sums_plain(g, x, stats, running_mean, running_var,
                               weight)
    return _launch_grad_sums(g, x, stats, running_mean, running_var, weight)


def bn_apply_bwd(g, x, mask, stats, running_mean, running_var, weight, d):
    if x.device.type == "cpu":
        return apply_bwd_plain(g, x, mask, stats, running_mean, running_var,
                               weight, d)
    return _launch_apply_bwd(g, x, mask, stats, running_mean, running_var,
                             weight, d)


class _MaskedBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, mask, running_mean, running_var,
                num_batches_tracked, training, group):
        stats = None
        if training:
            stats = bn_stats(x, mask)
            if group is not None:
                dist.all_reduce(stats, group=group)
            running = (None, None)
        else:
            running = (running_mean, running_var)
        y = bn_apply(x, stats, weight, bias, running_mean, running_var,
                     num_batches_tracked)
        ctx.group = group if training else None
        ctx.save_for_backward(x, mask, weight, stats, *running)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        x, mask, weight, stats, running_mean, running_var = ctx.saved_tensors
        g = gy.contiguous()
        dweight, dbias, d = bn_grad_sums(g, x, stats, running_mean,
                                         running_var, weight)
        if ctx.group is not None:
            dist.all_reduce(d, group=ctx.group)
        dx = bn_apply_bwd(g, x, mask, stats, running_mean, running_var,
                          weight, d)
        return (dx.to(x.dtype), dweight.to(weight.dtype),
                dbias.to(weight.dtype)) + (None,) * 6


def masked_batch_norm(x: torch.Tensor, mask: Optional[torch.Tensor],
                      weight: torch.Tensor, bias: torch.Tensor,
                      running_mean: torch.Tensor, running_var: torch.Tensor,
                      num_batches_tracked: torch.Tensor, *, training: bool,
                      group=None) -> torch.Tensor:
    """BatchNorm of ``x [N, F]`` over the rows where ``mask [N]`` (None:
    every row): in training by the batch's statistics, updating the
    running ones in place (summed over ``group``'s ranks when given), in
    evaluation by the running ones. Differentiable in x, weight and
    bias."""
    if mask is not None and tuple(mask.shape) != (x.shape[0],):
        raise ValueError(f"mask must be [{x.shape[0]}], got "
                         f"{tuple(mask.shape)}")
    return _MaskedBatchNorm.apply(x, weight, bias, mask, running_mean,
                                  running_var, num_batches_tracked,
                                  training, group)
