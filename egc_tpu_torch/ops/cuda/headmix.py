"""EGC head-mix kernels 3 and 4 (counterpart of
``egc_tpu.ops.pallas.headmix``), with their plain PyTorch versions.

    z[n, h*L + l] = sum_{b,a} w2d[n, h*B*A + b*A + a] * ys[a][n, b*L + l]
                    + bias[h*L + l]

``w2d`` is the ``comb`` output in (h, b, a) column order; ``ys`` are the A
per-aggregator arrays ``[n, y_width]`` of which the first B*L columns are
used (``y_width >= B*L``; dy's tail columns are 0). ``head_mix_fused``
is an autograd function: on a CPU tensor it runs the plain versions, on a
CUDA tensor kernel 3 forward and kernel 4 backward, or raises. dbias is
``dz.sum(0)`` in torch, as in the JAX package. ``launches`` counts kernel
launches: ``headmix_fwd`` and ``headmix_bwd`` every launch,
``headmix_fwd_tile`` and ``headmix_bwd_tile`` those of the tile variant.
Kernels 3 and 4 each have a float4 and a tile variant; ``fwd_variant`` and
``bwd_variant`` are the rules by which ``headmix_fwd`` and ``headmix_bwd``
in ``csrc/headmix.cu`` pick one, and ``tile_plan`` how the tile variant
cuts the nodes into blocks.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from egc_tpu_torch.ops.cuda import _build
from egc_tpu_torch.utils.profiling import span

MAX_AGGRS = 8          # kMaxAggrs in csrc/headmix.cu
# the tile variant's constants in csrc/headmix.cu
TILE_BYTES = 48 * 1024         # kTileBytes
MAX_TILE_NODES = 32            # kMaxTileNodes
MAX_TILE_SMEM = 232448         # kMaxTileSmem

launches: Dict[str, int] = {"headmix_fwd": 0, "headmix_bwd": 0,
                            "headmix_fwd_tile": 0, "headmix_bwd_tile": 0}


def _split(w2d, ys, H, B, A, L):
    n = w2d.shape[0]
    w = w2d.reshape(n, H, B, A)
    y = torch.stack([t[:, :B * L] for t in ys], dim=1).reshape(n, A, B, L)
    return w, y


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def headmix_fwd_plain(w2d, ys, bias, *, H, B, A, L) -> torch.Tensor:
    """The ``head_mix`` formula of ``egc_tpu/nn/conv/egc.py`` plus bias:
    a broadcast multiply and a sum over the (a, b) axis."""
    n = w2d.shape[0]
    w, y = _split(w2d, ys, H, B, A, L)
    w2 = w.permute(0, 1, 3, 2).reshape(n, H, A * B, 1)
    y2 = y.reshape(n, 1, A * B, L)
    z = (w2 * y2).sum(dim=2).reshape(n, H * L)
    return z if bias is None else z + bias


def headmix_bwd_plain(w2d, ys, dz, *, H, B, A, L, y_width
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Plain version of kernel 4: ``(dw [n, H*B*A], A x dy [n, y_width])``."""
    n = w2d.shape[0]
    w, y = _split(w2d, ys, H, B, A, L)
    dz3 = dz.reshape(n, H, 1, 1, L)
    # dy[n, a, b, l] = sum_h w[n, h, b, a] dz[n, h, l]
    dy = (w.permute(0, 1, 3, 2)[..., None] * dz3).sum(dim=1)
    # dw[n, h, b, a] = sum_l dz[n, h, l] y[n, a, b, l]
    dw = (dz3 * y.permute(0, 2, 1, 3)[:, None]).sum(dim=-1)
    dys = []
    for a in range(A):
        d = dy[:, a].reshape(n, B * L)
        if y_width != B * L:
            d = torch.cat([d, d.new_zeros(n, y_width - B * L)], dim=1)
        dys.append(d)
    return dw.reshape(n, H * B * A), tuple(dys)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check(w2d, ys, H, B, A, L, y_width, extra=()):
    dev = w2d.device
    if dev.type != "cuda":
        raise RuntimeError(f"head-mix kernel needs a CUDA tensor, got one "
                           f"on {dev}")
    if not 1 <= A <= MAX_AGGRS:
        raise ValueError(f"the head-mix kernel takes 1..{MAX_AGGRS} "
                         f"aggregators, got {A}")
    n = w2d.shape[0]
    _build.check_tensor("w2d", w2d, torch.float32, dev, (n, H * B * A))
    for a, y in enumerate(ys):
        _build.check_tensor(f"ys[{a}]", y, torch.float32, dev, (n, y_width))
    for name, t, shape in extra:
        _build.check_tensor(name, t, torch.float32, dev, shape)
    return dev, n


def _ptr_array(tensors):
    return (ctypes.c_void_p * MAX_AGGRS)(*[t.data_ptr() for t in tensors])


def _vector_ok(L: int, y_width: int, ptrs: Sequence[int]) -> str:
    ok = L % 4 == 0 and y_width % 4 == 0 and all(p % 16 == 0 for p in ptrs)
    return "vector" if ok else "tile"


def fwd_variant(L: int, y_width: int, ptrs: Sequence[int]) -> str:
    """``"vector"`` or ``"tile"``: the kernel 3 variant for L, y_width and
    the data pointers of ys and the bias (0 for none). The float4 variant
    needs L and y_width multiples of 4 and 16-byte aligned pointers
    (``fwd_vector_ok`` in ``csrc/headmix.cu``)."""
    return _vector_ok(L, y_width, ptrs)


def bwd_variant(L: int, y_width: int, ptrs: Sequence[int]) -> str:
    """The kernel 4 variant for L, y_width and the data pointers of ys, dy
    and dz, by the same rule (``bwd_vector_ok`` in ``csrc/headmix.cu``);
    w2d and dw, read and written a float at a time, do not count."""
    return _vector_ok(L, y_width, ptrs)


def _slab_region(count: int) -> int:
    return (count + 6) & ~3


def tile_plan(bwd: bool, H: int, B: int, A: int, L: int, y_width: int
              ) -> Tuple[int, int]:
    """``(nodes, smem)``: the nodes of a tile of the tile variant of kernel
    4 (``bwd``) or kernel 3, as many as fit ``TILE_BYTES`` of staged slabs
    (at most ``MAX_TILE_NODES``, at least 1), and a block's shared-memory
    bytes: each slab's region holds its floats and up to 3 more, in whole
    16-byte words; 0 where they pass ``MAX_TILE_SMEM``, and the kernel
    works on device memory directly (``tile_plan`` in
    ``csrc/headmix.cu``)."""
    HBA, HL = H * B * A, H * L
    slabs = [HBA, HL] + [y_width] * A          # forward: w2d, z, ys
    if bwd:
        slabs += [HBA] + [y_width] * A         # backward: + dw, dys
    nodes = max(1, min(MAX_TILE_NODES, TILE_BYTES // (4 * sum(slabs))))
    smem = 4 * sum(_slab_region(nodes * w) for w in slabs)
    return nodes, (smem if smem <= MAX_TILE_SMEM else 0)


def _variant_fn(name, argtypes):
    fn = getattr(_build.library("headmix"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def kernel_fwd_variant(ys, bias, L: int, y_width: int) -> str:
    """The variant the compiled kernel 3 reports for these CUDA tensors, to
    hold against ``fwd_variant``."""
    fn = _variant_fn("headmix_fwd_variant",
                     [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_int])
    vec = fn(_ptr_array(ys), len(ys),
             None if bias is None else bias.data_ptr(), L, y_width)
    return "vector" if vec else "tile"


def kernel_bwd_variant(ys, dys, dz, L: int, y_width: int) -> str:
    """The variant the compiled kernel 4 reports for these CUDA tensors, to
    hold against ``bwd_variant``."""
    fn = _variant_fn("headmix_bwd_variant",
                     [ctypes.POINTER(ctypes.c_void_p),
                      ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
                     + [ctypes.c_int] * 3)
    vec = fn(_ptr_array(ys), _ptr_array(dys), dz.data_ptr(), len(ys), L,
             y_width)
    return "vector" if vec else "tile"


def kernel_tile_plan(bwd: bool, H: int, B: int, A: int, L: int,
                     y_width: int) -> Tuple[int, int]:
    """``(nodes, smem)`` as the compiled library plans the tile variant, to
    hold against ``tile_plan``."""
    fn = _variant_fn("headmix_tile_plan", [ctypes.c_int] * 6
                     + [ctypes.POINTER(ctypes.c_int)])
    nodes = ctypes.c_int(0)
    smem = fn(int(bwd), H, B, A, L, y_width, ctypes.byref(nodes))
    return nodes.value, smem


def _launch_fwd(w2d, ys, bias, H, B, A, L, y_width):
    extra = () if bias is None else (("bias", bias, (H * L,)),)
    dev, n = _check(w2d, ys, H, B, A, L, y_width, extra)
    z = torch.empty(n, H * L, dtype=torch.float32, device=dev)
    lib = _build.library("headmix")
    fn = lib.headmix_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                    ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(w2d.data_ptr(), _ptr_array(ys), A,
                 None if bias is None else bias.data_ptr(),
                 n, H, B, L, y_width, z.data_ptr(), stream)
    _build.check_launch(err, "headmix_fwd", lib)
    launches["headmix_fwd"] += 1
    ptrs = [y.data_ptr() for y in ys] + [0 if bias is None
                                         else bias.data_ptr()]
    if fwd_variant(L, y_width, ptrs) == "tile":
        launches["headmix_fwd_tile"] += 1
    return z


def _launch_bwd(w2d, ys, dz, H, B, A, L, y_width):
    dev, n = _check(w2d, ys, H, B, A, L, y_width,
                    (("dz", dz, (w2d.shape[0], H * L)),))
    dw = torch.empty(n, H * B * A, dtype=torch.float32, device=dev)
    dys = [torch.empty(n, y_width, dtype=torch.float32, device=dev)
           for _ in range(A)]
    lib = _build.library("headmix")
    fn = lib.headmix_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                    ctypes.c_void_p] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                      ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(w2d.data_ptr(), _ptr_array(ys), dz.data_ptr(), A, n, H, B,
                 L, y_width, dw.data_ptr(), _ptr_array(dys), stream)
    _build.check_launch(err, "headmix_bwd", lib)
    launches["headmix_bwd"] += 1
    ptrs = [t.data_ptr() for t in (*ys, *dys, dz)]
    if bwd_variant(L, y_width, ptrs) == "tile":
        launches["headmix_bwd_tile"] += 1
    return dw, tuple(dys)


# ---------------------------------------------------------------------------
# device dispatch
# ---------------------------------------------------------------------------

def headmix_fwd(w2d, ys, bias, *, H, B, A, L, y_width):
    if w2d.device.type == "cpu":
        return headmix_fwd_plain(w2d, ys, bias, H=H, B=B, A=A, L=L)
    return _launch_fwd(w2d, ys, bias, H, B, A, L, y_width)


def headmix_bwd(w2d, ys, dz, *, H, B, A, L, y_width):
    if w2d.device.type == "cpu":
        return headmix_bwd_plain(w2d, ys, dz, H=H, B=B, A=A, L=L,
                                 y_width=y_width)
    return _launch_bwd(w2d, ys, dz, H, B, A, L, y_width)


class _HeadMix(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w2d, bias, shape, *ys):
        H, B, A, L, y_width = shape
        ctx.shape = shape
        ctx.has_bias = bias is not None
        ctx.save_for_backward(w2d, *ys)
        return headmix_fwd(w2d, ys, bias, H=H, B=B, A=A, L=L,
                           y_width=y_width)

    @staticmethod
    def backward(ctx, dz):
        H, B, A, L, y_width = ctx.shape
        w2d, *ys = ctx.saved_tensors
        dw, dys = headmix_bwd(w2d, ys, dz.contiguous(), H=H, B=B, A=A, L=L,
                              y_width=y_width)
        dbias = dz.sum(dim=0) if ctx.has_bias else None
        return (dw, dbias, None) + tuple(dys)


def head_mix_fused(w2d: torch.Tensor, ys: Sequence[torch.Tensor], *, H: int,
                   B: int, A: int, L: int, y_width: int = 0,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Head mix of ``w2d [n, H*B*A]`` with the A arrays ``ys [n, y_width]``
    -> ``[n, H*L]``, bias folded in (``egc_tpu`` ``head_mix_fused``); the
    span ``egc.headmix``."""
    ys = tuple(ys)
    y_width = y_width or B * L
    if y_width < B * L:
        raise ValueError("y_width must be >= B*L")
    if len(ys) != A or w2d.shape[1] != H * B * A \
            or any(tuple(y.shape) != (w2d.shape[0], y_width) for y in ys):
        raise ValueError("head_mix_fused: inconsistent shapes")
    if bias is not None and tuple(bias.shape) != (H * L,):
        raise ValueError("bias must be [H*L]")
    with span("egc.headmix"):
        return _HeadMix.apply(w2d, bias, (H, B, A, L, y_width), *ys)
