"""Time builds of the gather-reduce kernels, the head-mix kernels, the
three GAT kernels, the three GATv2 kernels and the three wide GATv2
kernels against each other on one card, at the shapes of their paths.

    python3 -m egc_tpu_torch.exp.kernel_ab --versions DIR [DIR ...] \\
        [--rounds 2] [--cases PREFIX ...] [--out results.json]

Each DIR holds another build's ``gather_reduce.cu``, ``headmix.cu``,
``gat_attention.cu``, ``gatv2_attention.cu`` and
``gatv2_attention_wide.cu`` (with the ``*.cuh`` headers they include; a
case runs only the source it names), for example an earlier commit's
``egc_tpu_torch/csrc/``; the package's own sources are the version
``current``. Every version is built with the package's nvcc flags, its
``ptxas`` register report kept, its output held against the plain PyTorch
version, and timed in turns (current, the others, the others again,
current: ``--rounds`` such passes) with CUDA events on the same inputs: the
synthetic arxiv-shaped graph (169,343 nodes, 2,368,458 edges) at F = 128.

- The gather-reduce pair, for the main path's primitives (sum, wsum, max)
  and for the six aggregators sum / mean / max / min / var / std (sum,
  sumsq, max, min): the forward as the path calls it (with the max / min
  masks where the build writes them; a build of the packed-row interface,
  before the masks, writes none) and without the masks, the backward
  kernel alone (a build with masks from its own forward's masks; an older
  build from the coefficient row packed ahead of the timed call, with the
  forward's max and min in it) and at the level of
  ``_FusedPrimitives.backward`` (an older build: the ``torch.cat`` of the
  cotangents and max / min, then its kernel; the current one: its kernel).
  Every version's outputs, d_vals included, must equal the current
  version's bitwise.
- The head mix at H4 B4 A3 L32, forward beside
  ``torch.einsum("nhba,nabl->nhl")`` and backward beside the two einsum
  calls of its gradient (``"nhl,nabl->nhba"`` for dw, ``"nhba,nhl->nabl"``
  for dy); ``gat_fwd``, ``gat_bwd_t`` and ``gat_bwd_f`` at (H8, C19) and
  (H1, C152); ``gatv2_bwd_t``, ``gatv2_fwd`` and ``gatv2_bwd_f`` at
  (H8, C14) and (H1, C112); and ``gatv2w_bwd_t``, ``gatv2w_bwd_f`` and
  ``gatv2w_fwd`` at (H1, C750), the head of GATv2 h750 H3's last layer
  (a build's d_att partial rows by its ``gatv2w_att_rows`` or, before
  it, ``gatv2w_att_blocks``), on the graph and again (the cases ending
  in ``hub``) on the graph with ``HUB_EDGES`` more in-edges into one
  receiver and as many more out-edges from one sender, which one block
  of each kernel walks serially.

Outputs are held at rtol = atol = 1e-5 (the masks exactly), except
``gatv2_bwd_f``'s and ``gatv2w_bwd_f``'s d_att (a sum over every edge
whose terms cancel), held after its rows are summed at relative L2 <=
1e-4, and in the hub cases the hub rows of every output (sums of
``HUB_EDGES`` terms), each held at relative L2 <= 1e-4; two launches of
a version must agree bitwise. ``--cases`` keeps the cases whose names start
with one of its prefixes. Prints one JSON line per measurement, then
each case's median per version beside the ``ptxas`` registers and spills
of that version's kernel, and the card's ``nvidia-smi`` name and power
limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
from pathlib import Path

import torch

from egc_tpu_torch.ops.cuda import _build
from egc_tpu_torch.ops.cuda import attention as at
from egc_tpu_torch.ops.cuda import gather_reduce as gr
from egc_tpu_torch.ops.cuda import headmix as hm

KERNEL_SOURCES = ("gather_reduce", "headmix", "gat_attention",
                  "gatv2_attention", "gatv2_attention_wide")
GATHER_PRIMS = {"sum,wsum,max": ("sum", "wsum", "max"),
                "6 aggregators": ("sum", "sumsq", "max", "min")}
_COEFF_OF = {"sum": "c_sum", "wsum": "c_wsum", "sumsq": "c_sumsq2",
             "max": "c_max", "min": "c_min"}
_OLD_SEGS = ("c_sum", "c_wsum", "c_sumsq2", "mx", "c_max", "mn", "c_min")
HEADMIX_SHAPE = dict(H=4, B=4, A=3, L=32)
GAT_SHAPES = ((8, 19), (1, 152))
GATV2_SHAPES = ((8, 14), (1, 112))
GATV2_WIDE_SHAPES = ((1, 750),)
HUB_EDGES = 10_000   # the hub cases' extra edges into / out of one node
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build_version(label: str, csrc: Path, sources=KERNEL_SOURCES) -> dict:
    """nvcc each of ``sources`` in ``csrc`` into ``_build/ab_<label>/``;
    returns ``{source: (CDLL, ptxas lines)}``."""
    out_dir = _build.BUILD_DIR / f"ab_{label}"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in sources:
        lib = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(lib), str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        report = proc.communicate()[0]
        lib.with_suffix(".log").write_text(report)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}/{name}:\n{report}")
        built[name] = (ctypes.CDLL(str(lib)), _build.ptxas_summary(report))
    return built


def _has_masks(lib) -> bool:
    """Whether a gather-reduce build takes the extremum masks (this
    interface) or the packed coefficient row (the one before it)."""
    return hasattr(lib, "gather_reduce_mask_words")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def gr_fwd(lib, vals, plan, prims, with_masks=True):
    """A build's forward as the main path calls it: the outputs of
    ``prims``, then (a build with masks, unless ``with_masks`` is False)
    the max / min masks."""
    n, f = vals.shape
    outs = {p: torch.empty(n, f, device=vals.device) for p in prims}
    bits = sum(gr._PRIM_BIT[p] for p in prims)
    w = plan.fwd_w if "wsum" in prims else None
    fn = lib.gather_reduce_fwd
    fn.restype = ctypes.c_int
    if _has_masks(lib):
        masks = tuple(m for m in gr.EXTREMA if m in prims and with_masks)
        wf = lib.gather_reduce_mask_words
        wf.restype, wf.argtypes = ctypes.c_int, [_I]
        words = {m: torch.empty(plan.num_edges, wf(f), dtype=torch.int32,
                                device=vals.device) for m in masks}
        fn.argtypes = [_P] * 5 + [_I] * 3 + [_P] * 8
        err = fn(vals.data_ptr(), plan.rowptr.data_ptr(),
                 plan.fwd_senders.data_ptr(), gr._ptr(w),
                 gr._ptr(plan.fwd_to_bwd if masks else None), n, f, bits,
                 *[gr._ptr(outs.get(p)) for p in gr.PRIMS],
                 *[gr._ptr(words.get(m)) for m in gr.EXTREMA], _stream())
    else:
        masks, words = (), {}
        fn.argtypes = [_P] * 4 + [_I] * 3 + [_P] * 5 + [_I, _P]
        err = fn(vals.data_ptr(), plan.rowptr.data_ptr(),
                 plan.fwd_senders.data_ptr(), gr._ptr(w), n, f, bits,
                 *[gr._ptr(outs.get(p)) for p in gr.PRIMS], 1, _stream())
    _build.check_launch(err, "gather_reduce_fwd", lib)
    return tuple(outs[p] for p in prims) + tuple(words[m] for m in masks)


def old_packed(coeffs, ext):
    """The packed row of the interface before the masks: the present
    segments of ``c_sum|c_wsum|c_sumsq2|mx|c_max|mn|c_min`` side by side,
    mx / mn the forward's max / min; and the segments' positions."""
    cols = {**coeffs, "mx": ext.get("max"), "mn": ext.get("min")}
    segs = [k for k in _OLD_SEGS if k in coeffs
            or (k == "mx" and "c_max" in coeffs)
            or (k == "mn" and "c_min" in coeffs)]
    pos = (ctypes.c_int * 7)(*[segs.index(k) if k in segs else -1
                               for k in _OLD_SEGS])
    return torch.cat([cols[k] for k in segs], 1).contiguous(), pos


def gr_bwd(lib, plan, coeffs, vals, words, packed=None):
    """A build's backward: this interface from ``coeffs`` and the masks
    ``words``; the one before from the packed row ``packed`` (an
    ``old_packed`` result)."""
    n, f = vals.shape
    d_vals = torch.empty(n, f, device=vals.device)
    w = plan.bwd_w if "c_wsum" in coeffs else None
    fn = lib.gather_reduce_bwd
    fn.restype = ctypes.c_int
    if _has_masks(lib):
        fn.argtypes = [_P] * 11 + [_I] * 2 + [_P] * 2
        err = fn(*[gr._ptr(coeffs.get(k)) for k in gr.COEFFS],
                 gr._ptr(words.get("max")), gr._ptr(words.get("min")),
                 gr._ptr(vals if "c_sumsq2" in coeffs else None),
                 plan.colptr.data_ptr(), plan.bwd_receivers.data_ptr(),
                 gr._ptr(w), n, f, d_vals.data_ptr(), _stream())
    else:
        coeff, pos = packed
        fn.argtypes = [_P] * 5 + [_I] * 3 + [_P, _P, _I, _P]
        err = fn(coeff.data_ptr(), vals.data_ptr(), plan.colptr.data_ptr(),
                 plan.bwd_receivers.data_ptr(), gr._ptr(w), n, f,
                 coeff.shape[1] // f, pos, d_vals.data_ptr(), 1, _stream())
    _build.check_launch(err, "gather_reduce_bwd", lib)
    return (d_vals,)


_OWN_MASKS = {}


def own_masks(lib, vals, plan, prims) -> dict:
    """The max / min masks of ``lib``'s own forward (made once), which its
    backward reads; none for a build before the masks."""
    key = (id(lib), prims)
    if key not in _OWN_MASKS:
        res = gr_fwd(lib, vals, plan, prims)
        _OWN_MASKS[key] = dict(zip([m for m in gr.EXTREMA if m in prims],
                                   res[len(prims):]))
    return _OWN_MASKS[key]


def gr_backward_level(lib, plan, cts, vals, ext, words):
    """``_FusedPrimitives.backward`` of a build: the coefficients from
    the cotangents ``cts``, then (the interface before the masks) the
    ``torch.cat`` of the packed row, then the kernel."""
    coeffs = {_COEFF_OF[p]: (2.0 * c if p == "sumsq" else c)
              for p, c in cts.items()}
    packed = None if _has_masks(lib) else old_packed(coeffs, ext)
    return gr_bwd(lib, plan, coeffs, vals, words, packed)


def _gather_cases(plan, randn):
    """The gather-reduce cases at F = 128 (see the module's docstring)."""
    cases = {}
    n = plan.num_nodes
    vals = randn(n, 128)
    for label, prims in GATHER_PRIMS.items():
        masks = tuple(m for m in gr.EXTREMA if m in prims)
        mkw = dict(masks=masks, fwd_to_bwd=plan.fwd_to_bwd)
        ref_fwd = gr.gather_reduce_fwd_plain(
            vals, plan.rowptr, plan.fwd_senders, plan.fwd_w, prims, **mkw)
        ext = dict(zip(prims, ref_fwd))
        words = dict(zip(masks, ref_fwd[len(prims):]))
        cts = {p: randn(n, 128) for p in prims}
        coeffs = {_COEFF_OF[p]: c for p, c in cts.items()}
        packed = old_packed(coeffs, ext)
        bkw = dict(coeffs, edge_w=plan.bwd_w, vals=vals,
                   max_mask=words.get("max"), min_mask=words.get("min"))
        ref_bwd = (gr.gather_reduce_bwd_plain(
            plan.colptr, plan.bwd_receivers, **bkw),)
        level_kw = dict(bkw, c_sumsq2=2.0 * cts["sumsq"]) \
            if "sumsq" in cts else bkw
        ref_level = (gr.gather_reduce_bwd_plain(
            plan.colptr, plan.bwd_receivers, **level_kw),)
        cases[f"gather_reduce_fwd {label}"] = (
            "gather_reduce",
            lambda lib, p=prims: gr_fwd(lib, vals, plan, p), ref_fwd, {},
            None, True)
        cases[f"gather_reduce_fwd {label}, no mask"] = (
            "gather_reduce",
            lambda lib, p=prims: gr_fwd(lib, vals, plan, p, False),
            ref_fwd[:len(prims)], {}, None, True)
        cases[f"gather_reduce_bwd {label}"] = (
            "gather_reduce",
            lambda lib, c=coeffs, p=prims, pk=packed: gr_bwd(
                lib, plan, c, vals, own_masks(lib, vals, plan, p), pk),
            ref_bwd, {}, None, True)
        cases[f"gather_reduce_bwd {label}, _FusedPrimitives.backward"] = (
            "gather_reduce",
            lambda lib, c=cts, x=ext, p=prims: gr_backward_level(
                lib, plan, c, vals, x, own_masks(lib, vals, plan, p)),
            ref_level, {}, None, True)
    return cases


def headmix_fwd(lib, w2d, ys, bias, H, B, A, L):
    fn = lib.headmix_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([_P, ctypes.POINTER(_P), _I, _P] + [_I] * 5 + [_P, _P])
    n = w2d.shape[0]
    z = torch.empty(n, H * L, device=w2d.device)
    err = fn(w2d.data_ptr(), (_P * hm.MAX_AGGRS)(*[y.data_ptr() for y in ys]),
             A, bias.data_ptr(), n, H, B, L, B * L, z.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "headmix_fwd", lib)
    return z


def headmix_bwd(lib, w2d, ys, dz, H, B, A, L):
    fn = lib.headmix_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([_P, ctypes.POINTER(_P), _P] + [_I] * 6
                   + [_P, ctypes.POINTER(_P), _P])
    n = w2d.shape[0]
    dw = torch.empty(n, H * B * A, device=w2d.device)
    dys = [torch.empty(n, B * L, device=w2d.device) for _ in range(A)]
    err = fn(w2d.data_ptr(), (_P * hm.MAX_AGGRS)(*[y.data_ptr() for y in ys]),
             dz.data_ptr(), A, n, H, B, L, B * L, dw.data_ptr(),
             (_P * hm.MAX_AGGRS)(*[d.data_ptr() for d in dys]),
             torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "headmix_bwd", lib)
    return (dw, *dys)


def _attention(lib, name, inputs, outs, heads, c):
    """Launch ``name`` of a GAT or GATv2 build: the tensors ``inputs``,
    then (n, H, C, slope), then the tensors ``outs``."""
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([_P] * len(inputs) + [_I] * 3 + [_F] + [_P] * len(outs)
                   + [_P])                                   # the stream
    err = fn(*[t.data_ptr() for t in inputs], inputs[0].shape[0], heads, c,
             at.SLOPE, *[t.data_ptr() for t in outs],
             torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, name, lib)


def gat_fwd(lib, wh, a_src, a_dst, rowptr, senders):
    outs = (torch.empty_like(wh), torch.empty_like(a_src),
            torch.empty_like(a_src))
    heads = a_src.shape[1]
    _attention(lib, "gat_fwd", (wh, a_src, a_dst, rowptr, senders), outs,
               heads, wh.shape[1] // heads)
    return outs


def gat_bwd_t(lib, wh, a_src, a_dst, m, g_o, g_d, colptr, receivers):
    outs = (torch.empty_like(wh), torch.empty_like(a_src))
    heads = a_src.shape[1]
    _attention(lib, "gat_bwd_t", (wh, a_src, a_dst, m, g_o, g_d, colptr,
                                  receivers), outs, heads,
               wh.shape[1] // heads)
    return outs


def gat_bwd_f(lib, wh, a_src, a_dst, m, g_o, g_d, rowptr, senders):
    d_adst = torch.empty_like(a_dst)
    heads = a_src.shape[1]
    _attention(lib, "gat_bwd_f", (wh, a_src, a_dst, m, g_o, g_d, rowptr,
                                  senders), (d_adst,), heads,
               wh.shape[1] // heads)
    return (d_adst,)


def gatv2_fwd(lib, hl, hr, att, rowptr, senders):
    n, heads = hl.shape[0], att.shape[0]
    outs = (torch.empty_like(hl), hl.new_empty(n, heads),
            hl.new_empty(n, heads))
    _attention(lib, "gatv2_fwd", (hl, hr, att, rowptr, senders), outs,
               *att.shape)
    return outs


def gatv2_bwd_t(lib, hl, hr, att, m, g_o, g_d, colptr, receivers):
    d_hl = torch.empty_like(hl)
    _attention(lib, "gatv2_bwd_t",
               (hl, hr, att, m, g_o, g_d, colptr, receivers), (d_hl,),
               *att.shape)
    return (d_hl,)


def _att_rows(lib, prefix, n, heads, c) -> int:
    """Rows of d_att partial sums of a build's ``{prefix}_bwd_f``: by its
    ``gatv2w_att_rows(n, H, C)`` where it has one, else by
    ``{prefix}_att_blocks(n)``."""
    if hasattr(lib, f"{prefix}_att_rows"):
        fn, args = getattr(lib, f"{prefix}_att_rows"), (n, heads, c)
    else:
        fn, args = getattr(lib, f"{prefix}_att_blocks"), (n,)
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int] * len(args)
    return fn(*args)


def gatv2_bwd_f(lib, hl, hr, att, m, g_o, g_d, rowptr, senders,
                prefix="gatv2"):
    """``(d_hr, d_att)``, d_att summed from the build's partial rows."""
    d_hr = torch.empty_like(hl)
    part = hl.new_empty(_att_rows(lib, prefix, hl.shape[0], *att.shape),
                        hl.shape[1])
    _attention(lib, f"{prefix}_bwd_f",
               (hl, hr, att, m, g_o, g_d, rowptr, senders), (d_hr, part),
               *att.shape)
    return d_hr, part.sum(0).view(att.shape)


def gatv2w_fwd(lib, hl, hr, att, rowptr, senders):
    n, heads = hl.shape[0], att.shape[0]
    outs = (torch.empty_like(hl), hl.new_empty(n, heads),
            hl.new_empty(n, heads))
    _attention(lib, "gatv2w_fwd", (hl, hr, att, rowptr, senders), outs,
               *att.shape)
    return outs


def gatv2w_bwd_t(lib, hl, hr, att, m, g_o, g_d, colptr, receivers):
    d_hl = torch.empty_like(hl)
    _attention(lib, "gatv2w_bwd_t",
               (hl, hr, att, m, g_o, g_d, colptr, receivers), (d_hl,),
               *att.shape)
    return (d_hl,)


def gatv2w_bwd_f(lib, *args):
    return gatv2_bwd_f(lib, *args, prefix="gatv2w")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _v2_cases(cases, plan, heads, c, kernels, randn, suffix="", hubs=()):
    """The three GATv2 cases of ``kernels`` (source, fwd, bwd_t, bwd_f)
    at (heads, c) on ``plan``, named ``<kernel> H<heads> C<c><suffix>``;
    the rows ``hubs`` (sums of ``HUB_EDGES`` terms) held by relative L2."""
    src, fn_fwd, fn_t, fn_f = kernels
    n, f = plan.num_nodes, heads * c
    hl, hr = randn(n, f), randn(n, f)
    att = randn(heads, c, scale=1 / math.sqrt(c))
    g_o, g_d = randn(n, f, scale=1 / math.sqrt(c)), randn(n, heads)
    fwd = (hl, hr, att, plan.rowptr, plan.fwd_senders)
    ref_fwd = at.gatv2_fwd_plain(*fwd)
    m = ref_fwd[2]
    bwd_t = (hl, hr, att, m, g_o, g_d, plan.colptr, plan.bwd_receivers)
    bwd_f = (hl, hr, att, m, g_o, g_d, plan.rowptr, plan.fwd_senders)
    shape = f"H{heads} C{c}{suffix}"
    cases[f"{fn_t.__name__} {shape}"] = (
        src, lambda lib, a=bwd_t, fn=fn_t: fn(lib, *a),
        (at.gatv2_bwd_t_plain(*bwd_t),), {0: hubs}, None, False)
    cases[f"{fn_fwd.__name__} {shape}"] = (
        src, lambda lib, a=fwd, fn=fn_fwd: fn(lib, *a),
        ref_fwd, dict.fromkeys(range(3), hubs), None, False)
    cases[f"{fn_f.__name__} {shape}"] = (
        src, lambda lib, a=bwd_f, fn=fn_f: fn(lib, *a),
        at.gatv2_bwd_f_plain(*bwd_f), {0: hubs, 1: None}, None, False)


def _hub_plan(plan, dev):
    """``plan``'s graph with ``HUB_EDGES`` more in-edges into receiver 0
    and as many more out-edges from sender 1, each from or to distinct
    random nodes, beside their earlier edges."""
    import numpy as np
    from egc_tpu_torch.ops.dispatch import build_kernel_plan
    n = plan.num_nodes
    rowptr = plan.rowptr.cpu().numpy()
    r = np.repeat(np.arange(n), np.diff(rowptr))
    s = plan.fwd_senders.cpu().numpy()
    rng = np.random.default_rng(0)
    s = np.concatenate([s, rng.choice(n, HUB_EDGES, replace=False),
                        np.full(HUB_EDGES, 1)])
    r = np.concatenate([r, np.zeros(HUB_EDGES, np.int64),
                        rng.choice(n, HUB_EDGES, replace=False)])
    return build_kernel_plan(s, r, n, device=dev)


def _cases(dev):
    """case -> (kernel source, run(lib) -> outputs, the plain version's
    outputs, the indices of the outputs held by relative L2, (name, the
    library call) or None, whether every version's outputs must equal the
    current version's bitwise)."""
    from egc_tpu_torch.data.synthetic import synthetic_full_graph
    from egc_tpu_torch.exp.fullgraph import full_graph_to_device_dict
    raw = synthetic_full_graph(num_nodes=169_343, avg_degree=14,
                               num_features=128, num_classes=40, seed=0)
    plan = full_graph_to_device_dict(raw, dev)["graph"].kernel_plan
    n = plan.num_nodes
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    cases = _gather_cases(plan, randn)
    H, B, A, L = (HEADMIX_SHAPE[k] for k in "HBAL")
    w2d = randn(n, H * B * A)
    ys = [randn(n, B * L) for _ in range(A)]
    bias = randn(H * L)
    y_st = torch.stack(ys, 1).reshape(n, A, B, L)
    w4 = w2d.reshape(n, H, B, A)
    dz = randn(n, H * L)
    dz4 = dz.reshape(n, H, L)
    cases["headmix_fwd H4 B4 A3 L32"] = (
        "headmix", lambda lib: (headmix_fwd(lib, w2d, ys, bias, H, B, A, L),),
        (hm.headmix_fwd_plain(w2d, ys, bias, **HEADMIX_SHAPE),), (),
        ("einsum", lambda: torch.einsum("nhba,nabl->nhl", w4, y_st)),
        False)
    dw_ref, dys_ref = hm.headmix_bwd_plain(w2d, ys, dz, y_width=B * L,
                                           **HEADMIX_SHAPE)

    def einsum_pair():
        torch.einsum("nhl,nabl->nhba", dz4, y_st)
        torch.einsum("nhba,nhl->nabl", w4, dz4)

    cases["headmix_bwd H4 B4 A3 L32"] = (
        "headmix", lambda lib: headmix_bwd(lib, w2d, ys, dz, H, B, A, L),
        (dw_ref, *dys_ref), {}, ("einsum pair", einsum_pair), False)
    for heads, c in GAT_SHAPES:
        f = heads * c
        wh, a_src, a_dst = randn(n, f), randn(n, heads), randn(n, heads)
        g_o, g_d = randn(n, f, scale=1 / math.sqrt(c)), randn(n, heads)
        fwd = (wh, a_src, a_dst, plan.rowptr, plan.fwd_senders)
        ref_fwd = at.gat_fwd_plain(*fwd)
        m = ref_fwd[2]
        bwd_t = (wh, a_src, a_dst, m, g_o, g_d, plan.colptr,
                 plan.bwd_receivers)
        bwd_f = (wh, a_src, a_dst, m, g_o, g_d, plan.rowptr, plan.fwd_senders)
        shape = f"H{heads} C{c}"
        cases[f"gat_fwd {shape}"] = (
            "gat_attention", lambda lib, a=fwd: gat_fwd(lib, *a), ref_fwd,
            {}, None, False)
        cases[f"gat_bwd_t {shape}"] = (
            "gat_attention", lambda lib, a=bwd_t: gat_bwd_t(lib, *a),
            at.gat_bwd_t_plain(*bwd_t), {}, None, False)
        cases[f"gat_bwd_f {shape}"] = (
            "gat_attention", lambda lib, a=bwd_f: gat_bwd_f(lib, *a),
            (at.gat_bwd_f_plain(*bwd_f),), {}, None, False)
    narrow = ("gatv2_attention", gatv2_fwd, gatv2_bwd_t, gatv2_bwd_f)
    wide = ("gatv2_attention_wide", gatv2w_fwd, gatv2w_bwd_t, gatv2w_bwd_f)
    for heads, c in GATV2_SHAPES:
        _v2_cases(cases, plan, heads, c, narrow, randn)
    hub = _hub_plan(plan, dev)
    for heads, c in GATV2_WIDE_SHAPES:
        _v2_cases(cases, plan, heads, c, wide, randn)
        _v2_cases(cases, hub, heads, c, wide, randn, " hub", hubs=(0, 1))
    return cases


def _rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-30))


def _held(got, ref, rel_l2_rows) -> dict:
    """Each output against the plain version's: max abs error, and whether
    all are within rtol = atol = 1e-5; an integer output, a mask,
    exactly. ``rel_l2_rows`` maps an output's index to what is held by
    relative L2 <= 1e-4 instead, a sum whose terms cancel: the whole
    output (None) or each of the rows it names."""
    ok, errs, rels = True, [], {}
    for i, (a, b) in enumerate(zip(got, ref)):
        if a.shape != b.shape:
            ok = False
            continue
        errs.append(float((a - b).abs().max()))
        rows = rel_l2_rows.get(i, ())
        if not a.is_floating_point():
            ok = ok and torch.equal(a, b)
        elif rows is None:
            rels[i] = _rel_l2(a, b)
            ok = ok and rels[i] <= 1e-4
        else:
            rest = torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
            rest[list(rows)] = False
            ok = ok and torch.allclose(a[rest], b[rest], rtol=1e-5,
                                       atol=1e-5)
            for row in rows:
                rels[f"{i}[{row}]"] = _rel_l2(a[row], b[row])
                ok = ok and rels[f"{i}[{row}]"] <= 1e-4
    return dict(allclose=ok, max_abs_err=max(errs, default=None),
                rel_l2=rels)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--versions", nargs="*", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cases", nargs="*", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cases = {c: v for c, v in _cases(dev).items() if args.cases is None
             or any(c.startswith(p) for p in args.cases)}
    sources = sorted({v[0] for v in cases.values()})
    versions = {"current": build_version("current", _build.CSRC, sources)}
    for d in args.versions:
        versions[Path(d).name] = build_version(Path(d).name, Path(d),
                                               sources)
    for label, built in versions.items():
        for name, (_, report) in built.items():
            for line in report:
                print(f"[ptxas] {label}/{name}: {line}", flush=True)
    results = []
    for case, (src, run, ref, rel_l2_rows, library,
               across) in cases.items():
        current = run(versions["current"][src][0])
        for label, built in versions.items():
            got = run(built[src][0])
            torch.cuda.synchronize()
            same = all(torch.equal(a, b)
                       for a, b in zip(got, run(built[src][0])))
            # a build without the masks returns the outputs before them
            as_current = all(torch.equal(a, b)
                             for a, b in zip(got, current))
            results.append(dict(case=case, version=label, check=True,
                                repeat_bitwise=same,
                                equal_to_current=as_current if across
                                else None,
                                **_held(got, ref, rel_l2_rows)))
            print(json.dumps(results[-1]), flush=True)
        others = [v for v in versions if v != "current"]
        order = (["current"] + others + others[::-1] + ["current"]) \
            * args.rounds
        for i, label in enumerate(order):
            lib = versions[label][src][0]
            results.append(dict(case=case, version=label, turn=i,
                                ms=time_ms(lambda: run(lib))))
            print(json.dumps(results[-1]), flush=True)
        if library is not None:
            results.append(dict(case=case, version=f"library {library[0]}",
                                ms=time_ms(library[1])))
            print(json.dumps(results[-1]), flush=True)
    summary = {}
    for r in results:
        if "ms" in r:
            summary.setdefault(r["case"], {}).setdefault(
                r["version"], []).append(r["ms"])
    summary = {c: {v: statistics.median(t) for v, t in vs.items()}
               for c, vs in summary.items()}
    registers = {}
    for case, by_version in summary.items():
        kernel = case.split()[0] + "_kernel"
        for label, ms in by_version.items():
            lines = [ln for ln in versions[label][cases[case][0]][1]
                     if ln.startswith(kernel)] if label in versions else []
            registers.setdefault(case, {})[label] = lines
            print(f"[median] {case} | {label}: {ms:.4f} ms | "
                  f"{'; '.join(lines) or '-'}", flush=True)
    print(json.dumps({"summary_median_ms": summary, "card": smi}))
    print(smi)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"results": results, "summary": summary, "card": smi,
                       "registers": registers,
                       "ptxas": {f"{lb}/{n}": rep for lb, b in versions.items()
                                 for n, (_, rep) in b.items()}}, fh, indent=1)
    bad = [r for r in results if r.get("check")
           and not (r["allclose"] and r["repeat_bitwise"]
                    and r["equal_to_current"] is not False)]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
