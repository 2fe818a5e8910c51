"""Time builds of the head-mix kernels, the three GAT kernels and the
three GATv2 kernels against each other on one card, at the shapes of their
paths.

    python3 -m egc_tpu_torch.exp.kernel_ab --versions DIR [DIR ...] \\
        [--rounds 2] [--out results.json]

Each DIR holds another build's ``headmix.cu``, ``gat_attention.cu`` and
``gatv2_attention.cu`` (with the ``*.cuh`` headers they include), for
example an earlier commit's ``egc_tpu_torch/csrc/``; the package's own
sources are the version ``current``. Every version is built with the
package's nvcc flags, its ``ptxas`` register report kept, its output held
against the plain PyTorch version, and timed in turns (current, the
others, the others again, current: ``--rounds`` such passes) with CUDA
events on the same inputs: the synthetic arxiv-shaped graph (169,343
nodes, 2,368,458 edges); the head mix at H4 B4 A3 L32, forward beside
``torch.einsum("nhba,nabl->nhl")`` and backward beside the two einsum
calls of its gradient (``"nhl,nabl->nhba"`` for dw, ``"nhba,nhl->nabl"``
for dy); ``gat_fwd``, ``gat_bwd_t`` and ``gat_bwd_f`` at (H8, C19) and (H1,
C152); and ``gatv2_bwd_t``, ``gatv2_fwd`` and ``gatv2_bwd_f`` at (H8, C14)
and (H1, C112). Outputs are held at rtol = atol = 1e-5, except ``gatv2_bwd_f``'s
d_att (a sum over every edge whose terms cancel), held after its rows are
summed at relative L2 <= 1e-4; two launches of a version must agree
bitwise. Prints one JSON line per measurement and the card's
``nvidia-smi`` name and power limit. Needs a CUDA device.
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
from egc_tpu_torch.ops.cuda import headmix as hm

KERNEL_SOURCES = ("headmix", "gat_attention", "gatv2_attention")
HEADMIX_SHAPE = dict(H=4, B=4, A=3, L=32)
GAT_SHAPES = ((8, 19), (1, 152))
GATV2_SHAPES = ((8, 14), (1, 112))
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build_version(label: str, csrc: Path) -> dict:
    """nvcc each kernel source of ``csrc`` into ``_build/ab_<label>/``;
    returns ``{source: (CDLL, ptxas lines)}``."""
    out_dir = _build.BUILD_DIR / f"ab_{label}"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in KERNEL_SOURCES:
        lib = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(lib), str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}/{name}:\n{report}")
        built[name] = (ctypes.CDLL(str(lib)), _build.ptxas_summary(report))
    return built


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


def gatv2_bwd_f(lib, hl, hr, att, m, g_o, g_d, rowptr, senders):
    """``(d_hr, d_att)``, d_att summed from the build's partial rows."""
    blocks = lib.gatv2_att_blocks
    blocks.restype, blocks.argtypes = ctypes.c_int, [ctypes.c_int]
    d_hr = torch.empty_like(hl)
    part = hl.new_empty(blocks(hl.shape[0]), hl.shape[1])
    _attention(lib, "gatv2_bwd_f",
               (hl, hr, att, m, g_o, g_d, rowptr, senders), (d_hr, part),
               *att.shape)
    return d_hr, part.sum(0).view(att.shape)


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


def _cases(dev):
    """case -> (kernel source, run(lib) -> outputs, the plain version's
    outputs, the indices of the outputs held by relative L2, (name, the
    library call) or None)."""
    from egc_tpu_torch.data.synthetic import synthetic_full_graph
    from egc_tpu_torch.exp.fullgraph import full_graph_to_device_dict
    raw = synthetic_full_graph(num_nodes=169_343, avg_degree=14,
                               num_features=128, num_classes=40, seed=0)
    plan = full_graph_to_device_dict(raw, dev)["graph"].kernel_plan
    n = plan.num_nodes
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    cases = {}
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
        ("einsum", lambda: torch.einsum("nhba,nabl->nhl", w4, y_st)))
    dw_ref, dys_ref = hm.headmix_bwd_plain(w2d, ys, dz, y_width=B * L,
                                           **HEADMIX_SHAPE)

    def einsum_pair():
        torch.einsum("nhl,nabl->nhba", dz4, y_st)
        torch.einsum("nhba,nhl->nabl", w4, dz4)

    cases["headmix_bwd H4 B4 A3 L32"] = (
        "headmix", lambda lib: headmix_bwd(lib, w2d, ys, dz, H, B, A, L),
        (dw_ref, *dys_ref), (), ("einsum pair", einsum_pair))
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
            (), None)
        cases[f"gat_bwd_t {shape}"] = (
            "gat_attention", lambda lib, a=bwd_t: gat_bwd_t(lib, *a),
            at.gat_bwd_t_plain(*bwd_t), (), None)
        cases[f"gat_bwd_f {shape}"] = (
            "gat_attention", lambda lib, a=bwd_f: gat_bwd_f(lib, *a),
            (at.gat_bwd_f_plain(*bwd_f),), (), None)
    for heads, c in GATV2_SHAPES:
        f = heads * c
        hl, hr = randn(n, f), randn(n, f)
        att = randn(heads, c, scale=1 / math.sqrt(c))
        g_o, g_d = randn(n, f, scale=1 / math.sqrt(c)), randn(n, heads)
        fwd = (hl, hr, att, plan.rowptr, plan.fwd_senders)
        ref_fwd = at.gatv2_fwd_plain(*fwd)
        m = ref_fwd[2]
        bwd_t = (hl, hr, att, m, g_o, g_d, plan.colptr, plan.bwd_receivers)
        bwd_f = (hl, hr, att, m, g_o, g_d, plan.rowptr, plan.fwd_senders)
        shape = f"H{heads} C{c}"
        cases[f"gatv2_bwd_t {shape}"] = (
            "gatv2_attention", lambda lib, a=bwd_t: gatv2_bwd_t(lib, *a),
            (at.gatv2_bwd_t_plain(*bwd_t),), (), None)
        cases[f"gatv2_fwd {shape}"] = (
            "gatv2_attention", lambda lib, a=fwd: gatv2_fwd(lib, *a),
            ref_fwd, (), None)
        cases[f"gatv2_bwd_f {shape}"] = (
            "gatv2_attention", lambda lib, a=bwd_f: gatv2_bwd_f(lib, *a),
            at.gatv2_bwd_f_plain(*bwd_f), (1,), None)
    return cases


def _held(got, ref, rel_l2_outputs) -> dict:
    """Each output against the plain version's: max abs error, and whether
    all are within rtol = atol = 1e-5 (relative L2 <= 1e-4 for the outputs
    in ``rel_l2_outputs``)."""
    ok, errs, rels = True, [], {}
    for i, (a, b) in enumerate(zip(got, ref)):
        errs.append(float((a - b).abs().max()))
        if i in rel_l2_outputs:
            rels[i] = float((a.double() - b.double()).norm()
                            / b.double().norm().clamp_min(1e-30))
            ok = ok and rels[i] <= 1e-4
        else:
            ok = ok and torch.allclose(a, b, rtol=1e-5, atol=1e-5)
    return dict(allclose=ok, max_abs_err=max(errs), rel_l2=rels)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--versions", nargs="*", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    versions = {"current": build_version("current", _build.CSRC)}
    for d in args.versions:
        versions[Path(d).name] = build_version(Path(d).name, Path(d))
    for label, built in versions.items():
        for name, (_, report) in built.items():
            for line in report:
                print(f"[ptxas] {label}/{name}: {line}", flush=True)
    cases = _cases(dev)
    results = []
    for case, (src, run, ref, rel_l2_outputs, library) in cases.items():
        for label, built in versions.items():
            got = run(built[src][0])
            torch.cuda.synchronize()
            same = all(torch.equal(a, b)
                       for a, b in zip(got, run(built[src][0])))
            results.append(dict(case=case, version=label, check=True,
                                repeat_bitwise=same,
                                **_held(got, ref, rel_l2_outputs)))
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
    print(json.dumps({"summary_median_ms": summary, "card": smi}))
    print(smi)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"results": results, "summary": summary, "card": smi,
                       "ptxas": {f"{lb}/{n}": rep for lb, b in versions.items()
                                 for n, (_, rep) in b.items()}}, fh, indent=1)
    bad = [r for r in results if r.get("check")
           and not (r["allclose"] and r["repeat_bitwise"])]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
