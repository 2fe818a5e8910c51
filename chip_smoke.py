#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``egc_tpu_torch``) on one H100.

    python3 chip_smoke.py [--out results.json]

Phases, each of which raises (exit code 1) on any failed check:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmuls and cuDNN.
2. build: every kernel source under ``egc_tpu_torch/csrc/`` with nvcc for
   sm_90a, timed.
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (169,343 nodes, F = 128, 2,368,458 edges, prims
   sum/wsum/max, K = 4 coefficient segments, head mix H4 B4 A3 L32), values
   and gradients through the autograd functions, then again at a small
   size with empty receivers, ties, F = 40 and 37, and A = 1. Kernel,
   plain and library times are medians of CUDA-event timed launches.
4. main path: ``train_full_graph`` (arxiv EGC-M, h128 H4 B4
   symnorm/max/mean, 3 layers) on the 169,343-node synthetic graph. One
   dropout-0 step on the card is held against the same step of the port
   on the CPU (loss and every gradient); then 2 warm-up and 10 timed
   dropout-0.2 steps with the launch counters reset just before and read
   just after, each kernel launching 3 times per step; then a
   torch.profiler table of two more steps (device time by kernel).

Printed at the end: one JSON line per the kernels, the nvidia-smi line, and
the result line ``{"ok": true, "device": {...}}``. Without a CUDA device,
or outside the repository, it exits nonzero and prints no result.
``--out`` writes every measured number to a JSON file.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
STEPS_WARMUP, STEPS_TIMED = 2, 10
# tolerances, with why:
SUM_RTOL = SUM_ATOL = 1e-5     # f32 sums of <= ~40 terms in another order
GRAD_REL_L2 = 1e-4             # autograd vs kernel backward; var/std
#                                cancel two large terms
STEP_LOSS_RTOL = 1e-5          # card vs CPU step: cuBLAS vs CPU matmul
STEP_GRAD_REL_L2 = 1e-3        # card vs CPU at full size: max and ReLU
#   selections that flip under another rounding move whole cotangents; the
#   step prints the spread that 1e-7 input noise gives on the CPU alone


class CheckFailed(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(got, ref) -> float:
    got, ref = got.double(), ref.double().to(got.device)
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timed calls of ``fn``."""
    import torch
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


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0],
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    log(f"[device] {smi} | torch {info['torch']} cuda {info['cuda']} "
        f"python {info['python']} | devices {info['count']}")
    return info


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build() -> dict:
    from egc_tpu_torch.ops.cuda import _build
    libs = _build.build_all()
    for name, path in libs.items():
        log(f"[build] {name}: {path.name}")
        report = path.with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build]   {line.strip()}")
    log(f"[build] {_build.build_seconds:.3f} s")
    return {"build_seconds": _build.build_seconds}


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def _close(name, got, ref, exact=False):
    import torch
    got, ref = got.detach(), ref.detach()
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    if exact:
        check(torch.equal(got, ref), f"{name}: not equal (max err {err})")
    else:
        check(torch.allclose(got, ref, rtol=SUM_RTOL, atol=SUM_ATOL),
              f"{name}: max abs err {err} beyond rtol/atol {SUM_RTOL}")
    return err


def kernels_main_shapes(data, H=4, B=4, A=3) -> list:
    """Each kernel vs its plain version at the main path's shapes."""
    import torch
    from egc_tpu_torch.ops.cuda import gather_reduce as gr
    from egc_tpu_torch.ops.cuda import headmix as hm
    from egc_tpu_torch.ops.dispatch import fused_multi_aggregate
    from egc_tpu_torch.ops.segment import multi_aggregate

    g, plan = data["graph"], data["graph"].kernel_plan
    n, e, f = g.num_nodes, plan.num_edges, 128
    L = f // B
    dev = g.nodes.device
    gen = torch.Generator(device=dev).manual_seed(0)
    vals = torch.randn(n, f, generator=gen, device=dev)
    prims = ("sum", "wsum", "max")
    rows = []

    # kernel 1
    args = (vals, plan.rowptr, plan.fwd_senders, plan.fwd_w, prims)
    outs = gr.gather_reduce_fwd(*args)
    ref = gr.gather_reduce_fwd_plain(*args)
    err = max(_close(f"gather_reduce_fwd[{p}]", o, r, exact=(p == "max"))
              for p, o, r in zip(prims, outs, ref))
    nbytes = 4 * (n * f + (n + 1) + 2 * e + len(prims) * n * f)
    b_ms, b_by = bound_ms(nbytes, 4.0 * e * f)
    rows.append(dict(
        name="gather_reduce_fwd", route="cuda",
        source="egc_tpu_torch/csrc/gather_reduce.cu",
        replaces="egc_tpu/ops/pallas/gather_reduce.py:504",
        max_abs_err=err, ms=time_ms(lambda: gr.gather_reduce_fwd(*args)),
        plain_ms=time_ms(lambda: gr.gather_reduce_fwd_plain(*args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library_note="no single PyTorch call computes sum, wsum and max"))

    # kernel 2: the main path's segments, mx from the forward above
    segs = ("c_sum", "c_wsum", "mx", "c_max")
    mx = outs[2]
    coeff = torch.cat([torch.randn(n, f, generator=gen, device=dev),
                       torch.randn(n, f, generator=gen, device=dev), mx,
                       torch.randn(n, f, generator=gen, device=dev)], 1)
    bargs = (coeff.contiguous(), vals, plan.colptr, plan.bwd_receivers,
             plan.bwd_w, segs)
    err = _close("gather_reduce_bwd", gr.gather_reduce_bwd(*bargs),
                 gr.gather_reduce_bwd_plain(*bargs))
    nbytes = 4 * (n * len(segs) * f + n * f + (n + 1) + 2 * e + n * f)
    b_ms, b_by = bound_ms(nbytes, 6.0 * e * f)
    rows.append(dict(
        name="gather_reduce_bwd", route="cuda",
        source="egc_tpu_torch/csrc/gather_reduce.cu",
        replaces="egc_tpu/ops/pallas/gather_reduce.py:839",
        max_abs_err=err, ms=time_ms(lambda: gr.gather_reduce_bwd(*bargs)),
        plain_ms=time_ms(lambda: gr.gather_reduce_bwd_plain(*bargs)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library_note="no single PyTorch call computes this gradient"))

    # kernels 1+2 through the autograd function vs the plain segment path
    aggrs = ("symnorm", "max", "mean")
    x1 = vals.clone().requires_grad_(True)
    x2 = vals.clone().requires_grad_(True)
    ct = torch.randn(n, len(aggrs), f, generator=gen, device=dev)
    y1 = fused_multi_aggregate(x1, plan, aggrs,
                               symnorm_self_w=g.self_weight)
    y2 = multi_aggregate(x2, g.senders, g.receivers, aggrs,
                         edge_mask=g.edge_mask,
                         symnorm_edge_w=g.edge_weight,
                         symnorm_self_w=g.self_weight)
    _close("fused_multi_aggregate", y1, y2)
    (y1 * ct).sum().backward()
    (y2 * ct).sum().backward()
    r = rel_l2(x1.grad, x2.grad)
    check(r <= GRAD_REL_L2, f"fused_multi_aggregate grad rel L2 {r}")
    log(f"[kernels] fused_multi_aggregate vs segment path: grad rel L2 {r:.3e}")

    # kernels 3 and 4
    O, HBA = H * L, H * B * A
    w2d = torch.randn(n, HBA, generator=gen, device=dev)
    ys = [torch.randn(n, B * L, generator=gen, device=dev) for _ in range(A)]
    bias = torch.randn(O, generator=gen, device=dev)
    dz = torch.randn(n, O, generator=gen, device=dev)
    kw = dict(H=H, B=B, A=A, L=L)
    err = _close("headmix_fwd",
                 hm.headmix_fwd(w2d, ys, bias, y_width=B * L, **kw),
                 hm.headmix_fwd_plain(w2d, ys, bias, **kw))
    y_st = torch.stack(ys, 1).reshape(n, A, B, L)
    w4 = w2d.reshape(n, H, B, A)
    nbytes = 4 * (n * HBA + A * n * B * L + O + n * O)
    b_ms, b_by = bound_ms(nbytes, 2.0 * B * A * n * O)
    rows.append(dict(
        name="headmix_fwd", route="cuda", source="egc_tpu_torch/csrc/headmix.cu",
        replaces="egc_tpu/ops/pallas/headmix.py:146", max_abs_err=err,
        ms=time_ms(lambda: hm.headmix_fwd(w2d, ys, bias, y_width=B * L,
                                          **kw)),
        plain_ms=time_ms(lambda: hm.headmix_fwd_plain(w2d, ys, bias, **kw)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.einsum("nhba,nabl->nhl", w4, y_st)),
        library_note="torch.einsum('nhba,nabl->nhl'), bias add excluded"))

    dw, dys = hm.headmix_bwd(w2d, ys, dz, y_width=B * L, **kw)
    dw_p, dys_p = hm.headmix_bwd_plain(w2d, ys, dz, y_width=B * L, **kw)
    err = max([_close("headmix_bwd[dw]", dw, dw_p)]
              + [_close(f"headmix_bwd[dy{a}]", d, p)
                 for a, (d, p) in enumerate(zip(dys, dys_p))])
    nbytes = 4 * (2 * n * HBA + 2 * A * n * B * L + n * O)
    b_ms, b_by = bound_ms(nbytes, 4.0 * n * H * B * A * L)
    rows.append(dict(
        name="headmix_bwd", route="cuda", source="egc_tpu_torch/csrc/headmix.cu",
        replaces="egc_tpu/ops/pallas/headmix.py:160", max_abs_err=err,
        ms=time_ms(lambda: hm.headmix_bwd(w2d, ys, dz, y_width=B * L, **kw)),
        plain_ms=time_ms(lambda: hm.headmix_bwd_plain(w2d, ys, dz,
                                                      y_width=B * L, **kw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library_note="no single PyTorch call computes dw and dy"))

    # kernels 3+4 through the autograd function vs autograd of the plain
    _check_headmix_autograd(w2d, ys, bias, dz, H, B, A, L, B * L)
    for row in rows:
        log(f"[kernels] {row['name']}: {row['ms']:.4f} ms (plain "
            f"{row['plain_ms']:.4f}, library {row['library_ms']}, bound "
            f"{row['bound_ms']:.4f} by {row['bound_by']}), max abs err "
            f"{row['max_abs_err']:.3e}")
    return rows


def _check_headmix_autograd(w2d, ys, bias, dz, H, B, A, L, yw):
    from egc_tpu_torch.ops.cuda import headmix as hm

    def grads(fn):
        w = w2d.clone().requires_grad_(True)
        y = [t.clone().requires_grad_(True) for t in ys]
        b = bias.clone().requires_grad_(True)
        out = fn(w, y, b)
        out.backward(dz)
        return [out, w.grad, b.grad] + [t.grad for t in y]

    got = grads(lambda w, y, b: hm.head_mix_fused(
        w, y, H=H, B=B, A=A, L=L, y_width=yw, bias=b))
    ref = grads(lambda w, y, b: hm.headmix_fwd_plain(
        w, [t for t in y], b, H=H, B=B, A=A, L=L))
    _close("head_mix_fused", got[0], ref[0])
    for i, (a, b) in enumerate(zip(got[1:], ref[1:])):
        r = rel_l2(a, b)
        check(r <= GRAD_REL_L2, f"head_mix_fused grad {i} rel L2 {r}")


def kernels_small(dev) -> None:
    """Empty receivers, ties (integer values), F = 40 and 37, A = 1."""
    import numpy as np
    import torch
    from egc_tpu_torch.graph.transforms import coalesce_np, symnorm_weight
    from egc_tpu_torch.ops.cuda import gather_reduce as gr
    from egc_tpu_torch.ops.cuda import headmix as hm
    from egc_tpu_torch.ops.dispatch import (
        build_kernel_plan, fused_multi_aggregate,
    )
    from egc_tpu_torch.ops.segment import multi_aggregate

    rng = np.random.default_rng(0)
    n = 1000
    s = rng.integers(0, n, 6000)
    r = rng.integers(0, n - 50, 6000)          # 50 isolated receivers
    s, r, _ = coalesce_np(s, r, n)
    ew, sw = symnorm_weight(torch.as_tensor(s), torch.as_tensor(r), n)
    plan = build_kernel_plan(s, r, n, edge_weight=ew.numpy(), device=dev)
    st, rt = torch.as_tensor(s, device=dev), torch.as_tensor(r, device=dev)
    ew, sw = ew.to(dev), sw.to(dev)
    all_aggrs = ("sum", "mean", "max", "min", "var", "std", "symnorm")
    for f in (40, 37):
        ints = rng.integers(-2, 3, size=(n, f)).astype(np.float32)
        vals = torch.as_tensor(ints, device=dev)
        prims = gr.PRIMS
        for p, o, ref in zip(prims, gr.gather_reduce_fwd(
                vals, plan.rowptr, plan.fwd_senders, plan.fwd_w, prims),
                gr.gather_reduce_fwd_plain(vals, plan.rowptr,
                                           plan.fwd_senders, plan.fwd_w,
                                           prims)):
            _close(f"small fwd[{p}] f={f}", o, ref, exact=p in ("max", "min"))
            check(bool((o[n - 50:] == 0).all()), f"empty rows of {p} not 0")
        coeff = torch.cat([torch.as_tensor(
            rng.normal(size=(n, f)).astype(np.float32), device=dev)
            for _ in gr.SEGS], 1)
        bargs = (coeff, vals, plan.colptr, plan.bwd_receivers, plan.bwd_w,
                 gr.SEGS)
        _close(f"small bwd f={f}", gr.gather_reduce_bwd(*bargs),
               gr.gather_reduce_bwd_plain(*bargs))
        for include_self in (False, True):
            ct = torch.as_tensor(rng.normal(size=(n, len(all_aggrs), f))
                                 .astype(np.float32), device=dev)
            x1 = vals.clone().requires_grad_(True)
            x2 = vals.clone().requires_grad_(True)
            y1 = fused_multi_aggregate(x1, plan, all_aggrs,
                                       include_self=include_self,
                                       symnorm_self_w=sw)
            y2 = multi_aggregate(x2, st, rt, all_aggrs,
                                 include_self=include_self,
                                 symnorm_edge_w=ew, symnorm_self_w=sw)
            _close(f"small fused f={f} self={include_self}", y1, y2)
            (y1 * ct).sum().backward()
            (y2 * ct).sum().backward()
            rr = rel_l2(x1.grad, x2.grad)
            check(rr <= GRAD_REL_L2, f"small fused grad rel L2 {rr}")
    # head mix: A = 1, and an odd shape with y_width > B*L
    for H, B, A, L, yw in ((4, 4, 1, 10, 40), (2, 3, 2, 5, 24)):
        w2d = torch.randn(n, H * B * A, device=dev)
        ys = [torch.randn(n, yw, device=dev) for _ in range(A)]
        bias = torch.randn(H * L, device=dev)
        dz = torch.randn(n, H * L, device=dev)
        _check_headmix_autograd(w2d, ys, bias, dz, H, B, A, L, yw)
        _, dys = hm.headmix_bwd(w2d, ys, dz, H=H, B=B, A=A, L=L, y_width=yw)
        check(all(bool((d[:, B * L:] == 0).all()) for d in dys),
              "head-mix dy tail not zero")
    torch.cuda.synchronize()
    log("[kernels] small-size checks passed (empty rows, ties, F=40/37, "
        "A=1, y_width > B*L)")


# ---------------------------------------------------------------------------
# 4. main path
# ---------------------------------------------------------------------------

def _grad_rels(model, ref_model) -> list:
    """Sorted (relative L2, name) of each parameter gradient of ``model``
    against ``ref_model``'s. A conv bias feeds a BatchNorm, which cancels
    it: its true gradient is 0, so it is checked to be noise-sized and left
    out of the list."""
    ref = dict(ref_model.named_parameters())
    scale = max(float(q.grad.abs().max()) for q in ref.values())
    rels = []
    for name, p in model.named_parameters():
        if name.startswith("convs.") and name.count(".") == 2 \
                and name.endswith(".bias"):
            check(float(p.grad.abs().max()) <= 1e-4 * scale,
                  f"{name}: gradient is not noise-sized")
            continue
        rels.append((rel_l2(p.grad, ref[name].grad), name))
    return sorted(rels, reverse=True)


def phase_main(raw, data) -> dict:
    import torch
    from egc_tpu_torch.exp.fullgraph import (
        full_graph_to_device_dict, train_full_graph,
    )
    from egc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    # one dropout-0 step on the card vs the same step of the port on the
    # CPU; beside it, how far the CPU step itself moves when its inputs
    # carry 1e-7 relative noise (the step's sensitivity to rounding)
    t0 = time.perf_counter()
    d_cpu = full_graph_to_device_dict(raw, "cpu")
    cpu = train_full_graph(raw, steps=1, dropout=0.0, data=d_cpu,
                           device="cpu")
    cpu_s = time.perf_counter() - t0
    g = d_cpu["graph"]
    noise = torch.randn(g.nodes.shape,
                        generator=torch.Generator().manual_seed(1))
    pert = train_full_graph(
        raw, steps=1, dropout=0.0, device="cpu",
        data={**d_cpu, "graph": g.replace(nodes=g.nodes * (1 + 1e-7 * noise))})
    gpu = train_full_graph(raw, steps=1, dropout=0.0, data=data)
    loss_rel = abs(gpu.losses[0] - cpu.losses[0]) / abs(cpu.losses[0])
    check(loss_rel <= STEP_LOSS_RTOL,
          f"step loss {gpu.losses[0]} vs CPU {cpu.losses[0]}")
    rels = _grad_rels(gpu.model, cpu.model)
    for r, name in rels:
        check(r <= STEP_GRAD_REL_L2, f"{name}: grad rel L2 {r} vs CPU")
    noise_rels = _grad_rels(pert.model, cpu.model)
    step_cmp = {"loss_card": gpu.losses[0], "loss_cpu": cpu.losses[0],
                "grad_rel_l2_worst": rels[0], "grad_rel_l2_median":
                statistics.median(r for r, _ in rels),
                "noise_grad_rel_l2_worst": noise_rels[0],
                "noise_grad_rel_l2_median":
                statistics.median(r for r, _ in noise_rels),
                "cpu_step_seconds": cpu_s}
    log(f"[main] card vs CPU step: loss {gpu.losses[0]:.7f} vs "
        f"{cpu.losses[0]:.7f} (rel {loss_rel:.2e}); grad rel L2 worst "
        f"{rels[0]}, median {step_cmp['grad_rel_l2_median']:.2e}; CPU "
        f"step with 1e-7 input noise vs CPU: worst {noise_rels[0]}, median "
        f"{step_cmp['noise_grad_rel_l2_median']:.2e}; CPU step took "
        f"{cpu_s:.1f} s")
    del cpu, gpu, pert

    # the timed main path, counters reset just before and read just after
    steps = STEPS_WARMUP + STEPS_TIMED
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    run = train_full_graph(raw, steps=steps, dropout=0.2, data=data)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name, c in counts.items():
        check(c == 3 * steps, f"{name} launched {c} times in {steps} steps")
    check(all(math.isfinite(x) for x in run.losses), "non-finite loss")
    # the step time is the whole timed window over its steps, so a stall
    # anywhere in the window counts; the median stands beside it
    timed = run.step_seconds[STEPS_WARMUP:]
    step_s = sum(timed) / len(timed)
    res = {"step_seconds_mean": step_s,
           "step_seconds_median": statistics.median(timed),
           "step_seconds": timed,
           "edges_per_s": data["num_edges"] / step_s,
           "num_edges": data["num_edges"], "num_nodes": raw["x"].shape[0],
           "peak_memory_bytes": peak, "launches": counts,
           "losses": run.losses, "step_vs_cpu": step_cmp}
    log(f"[main] {steps} steps: losses {[round(x, 4) for x in run.losses]}")
    med = res["step_seconds_median"]
    log(f"[main] step {step_s * 1e3:.3f} ms (mean over {len(timed)} timed "
        f"steps; median {med * 1e3:.3f}, min {min(timed) * 1e3:.3f}, max "
        f"{max(timed) * 1e3:.3f}), "
        f"{res['edges_per_s'] / 1e6:.3f} M edges/s, peak memory "
        f"{peak / 2**30:.3f} GiB, launches {counts}")
    res["profile"] = _profile(run, data)
    return res


def _profile(run, data) -> str:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from egc_tpu_torch.exp.fullgraph import train_step
    gen = torch.Generator(device=data["device"]).manual_seed(1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            train_step(run.model, run.optimizer, data, gen)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25)
    log("[profile] two steps:\n" + table)
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        import egc_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the egc_tpu_torch package is missing ({exc}); "
              "run from the repository root", file=sys.stderr)
        return 1
    from egc_tpu_torch.data.synthetic import synthetic_full_graph
    from egc_tpu_torch.exp.fullgraph import full_graph_to_device_dict
    from egc_tpu_torch.ops.cuda import launch_counts

    t_start = time.perf_counter()
    info = phase_device()
    results = {"device": info, **phase_build()}
    t0 = time.perf_counter()
    raw = synthetic_full_graph(num_nodes=169_343, avg_degree=14,
                               num_features=128, num_classes=40, seed=0)
    data = full_graph_to_device_dict(raw)
    check(data["num_edges"] == 2_368_458,
          f"synthetic graph has {data['num_edges']} edges")
    log(f"[data] {raw['x'].shape[0]} nodes, {data['num_edges']} edges, "
        f"set-up {time.perf_counter() - t0:.1f} s")
    rows = kernels_main_shapes(data)
    kernels_small(data["device"])
    results["main"] = phase_main(raw, data)
    main_counts = results["main"]["launches"]
    for row in rows:
        row["launches"] = main_counts[row["name"]]
    check(set(main_counts) == {r["name"] for r in rows},
          f"kernel rows {[r['name'] for r in rows]} vs counters "
          f"{sorted(launch_counts())}")
    results["kernels"] = rows
    results["seconds"] = time.perf_counter() - t_start
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1, default=str)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"[done] {results['seconds']:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
