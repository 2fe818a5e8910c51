"""Time the EGC-M arxiv-shaped training step of several source trees in
turns on one card.

    python3 egc_tpu_torch/exp/step_ab.py TREE [TREE ...] [--rounds 1] \\
        [--out results.json]

Each TREE is the root of a checkout (for example a ``git archive`` of
another commit, unpacked); its ``egc_tpu_torch`` is imported, and its
kernels built, in a process of its own, started from the tree's root. The
turns run the trees in order and then in reverse (``--rounds`` such
passes), so a tree list ``parent change`` runs parent, change, change,
parent. A turn builds the synthetic arxiv-shaped graph (169,343 nodes,
2,368,458 edges), trains 2 warm-up and 10 timed dropout-0.2 steps of EGC-M
h128 H4 B4 through ``train_full_graph`` (the step: the timed window over
its steps; the median beside it), then profiles two more steps with
``torch.profiler``: the card's busy time per step (every kernel and copy)
and, per step, the device time of each gather-reduce kernel and of
``aten::cat``; beside them the peak device memory of the timed steps.
Prints one JSON line per turn, then the medians of each tree and the
card's ``nvidia-smi`` name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

STEPS_WARMUP, STEPS_TIMED = 2, 10


def one_turn(tree: str) -> dict:
    """The measurements of one turn, in this process, on ``tree``'s
    package."""
    sys.path[0] = tree
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import egc_tpu_torch
    from egc_tpu_torch.data.synthetic import synthetic_full_graph
    from egc_tpu_torch.exp.fullgraph import (
        full_graph_to_device_dict, train_full_graph, train_step,
    )
    pkg = Path(egc_tpu_torch.__file__).resolve().parent
    if pkg.parent != Path(tree).resolve():
        raise RuntimeError(f"imported {pkg}, not the package of {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    raw = synthetic_full_graph(num_nodes=169_343, avg_degree=14,
                               num_features=128, num_classes=40, seed=0)
    data = full_graph_to_device_dict(raw)
    torch.cuda.reset_peak_memory_stats()
    run = train_full_graph(raw, steps=STEPS_WARMUP + STEPS_TIMED,
                           dropout=0.2, data=data)
    peak = torch.cuda.max_memory_allocated() / 2**30
    timed = run.step_seconds[STEPS_WARMUP:]
    gen = torch.Generator(device=data["device"]).manual_seed(1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            train_step(run.model, run.optimizer, data, gen)
        torch.cuda.synchronize()
    busy, by_name = 0.0, {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA \
                or getattr(evt, "is_user_annotation", False):
            continue
        t = (getattr(evt, "self_device_time_total", None)
             or getattr(evt, "self_cuda_time_total", 0.0)) / 1e3 / 2
        busy += t
        for name in ("gather_reduce_fwd", "gather_reduce_bwd"):
            if name in evt.key:
                by_name[name] = by_name.get(name, 0.0) + t
    cat = sum(((getattr(evt, "device_time_total", None)
                or getattr(evt, "cuda_time_total", 0.0)) / 1e3 / 2)
              for evt in prof.key_averages() if evt.key == "aten::cat")
    return {"tree": tree, "step_ms": sum(timed) / len(timed) * 1e3,
            "step_ms_median": statistics.median(timed) * 1e3,
            "device_busy_ms": busy, "kernel_ms": by_name, "cat_ms": cat,
            "peak_gib": peak, "losses": run.losses}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one_turn(args.trees[0])), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    trees = [str(Path(t).resolve()) for t in args.trees]
    turns = []
    for tree in (trees + trees[::-1]) * args.rounds:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one", tree],
            cwd=tree, capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": ""})
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps({k: v for k, v in turns[-1].items()
                          if k != "losses"}), flush=True)
    summary = {t: {k: statistics.median(x[k] for x in turns
                                        if x["tree"] == t)
                   for k in ("step_ms", "step_ms_median", "device_busy_ms",
                             "cat_ms", "peak_gib")} for t in trees}
    print(json.dumps({"summary_median": summary, "card": smi}))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"turns": turns, "summary": summary, "card": smi}, fh,
                      indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
