"""Run one cell of the benchmark once and print its result line.

    python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (``egc_tpu_torch``)
beside this folder, on a machine with the cards the cell asks for. The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, in a traced run
``breakdown``, and last ``checks``, each number that decides ``correct``
beside its limit (also the last lines of standard error). Without the
cards, or where the process has loaded JAX or the JAX package, it exits
non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "egc_tpu")


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def loaded_forbidden() -> list:
    """Modules of JAX or of the JAX package in this process, compared by
    their whole top-level name (``egc_tpu_torch`` is not ``egc_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _number(x):
    """A finite number as it is; anything else as null (JSON has no NaN)."""
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch
    from gnnbench.cell import load_cell
    from gnnbench.harness import run_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"gnnbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); {have} available", file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   "cuda", t_start=T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"gnnbench: the run loaded {bad}", file=sys.stderr)
        return 3
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"],
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in res["metrics"].items()},
            "device": {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(0),
                       "count": cell.chips,
                       "memory_peak_bytes": res["memory_peak_bytes"],
                       "power_limit": _power_limit()}}
    if args.trace:
        line["device"].update(busy_s=res["busy_s"], window_s=res["window_s"])
        line["breakdown"] = res["breakdown"]
    line["checks"] = {k: {"value": _number(c["value"]),
                          "limit": _number(c["limit"])}
                      for k, c in res["checks"].items()}
    for fault in res["batch_faults"]:
        print(f"gnnbench: {fault}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
