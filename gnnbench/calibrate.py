"""The readings the limits of a cell are set from, in one process:

    python3 gnnbench/calibrate.py --workload <cell> --seeds N [N ...] \
        [--faults none control frozen half_batch altered] [--f64] \
        [--out FILE]

For each seed, the cell runs once as the program stands (``none``) and
once with each planted fault or the control (``faults.py``), each with a
window of one step, and the numbers that decide ``correct`` are printed.
``--f64`` also runs the reference in float64 and gives each side's gap
to it (which side rounding moved). The summary gives, for each number,
the largest sound reading (the lower one) and the smallest reading of
the control and of each fault.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _details(prog: dict, ref: dict, top: int = 4) -> dict:
    """Each step's loss on both sides, and the leaves with the widest
    gradient and change gaps."""
    from gnnbench.harness import _norms
    out = {"losses": [prog["losses"], ref["losses"]]}
    for key, rkey in (("grad", "grad_taken"), ("change", "change")):
        pn, rn = _norms(prog[key]), _norms(ref[rkey])
        gaps = sorted(((abs(pn[k] - rn[k]) / max(rn[k], 1e-30), k, rn[k])
                       for k in rn), reverse=True)
        out[key] = gaps[:top]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="+", default=["none", "control"])
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from gnnbench import graph
    from gnnbench.cell import load_cell
    from gnnbench.harness import run_cell, training_numbers

    make, made = graph.synthetic_full_graph, {}

    def one_graph_a_seed(**kw):
        """The seed's graph, made once for all its variants."""
        if kw["seed"] not in made:
            made.clear()
            made[kw["seed"]] = make(**kw)
        return made[kw["seed"]]

    graph.synthetic_full_graph = one_graph_a_seed
    cell = load_cell(args.workload)
    rows = []
    for seed in args.seeds:
        for fault in args.faults:
            t0 = time.perf_counter()
            res = run_cell(cell, seed, 0.0, False, args.device,
                           fault=None if fault == "none" else fault,
                           keep=True)
            row = {"seed": seed, "fault": fault,
                   "numbers": res["numbers"],
                   "details": _details(res["program"], res["reference"]),
                   "seconds": time.perf_counter() - t0}
            if args.f64:
                torch.set_default_dtype(torch.float64)
                try:
                    ref64 = res["rerun_reference"]()
                finally:
                    torch.set_default_dtype(torch.float32)
                row["program_vs_f64"] = training_numbers(res["program"],
                                                         ref64)
                ref = res["reference"]
                row["reference_vs_f64"] = training_numbers(
                    {"losses": ref["losses"], "grad": ref["grad_taken"],
                     "change": ref["change"], "accs": ref["accs"]}, ref64)
            rows.append(row)
            print(json.dumps(row), flush=True)
            del res
    summary = {}
    for fault in args.faults:
        got = [r["numbers"] for r in rows if r["fault"] == fault]
        pick = max if fault == "none" else min
        summary[fault] = {k: pick(g[k] for g in got) for k in got[0]}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps({"rows": rows,
                                              "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
