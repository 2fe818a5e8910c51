"""Whole trials: the program's ``run_trial`` on the configuration's
hooks, as a search runs each trial: train, evaluate, the plateau, and a
checkpoint into a trial directory (under ``TMPDIR``) whenever the
validation accuracy improves. The patience outlasts the window.

The first ``setup_steps`` iterations are set-up; the reference follows
their steps and evaluations. The window opens at the ``report`` callback
of the last of them and closes at the first callback after
``--seconds``; each iteration is timed from one callback to the next. A
traced run records host spans around the hooks in the window, then
profiles ``profile_steps`` more iterations.
"""

from __future__ import annotations

import math
import tempfile
from pathlib import Path

import torch

from gnnbench import port, trace
from gnnbench.harness import Outcome, clock
from gnnbench.reference import common, graphs
from gnnbench.reference.train import follow
from gnnbench.traffic.common import inputs, program_config

ACCS = ("train_acc", "val_acc", "test_acc")


class Spans:
    """Host seconds of each ``train`` call while ``spans`` is a dict."""

    spans = None

    def train(self, *args, **kwargs):
        if self.spans is None:
            return super().train(*args, **kwargs)
        a = clock()
        out = super().train(*args, **kwargs)
        self.spans["train"].append(clock() - a)
        return out


def run(ctx) -> Outcome:
    from egc_tpu_torch.exp.runner import run_trial
    cfg, mix = ctx.cell.config, ctx.cell.traffic
    raw, w0 = inputs(ctx)
    config = program_config(ctx, raw, w0, mixin=Spans)
    setup = mix["setup_steps"]
    st = {"losses": [], "accs": [], "step_s": [], "failed": 0,
          "profiled": 0, "prof": None}

    def report(it, row) -> bool:
        now = clock()
        if it < setup:
            st["losses"].append(row["train_loss"])
            st["accs"].append({k: row[k] for k in ACCS})
            if it == 0:
                st["grad"] = {k: v.clone() for k, v in port.first_gradient(
                    config.state, config.net).items()}
            if it == setup - 1:
                st["change"] = {k: v - w0[k] for k, v in
                                port.snapshot(config.net).items()}
                ctx.sync()
                st["setup_peak"] = ctx.peak()
                st["setup_s"] = now - ctx.t_start
                ctx.reset_peak()
                if ctx.trace:
                    config.spans = {"train": []}
                st["t0"] = st["last"] = clock()
            return False
        if st["prof"] is not None:           # the profiled iterations
            st["profiled"] += 1
            if st["profiled"] < mix["profile_steps"]:
                return False
            ctx.sync()
            st["prof_s"] = clock() - st["prof_t0"]
            st["prof"].stop()
            return True
        st["step_s"].append(now - st["last"])
        st["last"] = now
        st["failed"] += not math.isfinite(row["train_loss"])
        if now - st["t0"] < ctx.seconds:
            return False
        st["window_s"] = now - st["t0"]
        st["peak"] = ctx.peak()
        if not ctx.trace:
            return True
        st["spans"] = {"train": config.spans["train"],
                       "iteration": list(st["step_s"])}
        config.spans = None
        st["prof"] = trace.profiler()
        st["prof"].start()
        ctx.sync()
        st["prof_t0"] = clock()
        return False

    with tempfile.TemporaryDirectory(prefix="gnnbench_trial_") as tmp:
        run_trial(config, dict(cfg["hparams"]), seed=ctx.trial_seed,
                  max_iterations=10 ** 9, patience=10 ** 9,
                  trial_dir=Path(tmp) / "trial", report=report,
                  verbose=False)
    records = {"mode": "trial", "setup_s": st["setup_s"],
               "edges": int(len(raw["senders"])),
               "window_s": st["window_s"], "steps": len(st["step_s"]),
               "step_s": st["step_s"], "peak_bytes": st["peak"]}
    if st["prof"] is not None:
        records["profile"] = trace.profile_record(
            st["prof"], mix["profile_steps"], st["prof_s"])
        records["spans"] = st["spans"]
    del config

    def reference() -> dict:
        g, y, masks = graphs.full_graph(raw, ctx.device)
        gen = torch.Generator(device=ctx.device).manual_seed(ctx.trial_seed)
        step = (g, y, masks["train"], gen)
        return follow(cfg, w0, [lambda: step] * setup,
                      evaluate=lambda fwd: common.accuracies(fwd(g), y,
                                                             masks))

    return Outcome(records=records,
                   program={"losses": st["losses"], "grad": st["grad"],
                            "change": st["change"], "accs": st["accs"]},
                   attempted=len(st["step_s"]), failed=st["failed"],
                   reference=reference, setup_peak=st["setup_peak"])
