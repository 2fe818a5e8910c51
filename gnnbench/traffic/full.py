"""Full-graph training: one step per call of the configuration's
``train`` hook (the CLI's own; it reads the loss, which synchronises).

Set-up builds the program's data, model and optimizer and runs the
mix's ``setup_steps`` steps through the same hook; the reference follows
them. The window then runs steps until ``--seconds`` have passed, each
timed on the host clock. A traced run profiles ``profile_steps`` more.
"""

from __future__ import annotations

import math

import torch

from gnnbench import port, trace
from gnnbench.harness import Outcome, clock
from gnnbench.reference import graphs
from gnnbench.reference.train import follow
from gnnbench.traffic.common import graph_counts, inputs, program_config


def run(ctx) -> Outcome:
    cfg, mix = ctx.cell.config, ctx.cell.traffic
    raw, w0 = inputs(ctx)
    config = program_config(ctx, raw, w0)
    hp = cfg["hparams"]
    data = config.data(hp)
    model = config.model(hp, seed=ctx.trial_seed)
    state = config.init_state(model, hp, data, ctx.trial_seed)
    rng = config.rng(ctx.trial_seed)
    losses, it = [], 0
    for it in range(mix["setup_steps"]):
        state, m = config.train(model, state, data, rng, it)
        losses.append(m["train_loss"])
        if it == 0:
            grad = {k: v.clone() for k, v in
                    port.first_gradient(state, model).items()}
    change = {k: v - w0[k] for k, v in port.snapshot(model).items()}
    ctx.sync()
    setup_peak = ctx.peak()
    records = {"mode": "full", "setup_s": clock() - ctx.t_start,
               "edges": int(len(raw["senders"]))}

    ctx.reset_peak()
    step_s, failed = [], 0
    t0 = clock()
    while True:
        it += 1
        a = clock()
        state, m = config.train(model, state, data, rng, it)
        b = clock()
        step_s.append(b - a)
        failed += not math.isfinite(m["train_loss"])
        if b - t0 >= ctx.seconds:
            break
    records.update(window_s=clock() - t0, steps=len(step_s), step_s=step_s,
                   peak_bytes=ctx.peak())

    if ctx.trace:
        k = mix["profile_steps"]
        with trace.profiler() as prof:
            ctx.sync()
            a = clock()
            for _ in range(k):
                it += 1
                state, _ = config.train(model, state, data, rng, it)
            ctx.sync()
            window = clock() - a
        records["profile"] = trace.profile_record(prof, k, window)
        records["counts"] = graph_counts(ctx, raw)
    del config, model, state, data, rng

    def reference() -> dict:
        g, y, masks = graphs.full_graph(raw, ctx.device)
        gen = torch.Generator(device=ctx.device).manual_seed(ctx.trial_seed)
        step = (g, y, masks["train"], gen)
        return follow(cfg, w0, [lambda: step] * mix["setup_steps"])

    return Outcome(records=records,
                   program={"losses": losses, "grad": grad,
                            "change": change},
                   attempted=len(step_s), failed=failed,
                   reference=reference, setup_peak=setup_peak)
