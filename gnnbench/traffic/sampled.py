"""Neighbour-sampled training, as the program's ``SampledMagConfig.train``
composes it: the configuration's ``batches`` (the mix's sampler, fanouts
and batch size; the host sampler on its prefetch threads) and one
``sampled_step`` a batch, epoch after epoch, the epoch's losses read
once at its end; one synchronise closes the window.

Set-up builds the program's data (the eval graph with its plan, the
loader) and runs the first ``setup_steps`` batches of epoch 0 through the
same two calls; those batches are judged against the graph and the
reference follows their steps. The window goes on from the next batch.
A traced run profiles ``profile_steps`` more steps.
"""

from __future__ import annotations

import torch

from gnnbench import port, trace
from gnnbench.harness import Outcome, clock
from gnnbench.reference import graphs
from gnnbench.reference.common import fold_seed
from gnnbench.reference.train import follow
from gnnbench.traffic.common import inputs, program_config

BATCH_FIELDS = ("senders", "receivers", "edge_mask", "node_mask")


def _host_batch(g, y, seed_mask, gids) -> dict:
    out = {k: getattr(g, k).cpu().numpy() for k in BATCH_FIELDS}
    out.update(y=y.cpu().numpy(), seed_mask=seed_mask.cpu().numpy(),
               gids=gids.cpu().numpy())
    return out


def run(ctx) -> Outcome:
    cfg, mix = ctx.cell.config, ctx.cell.traffic
    raw, w0 = inputs(ctx)
    config = program_config(ctx, raw, w0)
    hp = cfg["hparams"]
    data = config.data(hp)
    model = config.model(hp, seed=ctx.trial_seed)
    state = config.init_state(model, hp, data, ctx.trial_seed)
    rng = config.rng(ctx.trial_seed)
    x_full = data["x_full"]
    n_train, bs = len(raw["train_idx"]), mix["batch_size"]

    def seeds(i: int) -> int:
        return min(bs, n_train - i * bs)

    epoch, i = 0, 0
    batches = config.batches(data, rng, epoch)
    losses, kept = [], []
    for i in range(mix["setup_steps"]):
        gen, g, y, seed_mask, gids = next(batches)
        kept.append(_host_batch(g, y, seed_mask, gids))
        loss = config.sampled_step(model, state, x_full, g, y, seed_mask,
                                   gids, generator=gen)
        losses.append(float(loss))
        if i == 0:
            grad = {k: v.clone() for k, v in
                    port.first_gradient(state, model).items()}
    change = {k: v - w0[k] for k, v in port.snapshot(model).items()}
    ctx.sync()
    setup_peak = ctx.peak()
    records = {"mode": "sampled", "setup_s": clock() - ctx.t_start}

    def step():
        """The next batch and its step (a new epoch where one ends);
        returns the seconds spent waiting in ``next``."""
        nonlocal batches, epoch, i, epoch_losses
        a = clock()
        try:
            item = next(batches)
            i += 1
        except StopIteration:
            means.append(float(torch.stack(epoch_losses).mean()))
            epoch_losses = []
            epoch, i = epoch + 1, 0
            batches = config.batches(data, rng, epoch)
            item = next(batches)
        wait = clock() - a
        gen, g, y, seed_mask, gids = item
        loss = config.sampled_step(model, state, x_full, g, y, seed_mask,
                                   gids, generator=gen)
        epoch_losses.append(loss)
        window_losses.append(loss)
        return wait, seeds(i)

    ctx.reset_peak()
    means, epoch_losses, window_losses = [], [], []
    steps = done_seeds = 0
    wait_s = 0.0
    t0 = clock()
    while True:
        w, s = step()
        wait_s += w
        done_seeds += s
        steps += 1
        if clock() - t0 >= ctx.seconds:
            break
    ctx.sync()
    window_s = clock() - t0
    failed = int((~torch.stack(window_losses).isfinite()).sum())
    records.update(window_s=window_s, steps=steps, seeds=done_seeds,
                   step_s=[], peak_bytes=ctx.peak(), loader_wait_s=wait_s)
    if ctx.trace:
        k = mix["profile_steps"]
        with trace.profiler() as prof:
            ctx.sync()
            a = clock()
            for _ in range(k):
                step()
            ctx.sync()
            window = clock() - a
        records["profile"] = trace.profile_record(prof, k, window)
    batches.close()            # joins the epoch's prefetch threads
    del config, model, state, data, rng, x_full, batches

    def reference() -> dict:
        faults = []
        for k, b in enumerate(kept):
            faults += [f"batch {k}: {f}" for f in graphs.judge_batch(
                raw, b, fanouts=mix["fanouts"], batch_size=bs,
                seeds_expected=seeds(k))]
        epoch0 = fold_seed(ctx.trial_seed, 0)

        def make(k):
            def inputs_k():
                g, y, mask = graphs.sampled_batch(raw, kept[k], ctx.device)
                gen = torch.Generator(device=ctx.device).manual_seed(
                    fold_seed(epoch0, k))
                return g, y, mask, gen
            return inputs_k

        out = follow(cfg, w0, [make(k) for k in range(len(kept))])
        out["batch_faults"] = faults
        return out

    return Outcome(records=records,
                   program={"losses": losses, "grad": grad,
                            "change": change},
                   attempted=steps, failed=failed, reference=reference,
                   setup_peak=setup_peak)
