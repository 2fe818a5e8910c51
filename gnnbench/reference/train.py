"""The reference's side of a training comparison: it follows the
program's first steps from the same weights, graph and random streams,
and reads what the comparison needs.

For each step: the loss; after the first, each parameter's gradient of
the loss and the gradient as Adam took it (L2 added); after the last,
each parameter's change from the start; optionally, after each step, the
eval-mode accuracies of the splits.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Optional, Tuple

import torch

from gnnbench.reference import common

# one training step's inputs: graph, labels, loss mask, dropout stream
Step = Tuple[common.RefGraph, torch.Tensor, torch.Tensor,
             Optional[torch.Generator]]


def model_module(cfg: dict):
    """The reference file of the configuration's model."""
    return importlib.import_module(f"gnnbench.reference.{cfg['model']}")


def follow(cfg: dict, weights: Dict[str, torch.Tensor],
           steps: List[Callable[[], Step]],
           evaluate: Optional[Callable[[Callable], Dict[str, float]]] = None
           ) -> dict:
    """Train the reference from ``weights`` through ``steps`` (each a
    callable that makes its step's inputs, so one graph lives at a time);
    ``evaluate(forward)`` after each step gives that step's accuracies.
    The reference computes in the default dtype (float32 unless a
    calibration asks for float64)."""
    mod = model_module(cfg)
    hp = cfg["hparams"]
    dev = next(iter(weights.values())).device
    with common.plain_precision():
        dtype = torch.get_default_dtype()
        P = {k: v.detach().to(dtype).clone().requires_grad_(True)
             for k, v in weights.items()}
        running = mod.init_running(cfg, dev)
        opt = common.Adam(P, hp["lr"], hp["wd"])
        out = {"losses": [], "accs": []}
        for k, make in enumerate(steps):
            g, y, mask, gen = make()
            logp = mod.forward(P, g, cfg, running, True, gen)
            loss = common.masked_nll(logp, y, mask)
            grads = torch.autograd.grad(loss, list(P.values()))
            grads = dict(zip(P, grads))
            out["losses"].append(float(loss.detach()))
            del logp, loss, g
            taken = opt.step(P, grads)
            if k == 0:
                out["grad"] = {n: t.detach().clone() for n, t in grads.items()}
                out["grad_taken"] = {n: t.clone() for n, t in taken.items()}
            del grads, taken
            if evaluate is not None:
                with torch.no_grad():
                    out["accs"].append(evaluate(
                        lambda g: mod.forward(P, g, cfg, running, False,
                                              None)))
        out["change"] = {n: P[n].detach() - weights[n].to(dtype)
                         for n in P}
    return out
