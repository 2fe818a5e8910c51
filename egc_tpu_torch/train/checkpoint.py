"""Checkpoint persist / restore (counterpart of ``egc_tpu.train.checkpoint``;
the reference's ``persist_trial`` / ``restore_trial`` contract,
``experiments/exp_config.py:31-53``).

A trial directory holds ``checkpoint.pt``, written with ``torch.save`` in
the reference's trial payload shape: ``model`` (the reference-named state
dict), ``opt`` (the optimizer's ``state_dict``) and ``step``. Beside it,
``checkpoint.json`` holds the JAX package's meta unchanged: ``hparams``,
``plateau`` as a list and ``extra``. The ``torch.save`` is the span
``egc.checkpoint.save`` (``utils.profiling.span``): on the card it holds
the device-to-host copies of the state and the write to disk.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from egc_tpu_torch.train.optim import PlateauState, set_lr
from egc_tpu_torch.train.state import optimizer_step
from egc_tpu_torch.utils.profiling import span


def save_checkpoint(ckpt_dir, *, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    plateau: Optional[PlateauState] = None,
                    hparams: Optional[Dict[str, Any]] = None,
                    extra: Optional[Dict[str, Any]] = None,
                    states: Optional[Tuple[dict, dict]] = None) -> Path:
    """``states``: the (model, optimizer) state dicts to write in place of
    their own ``state_dict()`` (a partitioned net's, gathered to the
    single-device layout)."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / "checkpoint.pt"
    model_sd, opt_sd = states or (model.state_dict(), optimizer.state_dict())
    with span("egc.checkpoint.save"):
        torch.save({"model": model_sd, "opt": opt_sd,
                    "step": optimizer_step(optimizer)}, path)
    meta = {
        "hparams": hparams or {},
        "plateau": list(plateau) if plateau is not None else None,
        "extra": extra or {},
    }
    (ckpt_dir / "checkpoint.json").write_text(json.dumps(meta, default=float))
    return path


def load_checkpoint(ckpt_dir, *, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    load_states: Optional[Callable[[dict, dict], None]]
                    = None
                    ) -> Tuple[int, Optional[PlateauState], Dict[str, Any]]:
    """Load a trial directory into ``model`` (strictly) and ``optimizer``;
    returns ``(step, plateau, hparams)``. The optimizer's learning rate
    follows the restored plateau. ``load_states(model_sd, opt_sd)`` loads
    the two state dicts in place of their own ``load_state_dict`` (a
    partitioned net takes its rows of the gathered ones)."""
    ckpt_dir = Path(ckpt_dir)
    dev = next(model.parameters()).device
    raw = torch.load(ckpt_dir / "checkpoint.pt", map_location=dev,
                     weights_only=True)
    if load_states is None:
        model.load_state_dict(raw["model"], strict=True)
        optimizer.load_state_dict(raw["opt"])
    else:
        load_states(raw["model"], raw["opt"])
    meta = json.loads((ckpt_dir / "checkpoint.json").read_text())
    plateau = None
    if meta.get("plateau") is not None:
        vals = meta["plateau"]
        plateau = PlateauState(lr=vals[0], best=vals[1], num_bad=int(vals[2]),
                               mode=vals[3], factor=vals[4],
                               patience=int(vals[5]), min_lr=vals[6],
                               threshold=vals[7])
        set_lr(optimizer, plateau.lr)
    return int(raw["step"]), plateau, meta.get("hparams", {})
