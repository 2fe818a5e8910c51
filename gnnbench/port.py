"""How the benchmark hands its inputs to the program: a subclass of the
program's experiment configuration that loads the benchmark's graph
(``load_full_graph``), puts the benchmark's weights into the model the
configuration builds (``model``), and keeps the optimizer it makes
(``init_state``) so that the benchmark can read its state. Every other
hook is the program's own."""

from __future__ import annotations

import importlib
from typing import Dict

import torch

from gnnbench.weights import load_into


def model_adapter(cfg: dict):
    """The port side of the configuration's model, ``models/<model>.py``."""
    return importlib.import_module(f"gnnbench.models.{cfg['model']}")


def bench_config(cfg: dict, traffic: dict, raw: dict,
                 weights: Dict[str, torch.Tensor], device, *,
                 mixin: type = None):
    """The program's configuration of ``cfg`` for the traffic's mode, on
    ``device``, fed ``raw`` and ``weights``. ``mixin`` (a class whose
    methods call ``super()``) goes in front, for hooks a traffic mode wraps."""
    adapter = model_adapter(cfg)
    base = adapter.config_class(traffic["mode"])
    args, kwargs = adapter.config_args(cfg, traffic)

    bases = (base,) if mixin is None else (mixin, base)

    class BenchConfig(*bases):
        num_layers = cfg["net"]["num_layers"]
        net = state = None

        def load_full_graph(self):
            return raw

        def model(self, hparams, *, seed: int = 0):
            self.net = super().model(hparams, seed=seed)
            load_into(self.net, weights)
            return self.net

        def init_state(self, model, hparams, data, seed: int):
            self.state = super().init_state(model, hparams, data, seed)
            return self.state

    return BenchConfig(*args, device=device, **kwargs)


def first_gradient(optimizer: torch.optim.Optimizer,
                   model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient as Adam took it at its first step (the L2
    term added), from its state: the first moment over (1 - beta1); zero
    where the step left no state."""
    b1 = optimizer.param_groups[0]["betas"][0]
    out = {}
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        out[name] = st["exp_avg"].detach() / (1.0 - b1) \
            if "exp_avg" in st else torch.zeros_like(p)
    return out


def snapshot(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in model.named_parameters()}
