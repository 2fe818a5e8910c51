"""The initial weights, made by the benchmark from the seed on the
device, in one draw: a uniform vector over every parameter, each slice
scaled to its parameter's ``(centre, half-width)``. The same tensors go
to the program (copied into its model by name) and to the reference."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def make_weights(specs: List[Tuple[str, Tuple[int, ...], float, float]],
                 seed: int, device) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape, centre, half in specs:
        k = math.prod(shape)
        out[name] = flat[at:at + k].view(shape) * half + centre
        at += k
    return out


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]):
    """Copy ``weights`` into ``model``'s parameters; every parameter must
    be named there, at its shape."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the program's parameters {sorted(params)} are "
                         f"not the configuration's {sorted(weights)}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: {tuple(p.shape)} in the program, "
                                 f"{tuple(weights[name].shape)} here")
            p.copy_(weights[name])
