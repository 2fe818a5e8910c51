"""Parameter initialisers matching the reference's PyTorch defaults
(counterpart of ``egc_tpu.nn.init``), drawn from a CPU ``torch.Generator``
(``None``: the global one).

- ``torch.nn.Linear``: weight and bias U(+-1/sqrt(fan_in)) (kaiming_uniform
  with a=sqrt(5) reduces to this bound).
- PyG ``glorot`` per basis (reference ``experiments/layers.py:82-87``):
  U(+-sqrt(6/(fan_in + L))) for each [fan_in, L] basis matrix.
- PyG ``glorot`` (``glorot_uniform_``): U(+-sqrt(6/(a + b))) over the last
  two axes (a, b) of the tensor (the GAT projection and attention vectors,
  the atom embeddings).
- ``torch.nn.Embedding`` (``normal_embedding_``): N(0, 1).
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    """Fill ``t`` with U(-bound, bound). The draw happens on the CPU
    generator and is copied, so the values do not depend on the device."""
    vals = torch.rand(t.shape, generator=generator, dtype=torch.float32)
    t.copy_((vals * 2.0 - 1.0) * bound)
    return t


def torch_linear_(linear: torch.nn.Linear, generator: torch.Generator):
    bound = 1.0 / math.sqrt(linear.in_features)
    uniform_(linear.weight, bound, generator)
    if linear.bias is not None:
        uniform_(linear.bias, bound, generator)


def glorot_per_base_(weights, fan_in: int, generator: torch.Generator):
    """Glorot on each [fan_in, L] basis matrix of ``weights``."""
    for w in weights:
        uniform_(w, math.sqrt(6.0 / (fan_in + w.shape[1])), generator)


def glorot_uniform_(t: torch.Tensor, generator: torch.Generator):
    """Glorot over the last two axes of ``t`` (``egc_tpu`` ``glorot_uniform``;
    the bound is symmetric in the two, so a transposed weight gets the
    same one)."""
    return uniform_(t, math.sqrt(6.0 / (t.shape[-2] + t.shape[-1])),
                    generator)


@torch.no_grad()
def normal_embedding_(t: torch.Tensor, generator: torch.Generator):
    """Fill ``t`` with N(0, 1) (``torch.nn.Embedding``'s default), drawn on
    the CPU generator and copied, as ``uniform_`` is."""
    t.copy_(torch.randn(t.shape, generator=generator, dtype=torch.float32))
    return t
