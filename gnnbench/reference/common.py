"""Plain PyTorch pieces of the reference: the graph it aggregates on,
the EGC layer, the masked BatchNorm, dropout, the masked NLL and Adam.

Written from the published layer equations and the configurations, not
from the program: it imports nothing of the program and takes nothing
the program derived (no kernel plan, no symnorm weights, no padding).
Everything runs in float32 with TF32 off (``plain_precision``), on
whatever device its inputs are on.

    EGC: x'_i = ||_h sum_{a, b} w[i, h, b, a] * AGG_a_{j in N(i)} (x_j Theta_b)
         + bias,  w = x W_comb^T + b_comb

Aggregators: ``symnorm`` is GCN's symmetric normalisation with one self
loop (deg counts the in-edges plus one); ``mean`` and ``max`` run over the
in-edges (an empty row gives 0), or over the in-edges and the node itself
where the layer gives every aggregator a self-loop (MagNet's layer).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


@contextlib.contextmanager
def plain_precision():
    """float32 matmuls without TF32 for the block; the flags are restored
    after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class RefGraph:
    """A graph over ``rows`` rows: the valid edges only (long tensors),
    the in-degree, symnorm's edge and self weights, the valid-row mask
    and the features."""

    x: torch.Tensor
    senders: torch.Tensor
    receivers: torch.Tensor
    node_mask: torch.Tensor
    deg: torch.Tensor
    sym_edge: torch.Tensor
    sym_self: torch.Tensor

    @property
    def rows(self) -> int:
        return self.x.shape[0]


def ref_graph(x: torch.Tensor, senders, receivers, node_mask: torch.Tensor,
              sym_rows: Optional[int] = None) -> RefGraph:
    """``x`` over all rows; ``senders`` / ``receivers`` the valid edges.
    Symnorm's degrees count the in-edges (self-loop edges left out) plus
    one for the self-loop, over the first ``sym_rows`` rows (all rows by
    default); rows past them get no self weight."""
    dev = x.device
    s = torch.as_tensor(np.asarray(senders), dtype=torch.long).to(dev) \
        if not isinstance(senders, torch.Tensor) else senders.long().to(dev)
    r = torch.as_tensor(np.asarray(receivers), dtype=torch.long).to(dev) \
        if not isinstance(receivers, torch.Tensor) \
        else receivers.long().to(dev)
    rows = x.shape[0]
    ones = torch.ones(s.shape[0], device=dev)
    deg = torch.zeros(rows, device=dev).index_add_(0, r, ones)
    loop = (s == r).float()
    d_sym = torch.zeros(rows, device=dev).index_add_(0, r, ones - loop) + 1.0
    inv = d_sym.rsqrt()
    sym_edge = inv[s] * inv[r] * (1.0 - loop)
    sym_self = inv * inv
    if sym_rows is not None:
        sym_self[sym_rows:] = 0.0
    return RefGraph(x=x, senders=s, receivers=r, node_mask=node_mask,
                    deg=deg, sym_edge=sym_edge, sym_self=sym_self)


def aggregate(v: torch.Tensor, g: RefGraph, aggr: str,
              self_loops: bool) -> torch.Tensor:
    """One aggregator of ``v [rows, F]`` over ``g``'s in-edges."""
    s, r = g.senders, g.receivers
    vs = v[s]
    zeros = torch.zeros_like(v)
    if aggr == "symnorm":
        return zeros.index_add(0, r, vs * g.sym_edge[:, None]) \
            + g.sym_self[:, None] * v
    if aggr == "mean":
        total = zeros.index_add(0, r, vs)
        if self_loops:
            return (total + v) / (g.deg[:, None] + 1.0)
        return total / g.deg.clamp(min=1.0)[:, None]
    if aggr == "max":
        m = zeros.scatter_reduce(0, r[:, None].expand_as(vs), vs, "amax",
                                 include_self=False)
        has = (g.deg > 0)[:, None]
        if self_loops:
            return torch.maximum(torch.where(has, m, v), v)
        return torch.where(has, m, zeros)
    raise ValueError(f"the reference has no aggregator {aggr!r}")


def egc_layer(x: torch.Tensor, P: Dict[str, torch.Tensor], pre: str,
              g: RefGraph, *, heads: int, bases: int,
              aggrs: Sequence[str], optimized: bool) -> torch.Tensor:
    """One EGC layer. The original layer's parameters are ``B`` basis
    matrices ``bases_weight.{b}`` [in, L] and ``comb_weights`` (rows in
    (h, b, a) order); the optimized layer's one ``bases_weight`` [in, B*L]
    and ``comb_weight`` (rows in (h, a, b) order), with a self-loop for
    every aggregator."""
    H, B, A = heads, bases, len(aggrs)
    n = x.shape[0]
    if optimized:
        wb = P[pre + "bases_weight"]
        w = x @ P[pre + "comb_weight.weight"].t() \
            + P[pre + "comb_weight.bias"]
        w = w.reshape(n, H, A, B).permute(0, 1, 3, 2)
    else:
        wb = torch.cat([P[f"{pre}bases_weight.{b}"] for b in range(B)], 1)
        w = x @ P[pre + "comb_weights.weight"].t() \
            + P[pre + "comb_weights.bias"]
        w = w.reshape(n, H, B, A)
    L = wb.shape[1] // B
    basis = x @ wb
    ys = torch.stack([aggregate(basis, g, a, optimized) for a in aggrs], 1)
    z = torch.einsum("nhba,nabl->nhl", w, ys.reshape(n, A, B, L))
    return z.reshape(n, H * L) + P[pre + "bias"]


def batch_norm(x: torch.Tensor, P: Dict[str, torch.Tensor], pre: str,
               running: Dict[str, torch.Tensor], mask: torch.Tensor,
               training: bool) -> torch.Tensor:
    """BatchNorm over the valid rows: the biased variance normalises, the
    unbiased one enters the running variance (momentum 0.1, eps 1e-5)."""
    if training:
        m = mask.float()[:, None]
        cnt = m.sum().clamp(min=1.0)
        mean = (x * m).sum(0) / cnt
        var = ((x * x * m).sum(0) / cnt - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
            running[pre + "mean"] = (1 - BN_MOMENTUM) \
                * running[pre + "mean"] + BN_MOMENTUM * mean
            running[pre + "var"] = (1 - BN_MOMENTUM) \
                * running[pre + "var"] + BN_MOMENTUM * unbiased
    else:
        mean, var = running[pre + "mean"], running[pre + "var"]
    return (x - mean) / torch.sqrt(var + BN_EPS) * P[pre + "weight"] \
        + P[pre + "bias"]


def dropout(x: torch.Tensor, p: float, gen: Optional[torch.Generator]
            ) -> torch.Tensor:
    """Inverted dropout; the keep mask is ``rand >= p`` drawn from
    ``gen`` at ``x``'s shape, the stream the benchmark hands to both
    sides."""
    if gen is None or p <= 0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device,
                      dtype=torch.float32) >= p
    return x * keep / (1.0 - p)


def masked_nll(logp: torch.Tensor, y: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()
    picked = logp.gather(1, y.long()[:, None])[:, 0]
    return -(picked * m).sum() / m.sum().clamp(min=1.0)


def fold_seed(seed: int, data: int) -> int:
    """A generator seed derived from ``seed`` and ``data``: the rule by
    which a trial's generator is split per epoch and per batch
    (``SeedSequence([seed, data])``, its first 64-bit word halved)."""
    word = np.random.SeedSequence([int(seed), int(data)]).generate_state(
        1, np.uint64)
    return int(word[0]) >> 1


class Adam:
    """Adam with an L2 penalty added to the gradient before the moments
    (not decoupled), bias-corrected, as the configurations state."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 wd: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, wd, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Updates ``params`` in place; returns the gradients as the
        moments took them (L2 added)."""
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = 1 - self.b2 ** self.t
        taken = {}
        for k, p in params.items():
            g = grads[k] + self.wd * p if self.wd else grads[k]
            taken[k] = g
            self.m[k].lerp_(g, 1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / bc2 ** 0.5 + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)
        return taken


def accuracies(logp: torch.Tensor, y: torch.Tensor,
               masks: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The argmax accuracy of each split's rows."""
    hit = logp.argmax(dim=-1) == y
    return {f"{s}_acc": float((hit & m).sum()) / max(float(m.sum()), 1.0)
            for s, m in masks.items()}
