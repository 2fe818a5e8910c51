"""Operations and compulsory bytes of one EGC layer's training step
(forward and backward) over ``n`` rows and ``e`` edges.

- Matmuls: the bases and the head-mix weights are one product of x [n,
  fin] with fin x (B*L + H*B*A) columns, 2*n*fin*cols operations forward;
  backward the weights' gradient, and x's where x needs one.
- Aggregation, per edge and feature (F = B*L), forward and again
  backward: symnorm a multiply and an add, mean an add, max a compare;
  a self-loop adds n*F of each.
- Head mix: B*A multiply-adds per output, 2*n*H*L*B*A forward, twice
  that backward (the weights' and the aggregates' gradients).
- Aggregation bytes: forward the values [n, F], the receiver-sorted
  structure (n + 1 offsets, e senders, e weights for symnorm) and A
  outputs [n, F]; backward the A cotangents, the sender-sorted structure
  and the values' gradient [n, F]. 4 bytes each.
- Head-mix bytes: forward the weights [n, H*B*A], the A aggregates [n,
  F], the bias and the output [n, H*L]; backward the weights, the
  aggregates and the output's gradient read, the weights' and the
  aggregates' gradients written.
"""

from __future__ import annotations

from typing import Dict, Sequence

WORD = 4
EDGE_OPS = {"symnorm": 2, "mean": 1, "sum": 1, "max": 1, "min": 1}


def linear_flops(n: int, fin: int, fout: int, needs_dx: bool) -> float:
    """A dense layer's forward and backward operations."""
    f = 2.0 * n * fin * fout
    return f * (3 if needs_dx else 2)


def egc_layer(n: int, e: int, fin: int, fout: int, heads: int, bases: int,
              aggrs: Sequence[str], self_loops: bool,
              needs_dx: bool) -> Dict[str, float]:
    H, B, A = heads, bases, len(aggrs)
    L = fout // H
    F = B * L
    mm = linear_flops(n, fin, F + H * B * A, needs_dx)
    per_edge = sum(EDGE_OPS[a] for a in aggrs)
    agg = 2.0 * per_edge * (e + (n if self_loops else 0)) * F
    mix = 6.0 * n * H * L * B * A
    w = 1 if "symnorm" in aggrs else 0
    structure = (n + 1) + (1 + w) * e
    gr = WORD * ((n * F + structure + A * n * F)
                 + (A * n * F + structure + n * F))
    hm = WORD * ((n * H * B * A + A * n * F + H * L + n * H * L)
                 + (2 * n * H * B * A + 2 * A * n * F + n * H * L))
    return {"flops": mm + agg + mix, "gather_reduce_bytes": float(gr),
            "headmix_bytes": float(hm)}


def add(*parts: Dict[str, float]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for p in parts:
        for k, v in p.items():
            out[k] = out.get(k, 0.0) + v
    return out
