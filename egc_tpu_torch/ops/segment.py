"""Segment (neighbourhood) reductions in plain PyTorch (counterpart of
``egc_tpu.ops.segment``). This is the path every CPU tensor takes.

Semantics are ``egc_tpu``'s (and the reference's torch_scatter ones):

- an empty segment gives 0 for every reduction, max and min included;
- ``min(x) = -max(-x)``;
- ``var = E[x^2] - E[x]^2``, ``std = sqrt(relu(var) + 1e-5)``;
- ``symnorm`` is a weighted sum with GCN symmetric-norm weights;
- self-loops are virtual (``include_self`` folds x_i in analytically);
- the max/min backward gives the FULL cotangent to every edge that attains
  the extremum. ``scatter_reduce("amax")``'s own backward splits it among
  ties, so the max runs through ``_SegmentMax`` below.

Masked edges are routed to an extra segment row that is sliced away, the
counterpart of XLA dropping out-of-range segment ids.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

AGGREGATORS = ("sum", "mean", "max", "min", "var", "std", "symnorm")
_ALIASES = {"add": "sum", "symadd": "symnorm"}


def canonical_aggr(name: str) -> str:
    name = _ALIASES.get(name, name)
    if name not in AGGREGATORS:
        raise ValueError(
            f"unknown aggregator {name!r}; supported: {AGGREGATORS}")
    return name


def _var_from_moments(msq: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``E[x^2] - E[x]^2``. Eager PyTorch materialises it once, so every
    consumer (sqrt, the relu gate and its backward) sees the same bits —
    what the JAX version needs an optimisation barrier for."""
    return msq - m * m


def _masked_ids(segment_ids: torch.Tensor, num_segments: int,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    ids = segment_ids.long()
    if mask is None:
        return ids
    return torch.where(mask, ids, torch.full_like(ids, num_segments))


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (ndim - 1))


def _segment_sum_ids(data, ids, num_segments):
    """Sum over ids in [0, num_segments]; id ``num_segments`` is dropped."""
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    return out.index_add(0, ids, data)[:num_segments]


class _SegmentMax(torch.autograd.Function):
    """Segment max with the tie-routing backward: every edge equal to its
    segment's max gets the full cotangent. Empty segments give 0; the id
    ``num_segments`` marks a dropped (masked) edge."""

    @staticmethod
    def forward(ctx, data, ids, num_segments):
        flat = data.reshape(data.shape[0], -1)
        out = flat.new_zeros((num_segments + 1, flat.shape[1]))
        out = out.scatter_reduce(0, ids[:, None].expand_as(flat), flat,
                                 "amax", include_self=False)[:num_segments]
        ctx.save_for_backward(flat, ids, out)
        ctx.data_shape = data.shape
        return out.reshape((num_segments,) + tuple(data.shape[1:]))

    @staticmethod
    def backward(ctx, ct):
        flat, ids, out = ctx.saved_tensors
        n = out.shape[0]
        valid = ids < n
        safe = torch.where(valid, ids, torch.zeros_like(ids))
        ct = ct.reshape(n, -1)
        achieved = (flat == out[safe]) & valid[:, None]
        d = torch.where(achieved, ct[safe], torch.zeros_like(flat))
        return d.reshape(ctx.data_shape), None, None


def _segment_max_raw(data, ids, num_segments):
    return _SegmentMax.apply(data, ids, num_segments)


def segment_count(segment_ids, num_segments: int, *, mask=None,
                  dtype=torch.float32):
    ids = _masked_ids(segment_ids, num_segments, mask)
    ones = torch.ones(ids.shape[0], dtype=dtype, device=ids.device)
    return _segment_sum_ids(ones, ids, num_segments)


def segment_sum(data, segment_ids, num_segments: int, *, mask=None):
    return _segment_sum_ids(data, _masked_ids(segment_ids, num_segments,
                                              mask), num_segments)


def segment_mean(data, segment_ids, num_segments: int, *, mask=None):
    """Sum over the segment's (unmasked) rows over their count; an empty
    segment gives 0 (the count is clamped to 1)."""
    s = segment_sum(data, segment_ids, num_segments, mask=mask)
    cnt = torch.clamp(segment_count(segment_ids, num_segments, mask=mask,
                                    dtype=s.dtype), min=1.0)
    return s / _bcast(cnt, s.ndim)


def segment_wsum(data, segment_ids, weights, num_segments: int, *,
                 mask=None):
    w = _bcast(weights.to(data.dtype), data.ndim)
    return segment_sum(data * w, segment_ids, num_segments, mask=mask)


def segment_sumsq(data, segment_ids, num_segments: int, *, mask=None):
    return segment_sum(data * data, segment_ids, num_segments, mask=mask)


def segment_max(data, segment_ids, num_segments: int, *, mask=None):
    return _segment_max_raw(data, _masked_ids(segment_ids, num_segments,
                                              mask), num_segments)


def segment_min(data, segment_ids, num_segments: int, *, mask=None):
    return -segment_max(-data, segment_ids, num_segments, mask=mask)


def segment_var(data, segment_ids, num_segments: int, *, mask=None):
    """``E[x^2] - E[x]^2`` over each segment's (unmasked) rows, with
    autograd's backward, as in ``multi_aggregate``; an empty segment
    gives 0."""
    m = segment_mean(data, segment_ids, num_segments, mask=mask)
    msq = segment_mean(data * data, segment_ids, num_segments, mask=mask)
    return _var_from_moments(msq, m)


def segment_std(data, segment_ids, num_segments: int, *, mask=None):
    """``sqrt(relu(var) + 1e-5)`` (reference ``experiments/layers.py:
    214-216``); an empty segment gives sqrt(1e-5)."""
    return torch.sqrt(torch.relu(segment_var(
        data, segment_ids, num_segments, mask=mask)) + 1e-5)


def segment_softmax(logits, segment_ids, num_segments: int, *, mask=None):
    """Softmax of ``logits`` [E, ...] within each segment, shifted by the
    segment's max. A masked entry gets probability 0, and a segment with
    no unmasked entry gives zeros."""
    ids = _masked_ids(segment_ids, num_segments, mask)
    seg = segment_ids.long()
    mx = _segment_max_raw(logits, ids, num_segments)   # empty: 0
    ex = torch.exp(logits - mx[seg])
    if mask is not None:
        ex = torch.where(_bcast(mask, ex.ndim), ex, torch.zeros_like(ex))
    denom = torch.clamp(_segment_sum_ids(ex, ids, num_segments),
                        min=torch.finfo(logits.dtype).tiny)
    return ex / denom[seg]


def prims_needed(aggrs: Sequence[str]) -> tuple:
    """The edge-level primitives an aggregator list needs
    (``egc_tpu.ops.segment.prims_needed``)."""
    needs = {canonical_aggr(a) for a in aggrs}
    prims = []
    if needs & {"sum", "mean", "var", "std"}:
        prims.append("sum")
    if "symnorm" in needs:
        prims.append("wsum")
    if needs & {"var", "std"}:
        prims.append("sumsq")
    if needs & {"mean", "max", "min", "var", "std"}:
        prims.append("count")
    if "max" in needs:
        prims.append("max")
    if "min" in needs:
        prims.append("min")
    return tuple(prims)


def segment_primitives(src_vals: torch.Tensor, senders: torch.Tensor,
                       receivers: torch.Tensor, prims: Sequence[str],
                       num_segments: int, *,
                       edge_mask: Optional[torch.Tensor] = None,
                       edge_w: Optional[torch.Tensor] = None) -> dict:
    """Edge-level primitives of ``src_vals[senders]`` at each receiver, a
    dict over ``prims`` (sum, wsum with ``edge_w``, sumsq, count, max,
    min), the layer under ``multi_aggregate``
    (``egc_tpu.ops.segment.segment_primitives``). Partials over disjoint
    edge subsets combine exactly (``combine_primitives``): an empty
    segment's max is -inf and its min +inf until assembly. A masked
    edge's sender is never read, so it may lie outside ``src_vals``."""
    s = senders.long()
    if edge_mask is not None:
        s = torch.where(edge_mask, s, torch.zeros_like(s))
    gathered = src_vals[s]
    ids = _masked_ids(receivers, num_segments, edge_mask)
    count = None
    if "count" in prims or "max" in prims or "min" in prims:
        count = segment_count(receivers, num_segments, mask=edge_mask,
                              dtype=src_vals.dtype)
    out = {}
    for p in prims:
        if p == "sum":
            out[p] = _segment_sum_ids(gathered, ids, num_segments)
        elif p == "wsum":
            w = edge_w.to(gathered.dtype)[:, None]
            out[p] = _segment_sum_ids(gathered * w, ids, num_segments)
        elif p == "sumsq":
            out[p] = _segment_sum_ids(gathered * gathered, ids,
                                      num_segments)
        elif p == "count":
            out[p] = count
        elif p in ("max", "min"):
            sign = 1.0 if p == "max" else -1.0
            ext = sign * _segment_max_raw(sign * gathered, ids,
                                          num_segments)
            out[p] = torch.where(count[:, None] > 0, ext,
                                 torch.full_like(ext, -sign * math.inf))
        else:  # pragma: no cover
            raise ValueError(p)
    return out


def combine_primitives(a: dict, b: dict) -> dict:
    """Primitives of the union of two disjoint edge subsets: sums and
    counts add, max / min by max / min."""
    out = {}
    for k in a:
        if k == "max":
            out[k] = torch.maximum(a[k], b[k])
        elif k == "min":
            out[k] = torch.minimum(a[k], b[k])
        else:
            out[k] = a[k] + b[k]
    return out


def assemble_aggregators(p: dict, node_vals: torch.Tensor,
                         aggrs: Sequence[str], *,
                         include_self: bool = False,
                         symnorm_self_w: Optional[torch.Tensor] = None
                         ) -> list:
    """The A aggregators, each ``[N, F]``, from primitives ``p`` (``count``
    [N] beside the ``[N, F]`` ones) and the self values ``node_vals``
    (virtual self-loops), with ``multi_aggregate``'s semantics."""
    aggrs = [canonical_aggr(a) for a in aggrs]
    counts = p["count"][:, None] if "count" in p else None
    outs = []
    for a in aggrs:
        if a == "sum":
            out = p["sum"] + node_vals if include_self else p["sum"]
        elif a == "mean":
            if include_self:
                out = (p["sum"] + node_vals) / torch.clamp(counts + 1.0,
                                                           min=1.0)
            else:
                out = p["sum"] / torch.clamp(counts, min=1.0)
        elif a in ("max", "min"):
            has = counts > 0
            if include_self:
                pick = torch.maximum if a == "max" else torch.minimum
                out = pick(torch.where(has, p[a], node_vals), node_vals)
            else:
                out = torch.where(has, p[a], torch.zeros_like(p[a]))
        elif a in ("var", "std"):
            s, sq = p["sum"], p["sumsq"]
            if include_self:
                s = s + node_vals
                sq = sq + node_vals * node_vals
                d = torch.clamp(counts + 1.0, min=1.0)
            else:
                d = torch.clamp(counts, min=1.0)
            out = _var_from_moments(sq / d, s / d)
            if a == "std":
                out = torch.sqrt(torch.relu(out) + 1e-5)
        else:  # symnorm
            out = p["wsum"]
            if symnorm_self_w is not None:
                out = out + symnorm_self_w.to(out.dtype)[:, None] * node_vals
        outs.append(out)
    return outs


def multi_aggregate(
    node_vals: torch.Tensor,              # [N, F]
    senders: torch.Tensor,                # [E]
    receivers: torch.Tensor,              # [E]
    aggrs: Sequence[str],
    *,
    edge_mask: Optional[torch.Tensor] = None,
    include_self: bool = False,
    symnorm_edge_w: Optional[torch.Tensor] = None,   # [E]
    symnorm_self_w: Optional[torch.Tensor] = None,   # [N]
) -> torch.Tensor:
    """Several aggregators over one gather: returns ``[N, A, F]`` in the
    order of ``aggrs`` (``egc_tpu.ops.segment.multi_aggregate``)."""
    aggrs = [canonical_aggr(a) for a in aggrs]
    if "symnorm" in aggrs and symnorm_edge_w is None:
        raise ValueError("symnorm aggregator requires symnorm_edge_w")
    p = segment_primitives(node_vals, senders, receivers,
                           prims_needed(aggrs), node_vals.shape[0],
                           edge_mask=edge_mask, edge_w=symnorm_edge_w)
    return torch.stack(assemble_aggregators(
        p, node_vals, aggrs, include_self=include_self,
        symnorm_self_w=symnorm_self_w), dim=1)
