"""Kernel plan and fused multi-aggregate (counterpart of
``egc_tpu.ops.dispatch``).

``build_kernel_plan`` lays a static graph out for the gather-reduce
kernels in a Hopper layout: a receiver-sorted CSR for the forward and a
sender-sorted CSC of the transposed graph for the backward, each with its
edge weights pre-permuted, the CSC position of each CSR edge (where the
forward stores an edge's max / min mask words for the backward), and the
in-degree over valid edges. The TPU's window/cell layout and its 128-lane
row padding are not carried over.
Masked (padding) edges never enter the plan: the JAX package's note on
pad-row self-loops (``dispatch.py:135-143``) shows what they would do to
the max/min tie backward. ``build_kernel_plan_device`` builds the same
plan in torch ops on the card, for a graph that changes every step (a
sampled batch); it keeps the masked edges past ``rowptr[N]`` and
``colptr[N]``, where no kernel reads.

``fused_multi_aggregate`` runs the edge-level primitives through one
autograd function (kernel 1 forward, kernel 2 backward) and assembles the
aggregators on node-level tensors in plain PyTorch, with the semantics of
``ops.segment.multi_aggregate``. Edge weights are graph constants: they get
no gradient.

``conv_aggregate`` is what convs call. Dispatch follows the device: a CUDA
tensor with a plan goes to the kernels, a CUDA tensor without one raises,
and a CPU tensor goes to ``ops.segment.multi_aggregate``.

``build_bipartite_kernel_plan`` and ``bipartite_multi_aggregate`` are the
same over two node spaces (a relation of a hetero graph): senders index
``num_src`` source rows, receivers ``num_dst`` destination rows. The
kernels take their output rows from ``rowptr`` / ``colptr`` and their
input rows from the tensors, so the bipartite mode is a plan whose CSR
spans the destination rows and whose CSC spans the source rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from egc_tpu_torch.ops.cuda.gather_reduce import (
    EXTREMA, gather_reduce_bwd, gather_reduce_fwd,
)
from egc_tpu_torch.ops.segment import (
    assemble_aggregators, canonical_aggr, multi_aggregate,
)
from egc_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class KernelPlan:
    """Static CSR/CSC edge layouts of one graph over ``num_nodes`` rows;
    a bipartite plan (``num_src`` set) gathers from ``num_src`` source
    rows into ``num_nodes`` destination rows."""

    num_nodes: int              # receiver (CSR) rows
    rowptr: torch.Tensor        # [N+1] int32, forward CSR by receiver
    fwd_senders: torch.Tensor   # [E'] int32, sender of each CSR edge
    fwd_w: Optional[torch.Tensor]   # [E'] f32, edge weights in CSR order
    fwd_perm: torch.Tensor      # [E'] int64, original edge index
    colptr: torch.Tensor        # [N+1] int32, backward CSC by sender
    bwd_receivers: torch.Tensor  # [E'] int32, receiver of each CSC edge
    bwd_w: Optional[torch.Tensor]   # [E'] f32, edge weights in CSC order
    bwd_perm: torch.Tensor      # [E'] int64, original edge index
    fwd_to_bwd: torch.Tensor    # [E'] int32, CSC position of each CSR edge
    deg: torch.Tensor           # [N] f32, in-degree over valid edges
    num_src: Optional[int] = None   # sender (CSC) rows of a bipartite plan

    @property
    def src_rows(self) -> int:
        """Rows of the gathered (sender) side."""
        return self.num_nodes if self.num_src is None else self.num_src

    @property
    def num_edges(self) -> int:
        """Edge slots of the layouts (a plan built on the card keeps its
        masked edges past ``rowptr[N]``: ``rowptr[N]`` counts the valid
        ones)."""
        return self.fwd_senders.shape[0]

    def _map(self, fn) -> "KernelPlan":
        fields = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(self)}
        return dataclasses.replace(self, **{
            k: fn(v) for k, v in fields.items()
            if isinstance(v, torch.Tensor)})

    def to(self, device, non_blocking: bool = False) -> "KernelPlan":
        return self._map(lambda v: v.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "KernelPlan":
        return self._map(lambda v: v.pin_memory())


def build_kernel_plan(senders, receivers, num_nodes: int, *,
                      edge_mask=None, edge_weight=None,
                      device=None) -> KernelPlan:
    """Host-side plan build (once per static graph). ``edge_weight`` (in
    original edge order) is pre-permuted into both layouts."""
    plan = _build_plan(senders, receivers, num_nodes, num_nodes, edge_mask,
                       edge_weight)
    return plan if device is None else plan.to(device)


def build_bipartite_kernel_plan(senders, receivers, num_src: int,
                                num_dst: int, *, edge_mask=None,
                                device=None) -> KernelPlan:
    """Host-side plan of one relation: a receiver-sorted CSR over
    ``num_dst`` rows, a sender-sorted CSC over ``num_src`` rows,
    ``fwd_to_bwd`` and ``deg`` over ``num_dst``. Masked edges are dropped
    (``egc_tpu``'s default); an endpoint outside its side's rows raises,
    since the kernels do not check the rows they gather."""
    plan = _build_plan(senders, receivers, num_src, num_dst, edge_mask,
                       None)
    plan.num_src = num_src
    return plan if device is None else plan.to(device)


def _build_plan(senders, receivers, num_src, num_dst, edge_mask,
                edge_weight) -> KernelPlan:
    s = np.asarray(senders, dtype=np.int64)
    r = np.asarray(receivers, dtype=np.int64)
    kept = np.arange(len(s)) if edge_mask is None \
        else np.nonzero(np.asarray(edge_mask))[0]
    s, r = s[kept], r[kept]
    if len(s) and (s.min() < 0 or s.max() >= num_src or r.min() < 0
                   or r.max() >= num_dst):
        raise ValueError(f"edge endpoints out of range: senders must lie in "
                         f"[0, {num_src}), receivers in [0, {num_dst})")
    w = None if edge_weight is None else \
        np.asarray(edge_weight, dtype=np.float32)[kept]

    def layout(major, minor, rows):
        order = np.lexsort((minor, major))     # by major, then minor
        ptr = np.searchsorted(major[order], np.arange(rows + 1))
        return order, (torch.from_numpy(ptr.astype(np.int32)),
                       torch.from_numpy(minor[order].astype(np.int32)),
                       None if w is None else torch.from_numpy(w[order]),
                       torch.from_numpy(kept[order].astype(np.int64)))

    fwd_order, (rowptr, fwd_s, fwd_w, fwd_perm) = layout(r, s, num_dst)
    bwd_order, (colptr, bwd_r, bwd_w, bwd_perm) = layout(s, r, num_src)
    csc_pos = np.empty(len(s), np.int32)       # CSC position of each edge
    csc_pos[bwd_order] = np.arange(len(s), dtype=np.int32)
    deg = torch.from_numpy(
        np.bincount(r, minlength=num_dst).astype(np.float32))
    return KernelPlan(num_nodes=num_dst, rowptr=rowptr, fwd_senders=fwd_s,
                      fwd_w=fwd_w, fwd_perm=fwd_perm, colptr=colptr,
                      bwd_receivers=bwd_r, bwd_w=bwd_w, bwd_perm=bwd_perm,
                      fwd_to_bwd=torch.from_numpy(csc_pos[fwd_order]),
                      deg=deg)


def build_kernel_plan_device(senders: torch.Tensor, receivers: torch.Tensor,
                             num_nodes: int, *,
                             edge_mask: Optional[torch.Tensor] = None
                             ) -> KernelPlan:
    """``build_kernel_plan`` in torch ops on the tensors' own device, for a
    graph that changes every step (a sampled batch): no host sync, so the
    plan is enqueued with the step (counterpart of
    ``egc_tpu.ops.dispatch.build_kernel_plan_jax``).

    Each layout is one stable sort on ``major * (N + 1) + minor`` (int64),
    ``np.lexsort``'s order. A masked edge gets the sentinel major ``N``:
    it sorts past ``rowptr[N]`` / ``colptr[N]``, where no kernel reads, so
    masked edges stay out of the plan as in the host build. On the valid
    prefix every field equals ``build_kernel_plan``'s; the arrays keep all
    ``E`` slots. No edge weights are carried (symnorm's are per batch)."""
    dev = senders.device
    s, r = senders.long(), receivers.long()
    s_major, r_major = s, r
    if edge_mask is not None:
        s_major = torch.where(edge_mask, s, num_nodes)
        r_major = torch.where(edge_mask, r, num_nodes)
    rows = torch.arange(num_nodes + 1, device=dev)

    def layout(major, minor):
        order = torch.sort(major * (num_nodes + 1) + minor,
                           stable=True).indices
        ptr = torch.searchsorted(major[order], rows).to(torch.int32)
        return order, ptr, minor[order].to(torch.int32)

    fwd_order, rowptr, fwd_s = layout(r_major, s)
    bwd_order, colptr, bwd_r = layout(s_major, r)
    csc_pos = torch.empty_like(bwd_order)
    csc_pos[bwd_order] = torch.arange(bwd_order.shape[0], device=dev)
    return KernelPlan(num_nodes=num_nodes, rowptr=rowptr, fwd_senders=fwd_s,
                      fwd_w=None, fwd_perm=fwd_order, colptr=colptr,
                      bwd_receivers=bwd_r, bwd_w=None, bwd_perm=bwd_order,
                      fwd_to_bwd=csc_pos[fwd_order].to(torch.int32),
                      deg=(rowptr[1:] - rowptr[:-1]).float())


def _plan_prims(aggrs: Tuple[str, ...]) -> Tuple[str, ...]:
    """Edge-level primitives a canonical aggregator tuple needs."""
    needs = set(aggrs)
    prims = []
    if needs & {"sum", "mean", "var", "std"}:
        prims.append("sum")
    if "symnorm" in needs:
        prims.append("wsum")
    if needs & {"var", "std"}:
        prims.append("sumsq")
    if "max" in needs:
        prims.append("max")
    if "min" in needs:
        prims.append("min")
    return tuple(prims)


class _FusedPrimitives(torch.autograd.Function):
    """Edge-level primitives: kernel 1 forward, kernel 2 backward over the
    transposed layout. The forward writes the max / min ``masks`` asked
    for (which in-edges hold each extremum; asked for when ``vals`` needs
    a gradient), and the backward takes them and one tensor per
    coefficient."""

    @staticmethod
    def forward(ctx, vals, plan, prims, ew_f, ew_b, masks):
        res = gather_reduce_fwd(vals, plan.rowptr, plan.fwd_senders, ew_f,
                                prims, masks=masks,
                                fwd_to_bwd=plan.fwd_to_bwd)
        words = dict(zip(masks, res[len(prims):]))
        ctx.plan, ctx.prims = plan, prims
        ctx.save_for_backward(vals if "sumsq" in prims else None, ew_b,
                              words.get("max"), words.get("min"))
        return res[:len(prims)]

    @staticmethod
    def backward(ctx, *cts):
        vals, ew_b, max_mask, min_mask = ctx.saved_tensors
        ct = {p: c.contiguous() for p, c in zip(ctx.prims, cts)}
        d_vals = gather_reduce_bwd(
            ctx.plan.colptr, ctx.plan.bwd_receivers, c_sum=ct.get("sum"),
            c_wsum=ct.get("wsum"), edge_w=ew_b if "wsum" in ct else None,
            c_sumsq2=2.0 * ct["sumsq"] if "sumsq" in ct else None,
            vals=vals, c_max=ct.get("max"), max_mask=max_mask,
            c_min=ct.get("min"), min_mask=min_mask)
        return d_vals, None, None, None, None, None


def fused_multi_aggregate(
    vals: torch.Tensor,                      # [N, F], N == plan.num_nodes
    plan: KernelPlan,
    aggrs: Sequence[str],
    *,
    include_self: bool = False,
    symnorm_edge_w: Optional[torch.Tensor] = None,   # [E] original order
    symnorm_self_w: Optional[torch.Tensor] = None,   # [N]
    stacked: bool = True,
):
    """Plan-based multi-aggregate: ``[N, A, F]``, or a tuple of A ``[N, F]``
    tensors with ``stacked=False`` (what the head-mix kernel takes).
    Semantics of ``ops.segment.multi_aggregate``.

    A plan built with ``edge_weight`` carries its own pre-permuted symnorm
    weights, and they win over ``symnorm_edge_w`` (as in ``egc_tpu``);
    ``conv_aggregate`` refuses a graph where the two could differ. The
    span ``egc.aggregate``, as the CPU path's in ``conv_aggregate``."""
    with span("egc.aggregate"):
        aggrs = tuple(canonical_aggr(a) for a in aggrs)
        if vals.shape[0] != plan.src_rows:
            raise ValueError(f"vals has {vals.shape[0]} rows, the plan "
                             f"{plan.src_rows}")
        if plan.num_src is not None and (include_self or "symnorm" in aggrs):
            raise ValueError("a bipartite plan takes no self term and no "
                             "symnorm: use bipartite_multi_aggregate")
        prims = _plan_prims(aggrs)
        ew_f = ew_b = None
        if "wsum" in prims:
            if plan.fwd_w is not None:
                ew_f, ew_b = plan.fwd_w, plan.bwd_w
            elif symnorm_edge_w is None:
                raise ValueError("symnorm requires symnorm_edge_w")
            else:
                w = symnorm_edge_w.detach().float()
                ew_f = w[plan.fwd_perm].contiguous()
                ew_b = w[plan.bwd_perm].contiguous()
        masks = tuple(m for m in EXTREMA if m in prims) \
            if vals.requires_grad and torch.is_grad_enabled() else ()
        p = dict(zip(prims, _FusedPrimitives.apply(vals.contiguous(), plan,
                                                   prims, ew_f, ew_b, masks)))

        p["count"] = plan.deg
        outs = assemble_aggregators(p, vals, aggrs, include_self=include_self,
                                    symnorm_self_w=symnorm_self_w)
        return torch.stack(outs, dim=1) if stacked else tuple(outs)


BIPARTITE_AGGRS = ("sum", "mean", "max", "min")


def bipartite_multi_aggregate(x_src: torch.Tensor, plan: KernelPlan,
                              aggrs: Sequence[str],
                              num_dst: Optional[int] = None) -> torch.Tensor:
    """Per-relation aggregation of ``x_src [num_src, F]`` into the plan's
    destination rows: ``[num_dst, A, F]`` for sum / mean / max / min (an
    empty destination row gives 0), through the kernels' autograd function
    (the max / min masks asked for when ``x_src`` needs a gradient), as
    ``egc_tpu.ops.dispatch.bipartite_multi_aggregate``. ``num_dst`` past
    the plan's rows (a partition's extended rows, whose plan covers the
    owned rows only) zero-pads the output to it, as
    ``egc_tpu/nn/conv/hetero.py:39-44`` does."""
    aggrs = tuple(canonical_aggr(a) for a in aggrs)
    bad = set(aggrs) - set(BIPARTITE_AGGRS)
    if bad:
        raise ValueError(f"bipartite aggregation does not support "
                         f"{sorted(bad)}")
    out = fused_multi_aggregate(x_src, plan, aggrs)
    if num_dst is None or num_dst == plan.num_nodes:
        return out
    if num_dst < plan.num_nodes:
        raise ValueError(f"num_dst {num_dst} is below the plan's "
                         f"{plan.num_nodes} destination rows")
    return torch.cat([out, out.new_zeros((num_dst - plan.num_nodes,)
                                         + out.shape[1:])])


def conv_aggregate(g, x, aggrs, *, include_self: bool = False,
                   symnorm_edge_w=None, symnorm_self_w=None,
                   stacked: bool = True):
    """Aggregation entry point of the convs: ``[N, A, F]`` in the order of
    ``aggrs`` (a tuple of A ``[N, F]`` with ``stacked=False``).

    When the graph's plan carries edge weights, ``symnorm_edge_w`` must be
    the graph's own ``edge_weight`` (the weights the plan was built from),
    so the kernels and the CPU path aggregate with the same weights."""
    plan = g.kernel_plan
    if (plan is not None and plan.fwd_w is not None
            and symnorm_edge_w is not None
            and symnorm_edge_w is not g.edge_weight):
        raise ValueError(
            "the graph's kernel plan carries its own edge weights; "
            "symnorm_edge_w must be the graph's edge_weight")
    if x.device.type == "cpu":
        with span("egc.aggregate"):
            out = multi_aggregate(
                x, g.senders, g.receivers, aggrs, edge_mask=g.edge_mask,
                include_self=include_self, symnorm_edge_w=symnorm_edge_w,
                symnorm_self_w=symnorm_self_w)
            return out if stacked else tuple(out.unbind(dim=1))
    if plan is None:
        raise RuntimeError(
            "conv_aggregate on a CUDA tensor needs a graph with a kernel "
            "plan (ops.dispatch.build_kernel_plan)")
    return fused_multi_aggregate(
        x, plan, aggrs, include_self=include_self,
        symnorm_edge_w=symnorm_edge_w, symnorm_self_w=symnorm_self_w,
        stacked=stacked)
