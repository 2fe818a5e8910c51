"""Halo exchange and partitioned full-graph training (counterpart of
``egc_tpu.parallel.halo``).

Each rank holds one partition of ``parallel/partition.py``'s plan: an
extended graph over ``[owned | halo]`` rows. Per layer it refreshes its
halo rows from their owners with one all-to-all (``halo_refresh``), then
runs the ordinary local aggregation: the convs are unchanged. With
sync-BN (global statistics), the global symnorm weights and summed
gradients, a partitioned step reproduces the single-device step.

``DistributedNodeClassifier`` is ``ArxivNet`` (its modules, so its state
dict is ``ArxivNet``'s and ``checkpoint.pt`` has one format) with a halo
refresh after the embedding and after each block and its BatchNorms
synced over the group. Its path follows the graph, as JAX's does
(``halo.py:176-177``):

- with a kernel plan (the card), the generic conv path: the kernels on
  the extended graph, refreshes around each block;
- without one (the CPU), for EGC with ``e_interior`` set, the overlap
  path, ``egconv_overlap``.

``egconv_overlap`` is the counterpart of ``EGConvOverlap`` (``:36-132``),
as a function of the layer's ``EGConv`` so the net keeps ``ArxivNet``'s
modules. Its exchange of the owned rows the other ranks need is issued
asynchronously first; the owned rows' bases and comb matmuls and the
interior edges' primitives (edges ``[0, e_interior)``, owned senders)
run while it is in flight; then the boundary primitives over the
received rows, ``combine_primitives``, the assembly and the head mix.
It is a plain PyTorch path: on a CUDA tensor it raises, since the card
takes the kernel plan.

The steps take the explicit-sum variant of ``make_partitioned_train_step``
(``:230-286``, ``check_vma=False``): the loss is the local NLL sum over
the partition's train rows, backward runs on it, and then the gradients,
the loss and the count are all-reduced and divided by the global count.
Dropout draws from the step's generator folded with the rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from egc_tpu_torch.models.nets import ArxivNet, ConvSpec, dropout
from egc_tpu_torch.nn.conv.egc import EGConv
from egc_tpu_torch.nn.norm import sync_process_group
from egc_tpu_torch.ops.cuda.headmix import head_mix_fused
from egc_tpu_torch.ops.segment import (
    assemble_aggregators, combine_primitives, prims_needed,
    segment_primitives,
)
from egc_tpu_torch.parallel.dp import all_reduce_gradients, rank_generator
from egc_tpu_torch.parallel.mesh import all_to_all
from egc_tpu_torch.train.losses import gather_label_scores


def halo_refresh(x_ext: torch.Tensor, send_idx: torch.Tensor,
                 group=None) -> torch.Tensor:
    """``x_ext [n_local + P*H, F]`` with its halo rows replaced by their
    owners' rows: ``send_idx [P, H]`` are the local rows this rank sends
    to each rank; one all-to-all of ``[P*H, F]``."""
    num_parts, h = send_idx.shape
    n_local = x_ext.shape[0] - num_parts * h
    own = x_ext[:n_local]
    recv = all_to_all(own[send_idx.reshape(-1).long()], group)
    return torch.cat([own, recv])


def egconv_overlap(conv: EGConv, g, x: torch.Tensor,
                   send_idx: torch.Tensor, *, e_interior: int,
                   group=None) -> torch.Tensor:
    """``conv`` on the extended graph ``g`` with the halo exchange
    overlapped with the interior sweep; returns ``[n_ext, O]`` whose halo
    rows are 0 (never read: the exchange inside the next call refills
    them). ``x``'s halo rows are not read either."""
    if x.is_cuda:
        raise RuntimeError("egconv_overlap is the plain path; on the card "
                           "the partitioned net runs the kernel plan")
    H, B, A, L = conv.H, conv.B, conv.A, conv.L
    num_parts, h = send_idx.shape
    n_ext = x.shape[0]
    n_local = n_ext - num_parts * h
    x_own = x[:n_local]

    # 1. the exchange first: nothing below the wait depends on it
    pending = []
    recv = all_to_all(x_own[send_idx.reshape(-1).long()], group, pending)

    # 2. owned-row compute while it is in flight
    bases_o, w2d = conv.bases_and_weights(x_own)
    prims = prims_needed(conv.aggrs)
    ei = e_interior
    ew = g.edge_weight if "symnorm" in conv.aggrs else None
    p_int = segment_primitives(
        bases_o, g.senders[:ei], g.receivers[:ei], prims, n_local,
        edge_mask=g.edge_mask[:ei], edge_w=None if ew is None else ew[:ei])

    # 3. the boundary edges' contribution, over the received rows
    for work in pending:
        work.wait()
    bases_h = recv @ torch.cat(list(conv.bases_weight), dim=1)
    p_bnd = segment_primitives(
        bases_h, g.senders[ei:].long() - n_local, g.receivers[ei:], prims,
        n_local, edge_mask=g.edge_mask[ei:],
        edge_w=None if ew is None else ew[ei:])

    p = combine_primitives(p_int, p_bnd)
    ssw = None
    if g.self_weight is not None and "symnorm" in conv.aggrs:
        ssw = g.self_weight[:n_local]
    ys = assemble_aggregators(p, bases_o, conv.aggrs,
                              include_self=conv.self_loop_mode == "all",
                              symnorm_self_w=ssw)
    z = head_mix_fused(w2d, tuple(ys), H=H, B=B, A=A, L=L, bias=conv.bias)
    return torch.cat([z, z.new_zeros(n_ext - n_local, z.shape[1])])


class DistributedNodeClassifier(ArxivNet):
    """``ArxivNet`` over one partition of a partitioned graph: the same
    modules and initialisation from ``generator`` (so every rank built
    from one seed holds the same weights), the halo refreshed after the
    embedding and after every block, BatchNorm statistics over the
    ``group``. ``e_interior`` (the plan's) enables the overlap path for
    EGC on a graph without a kernel plan."""

    def __init__(self, conv: ConvSpec, hidden_dim: int, *,
                 num_layers: int = 3, dropout: float = 0.5,
                 num_features: int = 128, num_classes: int = 40,
                 e_interior: Optional[int] = None, group=None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(conv, hidden_dim, num_layers=num_layers,
                         dropout=dropout, num_features=num_features,
                         num_classes=num_classes, generator=generator,
                         device=device)
        self.kind = conv.kind
        self.e_interior = e_interior
        self.group = group
        sync_process_group(self, group)

    def forward(self, g, send_idx: torch.Tensor, *,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Log-probabilities ``[n_ext, C]``; the owned rows are valid."""
        overlap = (self.kind == "egc" and self.e_interior is not None
                   and g.kernel_plan is None)
        x = self.embed(g.nodes)
        if not overlap:
            x = halo_refresh(x, send_idx, self.group)
        for conv, bn in zip(self.convs, self.bns):
            identity = x
            if overlap:
                x = egconv_overlap(conv, g, x, send_idx,
                                   e_interior=self.e_interior,
                                   group=self.group)
            else:
                x = conv(g, x)
            x = torch.relu(bn(x, g.node_mask))
            x = dropout(x, self.dropout, self.training, generator)
            x = x + identity
            if not overlap:
                x = halo_refresh(x, send_idx, self.group)
        return torch.log_softmax(self.out(x), dim=-1)


def partitioned_train_step(model: DistributedNodeClassifier,
                           optimizer: torch.optim.Optimizer, graph,
                           send_idx: torch.Tensor, labels: torch.Tensor,
                           train_mask: torch.Tensor,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """One partitioned step (``make_partitioned_train_step``'s explicit-sum
    variant): the NLL summed over this partition's train rows, backward,
    one all-reduce of every gradient, the loss sum and the train count,
    the gradients over the global count (``dp.all_reduce_gradients``), and
    the optimizer step, the same on every rank, so the replicas stay
    equal. Returns the global mean loss, a device scalar. ``labels`` /
    ``train_mask``: ``[n_local]``; dropout draws from ``generator``
    folded with the rank."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    n_local = labels.shape[0]
    out = model(graph, send_idx,
                generator=rank_generator(generator, model.group))
    m = train_mask.to(out.dtype)
    s_local = (-gather_label_scores(out[:n_local], labels) * m).sum()
    s_local.backward()
    loss, _ = all_reduce_gradients(model.parameters(), s_local, m.sum(),
                                   model.group)
    optimizer.step()
    return loss


@torch.no_grad()
def partitioned_eval(model: DistributedNodeClassifier, graph,
                     send_idx: torch.Tensor) -> torch.Tensor:
    """``make_partitioned_eval_step``: eval-mode log-probabilities
    ``[n_ext, C]`` of this rank (the owned rows valid)."""
    model.eval()
    return model(graph, send_idx)


def partitioned_accuracies(out: torch.Tensor, labels: torch.Tensor,
                           masks: dict, group=None) -> dict:
    """``split_accuracies`` over the whole graph from each rank's owned
    rows: every split's hits and row count summed over the group."""
    n_local = labels.shape[0]
    hit = out[:n_local].argmax(dim=-1) == labels
    splits = ("train", "val", "test")
    counts = torch.stack([torch.stack([(hit & masks[s]).sum(),
                                       masks[s].sum()]) for s in splits])
    dist.all_reduce(counts, group=group)
    accs = counts[:, 0] / counts[:, 1].clamp(min=1)
    return {f"{s}_acc": float(v) for s, v in zip(splits, accs.cpu())}
