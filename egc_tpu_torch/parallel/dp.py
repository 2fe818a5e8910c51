"""Data parallelism for the batched tasks (counterpart of
``egc_tpu.parallel.dp``).

Each rank of the process group takes its own microbatch of each step
(``microbatch_iter``). The step (``make_dp_train_step``) sums the loss
over the rank's valid rows, runs backward, then all-reduces the
gradients, the loss sum and the valid count in one buffer and divides by
the global count; the masked BatchNorms are synced over the group
(``nn.norm.sync_process_group``). So a DP step equals one device's step
on the stacked global batch, whatever each rank's valid count.
``DistributedDataParallel``'s averaging over the world size would divide
by the wrong number whenever the ranks hold different counts of valid
rows, so it is not used. Dropout on each rank draws from the step's
generator folded with the rank (``fold_in(rng, axis_index)``).
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional

import torch
import torch.distributed as dist

from egc_tpu_torch.nn.norm import sync_process_group
from egc_tpu_torch.train.loop import fold_in


def microbatch_iter(loader: Iterable, world_size: int,
                    rank: int) -> Iterator:
    """Group consecutive loader batches into DP steps of ``world_size``
    microbatches (a final incomplete group is dropped) and yield this
    rank's microbatch of each."""
    group = []
    for item in loader:
        group.append(item)
        if len(group) == world_size:
            yield group[rank]
            group = []


def all_reduce_gradients(params, loss_sum: torch.Tensor,
                         count: torch.Tensor, group=None):
    """After ``loss_sum.backward()`` on each rank: sum the gradients of
    ``params`` (in the same order on every rank; a missing gradient counts
    as zeros), the loss sum and ``count`` over the group in one
    all-reduce, and set each gradient to the sum over the global count
    (at least 1). Returns the global mean loss and the global count, both
    device scalars."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss_sum.detach().reshape(1),
                        count.detach().to(loss_sum.dtype).reshape(1)])
    dist.all_reduce(flat, group=group)
    c = torch.clamp(flat[-1], min=1.0)
    offset = 0
    for p, g in zip(params, grads):
        p.grad = (flat[offset:offset + g.numel()] / c).view_as(p)
        offset += g.numel()
    return flat[-2] / c, c


def rank_generator(generator: Optional[torch.Generator], group=None
                   ) -> Optional[torch.Generator]:
    """``fold_in(generator, rank)``: this rank's dropout stream."""
    if generator is None:
        return None
    return fold_in(generator, dist.get_rank(group))


def make_dp_train_step(model: torch.nn.Module, loss_sum_fn: Callable,
                       group=None) -> Callable:
    """The DP step of ``model`` (its masked BatchNorms synced over
    ``group`` from here on): ``step(optimizer, graph, y, generator=None)``
    runs this rank's microbatch and returns the global mean loss.
    ``loss_sum_fn(out, y, graph) -> (loss_sum, valid_count)``, summed, not
    averaged."""
    sync_process_group(model, group)

    def step(optimizer: torch.optim.Optimizer, graph, y: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        out = model(graph, generator=rank_generator(generator, group))
        s, c = loss_sum_fn(out, y, graph)
        s.backward()
        loss, _ = all_reduce_gradients(model.parameters(), s, c, group)
        optimizer.step()
        return loss

    return step
