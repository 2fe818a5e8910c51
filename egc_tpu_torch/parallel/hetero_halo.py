"""Partitioned heterogeneous training: rmag over ranks (counterpart of
``egc_tpu.parallel.hetero_halo``).

Each rank holds one partition of ``parallel/hetero_partition.py``'s plan:
per node type an extended row space ``[owned | P * H_t halo]``, per
relation the rank's edges (owned receivers). One all-to-all a type
(``halo.halo_refresh``) refreshes the halo rows of every relation that
reads the type.

``DistributedREGCNet`` is ``REGCNet`` (its modules, so its parameter
names are the reference's) with the halo refreshed before the first conv
and after every layer but the last, for the types the next layer reads
(``REGCNet.layer_out_types``). Each featureless type's embedding is a
rank-local parameter of ``[n_local_t, F]``: the rank's rows of the table
``REGCNet`` draws from the same seed (fill 0), padded to ``n_ext_t`` in
the forward (``extend_local``). Its gradient is never summed over the
ranks: the other ranks' rows are other nodes. ``full_state_dict`` gathers
the tables (a collective), so a checkpoint is ``REGCNet``'s;
``load_full_state_dict`` takes the rank's rows of one.

``partitioned_rmag_train_step`` is ``partitioned_train_step``'s
explicit-sum pattern: the local NLL sum over the owned train rows,
backward, one flattened all-reduce of the replicated parameters'
gradients with the loss sum and the train count
(``dp.all_reduce_gradients``),
the embeddings' gradients over the same global count, one optimizer
(``train/optim``'s Adam with L2 in the gradient) over both sets. Adam is
elementwise, so one optimizer gives each embedding row the update the
single-device step gives it, and a plateau decay reaches both sets. JAX
keeps a second, mirrored optimizer only for its sharding.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from egc_tpu_torch.graph.hetero import split_rel_key
from egc_tpu_torch.models.nets import dropout
from egc_tpu_torch.nn.conv.hetero import REGCNet
from egc_tpu_torch.parallel.dp import all_reduce_gradients, rank_generator
from egc_tpu_torch.parallel.halo import halo_refresh
from egc_tpu_torch.parallel.hetero_partition import TypePlan
from egc_tpu_torch.train.losses import gather_label_scores


def extend_local(x_local: torch.Tensor, n_ext: int) -> torch.Tensor:
    """``[n_local, F]`` owned rows -> ``[n_ext, F]`` with zeroed halo rows
    (the refresh fills them)."""
    return torch.cat([x_local, x_local.new_zeros(
        (n_ext - x_local.shape[0],) + x_local.shape[1:])])


class DistributedREGCNet(REGCNet):
    """``REGCNet`` over partition ``rank`` of a hetero plan (``type_plans``:
    the plan's ``TypePlan`` of each node type; ``num_nodes`` defaults to
    their full padded counts). Built from ``generator`` as ``REGCNet`` is,
    so the replicas start equal and equal to the single-device net of the
    same seed."""

    def __init__(self, hidden_dim: int, *, type_plans: Dict[str, TypePlan],
                 rank: int, group=None, **kwargs):
        kwargs.setdefault("num_nodes", {t: len(tp.owner)
                                        for t, tp in type_plans.items()})
        super().__init__(hidden_dim, **kwargs)
        self.rank, self.group = rank, group
        self.type_plans = dict(type_plans)
        for t in self.featureless_types:
            self.embs[t] = nn.Parameter(self.rank_rows(t, self.embs[t]))

    def first_layer_reads(self):
        """The types the first conv reads: its outputs and the sources of
        the relations into them."""
        out = self.layer_out_types()[0]
        return sorted(set(out) | {split_rel_key(k)[0] for k in self.relations
                                  if split_rel_key(k)[2] in out})

    def forward(self, hg, send_idx: Dict[str, torch.Tensor], *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Log-probabilities of the target type's ``[n_ext, C]`` rows; the
        owned rows are valid."""
        def refresh(x):
            return {t: halo_refresh(v, send_idx[t], self.group)
                    for t, v in x.items()}

        x = refresh({t: extend_local(self.embs[t],
                                     self.type_plans[t].n_ext)
                     if t in self.featureless_types else hg.nodes[t]
                     for t in self.first_layer_reads()})
        need = self.layer_out_types()
        for conv, types in zip(self.convs[:-1], need):
            x = conv(hg, x, out_types=types)
            x = refresh({t: dropout(torch.relu(v), self.dropout,
                                    self.training, generator)
                         for t, v in sorted(x.items())})
        x = self.convs[-1](hg, x, out_types=need[-1])
        return torch.log_softmax(x[self.target_type], dim=-1)

    def embedding_parameters(self):
        return [self.embs[t] for t in self.featureless_types]

    def replicated_parameters(self):
        """Every parameter but the embeddings, in ``parameters()``'s order
        (the same on every rank)."""
        local = {id(p) for p in self.embedding_parameters()}
        return [p for p in self.parameters() if id(p) not in local]

    def gather_rows(self, ntype: str, local: torch.Tensor) -> torch.Tensor:
        """``[n_local, ...]`` rows of type ``ntype`` on every rank -> the
        full ``[N_t, ...]`` table (an all-gather; every rank gets it),
        ``TypePlan.gather`` on the tensors' device."""
        tp = self.type_plans[ntype]
        parts = [torch.empty_like(local)
                 for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(parts, local.detach().contiguous(), group=self.group)
        gids = torch.from_numpy(tp.node_gids).to(local.device)
        out = local.new_zeros((len(tp.owner),) + local.shape[1:])
        out[gids[gids >= 0]] = torch.stack(parts)[gids >= 0]
        return out

    def rank_rows(self, ntype: str, table: torch.Tensor) -> torch.Tensor:
        """This rank's ``[n_local, ...]`` rows of a full table
        (``TypePlan.rank_rows``, fill 0, on the table's device)."""
        tp = self.type_plans[ntype]
        gids = torch.from_numpy(tp.node_gids[self.rank]).to(table.device)
        out = table.new_zeros((tp.n_local,) + table.shape[1:])
        out[gids >= 0] = table.detach()[gids[gids >= 0]]
        return out

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """``REGCNet``'s state dict: the embeddings gathered to their full
        tables (a collective: every rank calls it)."""
        sd = self.state_dict()
        for t in self.featureless_types:
            sd[f"embs.{t}"] = self.gather_rows(t, sd[f"embs.{t}"])
        return sd

    def load_full_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load ``REGCNet``'s state dict: this rank's rows of each table."""
        local = dict(sd)
        for t in self.featureless_types:
            local[f"embs.{t}"] = self.rank_rows(t, sd[f"embs.{t}"])
        self.load_state_dict(local, strict=True)


def _embedding_state_ids(model: DistributedREGCNet,
                         optimizer: torch.optim.Optimizer) -> Dict[int, str]:
    """The optimizer state dict's index of each embedding parameter (its
    parameters numbered over the groups, as ``state_dict`` numbers them)
    -> its type."""
    types = {id(model.embs[t]): t for t in model.featureless_types}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return {i: types[id(p)] for i, p in enumerate(params) if id(p) in types}


def _map_embedding_state(model, optimizer, opt_sd: dict, fn) -> dict:
    """``opt_sd`` with ``fn(type, tensor)`` applied to every per-row
    state tensor of an embedding parameter (Adam's moments; not its
    step)."""
    out = {"state": {}, "param_groups": opt_sd["param_groups"]}
    emb = _embedding_state_ids(model, optimizer)
    for i in sorted(opt_sd["state"]):
        st = opt_sd["state"][i]
        if i in emb:
            st = {k: fn(emb[i], v) if torch.is_tensor(v) and v.dim() > 0
                  else v for k, v in st.items()}
        out["state"][i] = st
    return out


def full_optimizer_state(model: DistributedREGCNet,
                         optimizer: torch.optim.Optimizer) -> dict:
    """The optimizer's state dict in ``REGCNet``'s layout: each embedding's
    moments gathered to the full table (a collective)."""
    return _map_embedding_state(model, optimizer, optimizer.state_dict(),
                                model.gather_rows)


def load_full_optimizer_state(model: DistributedREGCNet,
                              optimizer: torch.optim.Optimizer,
                              opt_sd: dict) -> None:
    """Load an optimizer state dict in ``REGCNet``'s layout: this rank's
    rows of each embedding's moments."""
    optimizer.load_state_dict(_map_embedding_state(model, optimizer, opt_sd,
                                                   model.rank_rows))


def partitioned_rmag_train_step(model: DistributedREGCNet,
                                optimizer: torch.optim.Optimizer, hg,
                                send_idx: Dict[str, torch.Tensor],
                                labels: torch.Tensor,
                                train_mask: torch.Tensor,
                                generator: Optional[torch.Generator] = None
                                ) -> torch.Tensor:
    """One partitioned rmag step: the NLL summed over this rank's owned
    train rows (``labels`` / ``train_mask``: ``[n_local]`` of the target
    type), backward, the replicated gradients, the loss sum and the train
    count summed over the group in one all-reduce, every gradient (the
    embeddings' rank-local ones too) over the global count, and the
    optimizer step. Dropout draws from ``generator`` folded with the
    rank. Returns the global mean loss, a device scalar."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    out = model(hg, send_idx,
                generator=rank_generator(generator, model.group))
    m = train_mask.to(out.dtype)
    n_local = labels.shape[0]
    s_local = (-gather_label_scores(out[:n_local], labels) * m).sum()
    s_local.backward()
    loss, count = all_reduce_gradients(model.replicated_parameters(),
                                       s_local, m.sum(), model.group)
    for p in model.embedding_parameters():
        p.grad = (p.grad if p.grad is not None else torch.zeros_like(p)) \
            / count
    optimizer.step()
    return loss


@torch.no_grad()
def partitioned_rmag_eval(model: DistributedREGCNet, hg,
                          send_idx: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Eval-mode log-probabilities of the target type's ``[n_ext, C]`` rows
    of this rank (the owned rows valid)."""
    model.eval()
    return model(hg, send_idx)


def gathered_embedding_grads(model: DistributedREGCNet
                             ) -> Dict[str, torch.Tensor]:
    """Each embedding's gradient gathered to its full table (a
    collective): what a single-device step's ``embs.{t}.grad`` holds."""
    return {t: model.gather_rows(t, model.embs[t].grad)
            for t in model.featureless_types}
