"""Heterogeneous relational convolutions: RGCN and relational EGC (REGC)
(counterpart of ``egc_tpu.nn.conv.hetero``; reference
``experiments/rmag/models.py:32-212``).

- ``RGCNConv``: out[t] = root_lins[t](x_t) + sum over the relations
  (s, r, t), in sorted key order, of rel_lins[s_r_t](mean of x_s over the
  relation's edges).
- ``REGConv``: one bases weight shared by every type; per type a root
  head mix of its own bases with weights ``root_combs[t](x_t)`` [N, H*B];
  per relation {mean, max} of the source bases, stacked aggregator-major
  (k = a*B + b), mixed with destination weights ``rel_combs[s_r_t](x_t)``
  [N, H*A*B]. Each combination z[n, h*L+l] = sum_k w[n, h*K+k] y[n, k*L+l]
  is ``head_mix_fused`` at A = 1 (kernels 3 and 4 on a CUDA tensor, the
  plain version on a CPU one: the JAX package's einsum fallback is not
  used).
- ``REGCNet``: learned embeddings ``embs[t]`` (glorot, the padded row
  count) for featureless types, (L-1) REGConv (RGCNConv with
  ``use_egc=False``) with ReLU and dropout, a final RGCNConv to the
  classes, ``log_softmax`` of the target type.

Parameter names are the reference's torch ones that
``egc_tpu/exp/weight_port.py:387-430`` writes (a relation key
"src__rel__dst" becomes "src_rel_dst"), so a ported state dict loads
with ``strict=True``.

Per relation, ``_rel_multi_aggregate`` runs ``ops.dispatch.
bipartite_multi_aggregate`` over the relation's kernel plan on a CUDA
tensor (no plan: it raises), and the masked segment ops on a CPU tensor.
A partition's plan covers its owned destination rows only
(``parallel/hetero_partition.py``): the output is zero-padded to the
extended rows, whose values the next halo refresh replaces.

A conv computes only the output types it is asked for (``out_types``);
``REGCNet`` asks each layer for the types the target's output reads,
which is all that reaches the loss: the work ``jax.jit`` keeps of the JAX
net. The parameters of the outputs left out get no gradient from the
loss (the JAX package gives them zeros).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import torch
from torch import nn

from egc_tpu_torch.graph.hetero import HeteroGraph, split_rel_key
from egc_tpu_torch.models.nets import dropout
from egc_tpu_torch.nn import init as einit
from egc_tpu_torch.ops.cuda.headmix import head_mix_fused
from egc_tpu_torch.ops.dispatch import bipartite_multi_aggregate
from egc_tpu_torch.ops.segment import segment_max, segment_mean


def torch_rel_key(key: str) -> str:
    """"src__rel__dst" -> the reference's "src_rel_dst"."""
    return "_".join(split_rel_key(key))


def _rel_multi_aggregate(hg: HeteroGraph, key: str, x_src: torch.Tensor,
                         n_dst: int, aggrs: Sequence[str]) -> torch.Tensor:
    """Aggregation of source rows into the destination rows of relation
    ``key``: ``[n_dst, A, F]`` (an empty row gives 0)."""
    if x_src.device.type == "cpu":
        fns = {"mean": segment_mean, "max": segment_max}
        gathered = x_src.index_select(0, hg.senders[key].long())
        return torch.stack([fns[a](gathered, hg.receivers[key], n_dst,
                                   mask=hg.edge_mask[key]) for a in aggrs],
                           dim=1)
    plan = (hg.kernel_plans or {}).get(key)
    if plan is None:
        raise RuntimeError(
            f"relation {key!r} on a CUDA tensor needs a kernel plan "
            "(graph.hetero.attach_hetero_kernel_plans)")
    return bipartite_multi_aggregate(x_src, plan, aggrs, num_dst=n_dst)


def _out_types(x_dict, out_types) -> List[str]:
    return sorted(x_dict if out_types is None else out_types)


class RGCNConv(nn.Module):
    def __init__(self, in_channels: Dict[str, int], out_channels: int,
                 relations: Iterable[str], *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.relations = sorted(relations)
        self.root_lins = nn.ModuleDict({
            t: nn.Linear(in_channels[t], out_channels, device=device)
            for t in sorted(in_channels)})
        self.rel_lins = nn.ModuleDict({
            torch_rel_key(k): nn.Linear(in_channels[split_rel_key(k)[0]],
                                        out_channels, bias=False,
                                        device=device)
            for k in self.relations})
        for lin in list(self.root_lins.values()) + \
                list(self.rel_lins.values()):
            einit.torch_linear_(lin, generator)

    def forward(self, hg: HeteroGraph, x_dict: Dict[str, torch.Tensor], *,
                out_types: Optional[Iterable[str]] = None):
        types = _out_types(x_dict, out_types)
        out = {t: self.root_lins[t](x_dict[t]) for t in types}
        for key in self.relations:
            src, _, dst = split_rel_key(key)
            if dst not in out:
                continue
            agg = _rel_multi_aggregate(hg, key, x_dict[src],
                                       hg.num_nodes(dst), ("mean",))[:, 0]
            out[dst] = out[dst] + self.rel_lins[torch_rel_key(key)](agg)
        return out


class REGConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 node_types: Iterable[str], relations: Iterable[str], *,
                 num_heads: int = 4, num_bases: int = 4,
                 aggrs: Sequence[str] = ("mean", "max"),
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if out_channels % num_heads:
            raise ValueError("out_channels must divide num_heads")
        self.H, self.B, self.A = num_heads, num_bases, len(aggrs)
        self.L = out_channels // num_heads
        self.aggrs = tuple(aggrs)
        self.relations = sorted(relations)
        H, B, A, L = self.H, self.B, self.A, self.L
        self.bases_weight = nn.Parameter(
            torch.empty(in_channels, B * L, device=device))
        einit.glorot_uniform_(self.bases_weight, generator)
        self.root_combs = nn.ModuleDict({
            t: nn.Linear(in_channels, H * B, device=device)
            for t in sorted(node_types)})
        self.rel_combs = nn.ModuleDict({
            torch_rel_key(k): nn.Linear(in_channels, A * H * B,
                                        device=device)
            for k in self.relations})
        for lin in list(self.root_combs.values()) + \
                list(self.rel_combs.values()):
            einit.torch_linear_(lin, generator)

    def _mix(self, w2d: torch.Tensor, y2d: torch.Tensor, K: int):
        """z[n, h*L+l] = sum_k w2d[n, h*K+k] * y2d[n, k*L+l] -> [n, H*L]."""
        return head_mix_fused(w2d, (y2d,), H=self.H, B=K, A=1, L=self.L)

    def forward(self, hg: HeteroGraph, x_dict: Dict[str, torch.Tensor], *,
                out_types: Optional[Iterable[str]] = None):
        types = _out_types(x_dict, out_types)
        rels = [k for k in self.relations if split_rel_key(k)[2] in types]
        used = sorted(set(types) | {split_rel_key(k)[0] for k in rels})
        bases = {t: x_dict[t] @ self.bases_weight for t in used}
        out = {t: self._mix(self.root_combs[t](x_dict[t]), bases[t],
                            self.B) for t in types}
        for key in rels:
            src, _, dst = split_rel_key(key)
            n_dst = hg.num_nodes(dst)
            agg = _rel_multi_aggregate(hg, key, bases[src], n_dst,
                                       self.aggrs)
            w = self.rel_combs[torch_rel_key(key)](x_dict[dst])
            out[dst] = out[dst] + self._mix(
                w, agg.reshape(n_dst, self.A * self.B * self.L),
                self.A * self.B)
        return out


class REGCNet(nn.Module):
    """The rmag net (reference ``REGC``, rmag/models.py:151-212, its
    constructor bug fixed) over the schema of one hetero graph:
    ``node_types``, ``relations`` and each featureless type's padded row
    count ``num_nodes``."""

    def __init__(self, hidden_dim: int, *, node_types: Sequence[str],
                 relations: Sequence[str], num_nodes: Dict[str, int],
                 num_layers: int = 2, dropout: float = 0.5,
                 use_egc: bool = True, heads: int = 8, bases: int = 4,
                 num_classes: int = 349, in_features: int = 128,
                 featureless_types: Sequence[str] = (),
                 target_type: str = "paper",
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.node_types = sorted(node_types)
        self.relations = sorted(relations)
        self.featureless_types = tuple(sorted(featureless_types))
        self.dropout = dropout
        self.target_type = target_type
        self.embs = nn.ParameterDict()
        for t in self.featureless_types:
            self.embs[t] = nn.Parameter(torch.empty(
                num_nodes[t], in_features, device=device))
            einit.glorot_uniform_(self.embs[t], generator)
        convs = []
        width = in_features
        for _ in range(num_layers - 1):
            convs.append(
                REGConv(width, hidden_dim, self.node_types, self.relations,
                        num_heads=heads, num_bases=bases,
                        generator=generator, device=device) if use_egc
                else RGCNConv({t: width for t in self.node_types},
                              hidden_dim, self.relations,
                              generator=generator, device=device))
            width = hidden_dim
        convs.append(RGCNConv({t: width for t in self.node_types},
                              num_classes, self.relations,
                              generator=generator, device=device))
        self.convs = nn.ModuleList(convs)

    def layer_out_types(self) -> List[List[str]]:
        """The types each layer computes: the target at the last, and
        before a layer the types it reads (its outputs and the sources of
        the relations into them)."""
        need = [[self.target_type]]
        for _ in range(len(self.convs) - 1):
            types = set(need[0])
            types |= {split_rel_key(k)[0] for k in self.relations
                      if split_rel_key(k)[2] in need[0]}
            need.insert(0, sorted(types))
        return need

    def forward(self, hg: HeteroGraph, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = {t: self.embs[t] if t in self.featureless_types else hg.nodes[t]
             for t in hg.node_types}
        need = self.layer_out_types()
        for conv, types in zip(self.convs[:-1], need):
            x = conv(hg, x, out_types=types)
            x = {t: dropout(torch.relu(v), self.dropout, self.training,
                            generator) for t, v in sorted(x.items())}
        x = self.convs[-1](hg, x, out_types=need[-1])
        return torch.log_softmax(x[self.target_type], dim=-1)
