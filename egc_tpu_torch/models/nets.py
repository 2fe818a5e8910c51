"""Task networks (counterpart of ``egc_tpu.models.nets``).

``ArxivNet`` (full graph) and ``CodeNet`` (batched ogbg-code2) take every
kind of conv the JAX package has: ``ConvSpec`` builds all nine.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from egc_tpu_torch.nn.conv.attention import GATConv, GATv2Conv
from egc_tpu_torch.nn.conv.egc import EGConv
from egc_tpu_torch.nn.conv.mpnn import MPNNConv
from egc_tpu_torch.nn.conv.pna import PNAConv
from egc_tpu_torch.nn.conv.simple import GCNConv, GINConv, SAGEConv
from egc_tpu_torch.nn.mlp import linear
from egc_tpu_torch.models.encoders import ASTNodeEncoder
from egc_tpu_torch.nn.norm import MaskedBatchNorm
from egc_tpu_torch.nn.pool import global_mean_pool

SEQ_LEN = 5    # CodeNet's token positions (reference code/models.py:95-98)

MODEL_KINDS = ("gcn", "gat", "gatv2", "gin", "mpnn-sum", "mpnn-max", "pna",
               "sage", "egc")


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """What builds one graph layer (``egc_tpu`` ``ConvSpec``)."""

    kind: str
    heads: int = 8
    bases: int = 4
    softmax: bool = False
    sigmoid: bool = False
    hardtanh: bool = False
    aggrs: Optional[Tuple[str, ...]] = None
    self_loop_mode: str = "paper"     # EGC only
    avg_log_deg: float = 0.0          # PNA only (the dataset's degrees)

    def build(self, in_dim: int, out_dim: int, *, layer_idx: int,
              num_layers: int, generator: Optional[torch.Generator] = None,
              device=None) -> nn.Module:
        if self.kind == "egc":
            if not self.aggrs:
                raise ValueError("EGC requires aggrs")
            weighting = ("softmax" if self.softmax else
                         "sigmoid" if self.sigmoid else
                         "hardtanh" if self.hardtanh else "none")
            return EGConv(in_dim, out_dim, num_heads=self.heads,
                          num_bases=self.bases, aggrs=self.aggrs,
                          weighting=weighting,
                          self_loop_mode=self.self_loop_mode,
                          generator=generator, device=device)
        if self.kind in ("gat", "gatv2"):
            # the last layer is single-head (reference
            # arxiv/norm_models.py:79-82, egc_tpu/models/nets.py:69-75)
            h = self.heads if layer_idx != num_layers - 1 else 1
            if out_dim % h:
                raise ValueError(f"GAT width {out_dim} is not a multiple of "
                                 f"{h} heads")
            ctor = GATConv if self.kind == "gat" else GATv2Conv
            return ctor(in_dim, out_dim // h, heads=h, generator=generator,
                        device=device)
        kw = dict(generator=generator, device=device)
        if self.kind == "gcn":
            return GCNConv(in_dim, out_dim, **kw)
        if self.kind == "gin":
            # GINConv(nn.Linear(h, h), train_eps=True): reference
            # arxiv/norm_models.py:95 (the JAX package's MLP([out]))
            return GINConv(linear(in_dim, out_dim, **kw), device=device)
        if self.kind == "sage":
            return SAGEConv(in_dim, out_dim, **kw)
        if self.kind in ("mpnn-sum", "mpnn-max"):
            return MPNNConv(in_dim, out_dim, aggr=self.kind[len("mpnn-"):],
                            **kw)
        if self.kind == "pna":
            return PNAConv(in_dim, out_dim, avg_log_deg=self.avg_log_deg,
                           **kw)
        raise ValueError(f"unknown model kind {self.kind!r}; supported "
                         f"{MODEL_KINDS}")


class ArxivNet(nn.Module):
    """Linear(128) -> L x [conv, masked BN, ReLU, dropout, +residual] ->
    Linear(40) -> log-softmax (or raw logits with ``log_probs=False``).

    Submodules carry the reference's names: ``embed.0``, ``convs.{i}``,
    ``bns.{i}``, ``out``. Dropout draws from the ``generator`` passed to
    ``forward`` and is active in training mode only.
    """

    def __init__(self, conv: ConvSpec, hidden_dim: int, *,
                 num_layers: int = 3, dropout: float = 0.5,
                 num_features: int = 128, num_classes: int = 40,
                 log_probs: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dropout = dropout
        self.log_probs = log_probs
        self.embed = nn.Sequential(
            linear(num_features, hidden_dim, generator=generator,
                   device=device))
        self.convs = nn.ModuleList()
        self.bns = nn.ModuleList()
        for i in range(num_layers):
            self.convs.append(conv.build(hidden_dim, hidden_dim, layer_idx=i,
                                         num_layers=num_layers,
                                         generator=generator, device=device))
            self.bns.append(MaskedBatchNorm(hidden_dim, device=device))
        self.out = linear(hidden_dim, num_classes, generator=generator,
                          device=device)

    def forward(self, g, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.embed(g.nodes)
        for conv, bn in zip(self.convs, self.bns):
            identity = x
            x = conv(g, x)
            x = torch.relu(bn(x, g.node_mask))
            if self.training and self.dropout > 0:
                keep = torch.rand(x.shape, generator=generator,
                                  device=x.device) >= self.dropout
                x = x * keep / (1.0 - self.dropout)
            x = x + identity
        x = self.out(x)
        return torch.log_softmax(x, dim=-1) if self.log_probs else x


class CodeNet(nn.Module):
    """ogbg-code2: ASTNodeEncoder -> L x [conv, masked BN, ReLU, +residual]
    -> mean pool -> 5 token heads; returns ``[G, 5, vocab_size + 2]``
    logits (``egc_tpu.models.nets.CodeNet`` as every config of the JAX
    package builds it: no input dropout, residual, mean readout; reference
    ``experiments/code/models.py:48-125``, whose per-position list is
    stacked here).

    Submodules carry the reference's names: ``embedding.{type,attribute,
    depth}_encoder``, ``graph_layers.{i}.0`` (the conv) and
    ``graph_layers.{i}.1`` (the BN), ``token_predictors.{s}``.
    """

    def __init__(self, conv: ConvSpec, hidden_dim: int, *,
                 num_layers: int = 4, vocab_size: int = 5000,
                 num_nodeattributes: int = 10030,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.embedding = ASTNodeEncoder(
            hidden_dim, num_nodeattributes=num_nodeattributes,
            generator=generator, device=device)
        self.graph_layers = nn.ModuleList(
            nn.ModuleList([conv.build(hidden_dim, hidden_dim, layer_idx=i,
                                      num_layers=num_layers,
                                      generator=generator, device=device),
                           MaskedBatchNorm(hidden_dim, device=device)])
            for i in range(num_layers))
        self.token_predictors = nn.ModuleList(
            linear(hidden_dim, vocab_size + 2, generator=generator,
                   device=device)
            for _ in range(SEQ_LEN))

    def forward(self, g) -> torch.Tensor:
        x = self.embedding(g.nodes[:, :2], g.nodes[:, 2])   # (type, attr)
        for conv, bn in self.graph_layers:
            x = torch.relu(bn(conv(g, x), g.node_mask)) + x
        pooled = global_mean_pool(x, g.graph_ids, g.num_graphs, g.node_mask)
        return torch.stack([head(pooled) for head in self.token_predictors],
                           dim=1)
