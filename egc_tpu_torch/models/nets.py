"""Task networks (counterpart of ``egc_tpu.models.nets``).

``ArxivNet`` and ``MagNet`` (full graph), and ``ZincNet``, ``CifarNet``,
``HIVNet`` and ``CodeNet`` (batched): ``ConvSpec`` builds every kind of
conv the JAX package has. Submodules carry the names of the reference's
nets, so its state dicts load as they are. Dropout draws from the
``generator`` passed to ``forward`` and is active in training mode only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from egc_tpu_torch.nn.conv.attention import GATConv, GATv2Conv
from egc_tpu_torch.nn.conv.egc import EGConv, OptimizedEGConv
from egc_tpu_torch.nn.conv.mpnn import MPNNConv
from egc_tpu_torch.nn.conv.pna import PNAConv
from egc_tpu_torch.nn.conv.simple import GCNConv, GINConv, SAGEConv
from egc_tpu_torch.nn import init as einit
from egc_tpu_torch.nn.mlp import MLP, linear
from egc_tpu_torch.models.encoders import ASTNodeEncoder, AtomEncoder
from egc_tpu_torch.nn.norm import MaskedBatchNorm
from egc_tpu_torch.nn.pool import get_pool, global_mean_pool
from egc_tpu_torch.utils.profiling import span

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


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout whose keep mask draws from ``generator``."""
    if not training or p <= 0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep / (1.0 - p)


class Dropout(nn.Module):
    """``dropout`` as a parameter-free module: it holds the slot of the
    reference's ``nn.Dropout`` in a layer list."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, generator=None):
        return dropout(x, self.p, self.training, generator)


class _GraphLevelNet(nn.Module):
    """The batched nets' template (``egc_tpu`` ``ZincNet`` / ``CifarNet`` /
    ``HIVNet``): ``embedding``, ``in_feat_drop``, ``num_layers`` x [conv,
    masked BN, ReLU, + residual] in ``graph_layers.{i}`` (conv at
    ``conv_slot``, BN after it), the ``readout`` pool over the real nodes,
    then ``mlp``, ``MLP([h/2, h/4, out])`` with its BatchNorms over the
    real graphs. A subclass sets ``embedding`` and ``embed``."""

    conv_slot = 0

    def __init__(self, conv: ConvSpec, hidden_dim: int, out_dim: int, *,
                 num_layers: int, in_feat_drop: float, readout: str,
                 generator, device):
        super().__init__()
        self.in_feat_drop = in_feat_drop
        self.pool = get_pool(readout)
        self.graph_layers = nn.ModuleList(
            nn.ModuleList(self._lead(i) + [
                conv.build(hidden_dim, hidden_dim, layer_idx=i,
                           num_layers=num_layers, generator=generator,
                           device=device),
                MaskedBatchNorm(hidden_dim, device=device)])
            for i in range(num_layers))
        h = hidden_dim
        self.mlp = MLP(h, [h // 2, h // 4, out_dim], generator=generator,
                       device=device)

    def _lead(self, i: int) -> list:
        return []

    def embed(self, nodes: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, g, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(self.embed(g.nodes), self.in_feat_drop, self.training,
                    generator)
        for layer in self.graph_layers:
            identity = x
            for lead in layer[:self.conv_slot]:
                x = lead(x, generator)
            conv, bn = layer[self.conv_slot:]
            x = torch.relu(bn(conv(g, x), g.node_mask)) + identity
        pooled = self.pool(x, g.graph_ids, g.num_graphs, g.node_mask)
        return self.mlp(pooled, g.graph_mask)


class ZincNet(_GraphLevelNet):
    """ZINC: an N(0, 1) ``embedding`` of the 28 atom types, one output
    (reference ``zinc/models.py:17-135``)."""

    def __init__(self, conv: ConvSpec, hidden_dim: int, *,
                 num_layers: int = 4, in_feat_drop: float = 0.0,
                 readout: str = "mean", num_features: int = 28,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(conv, hidden_dim, 1, num_layers=num_layers,
                         in_feat_drop=in_feat_drop, readout=readout,
                         generator=generator, device=device)
        self.embedding = nn.Embedding(num_features, hidden_dim,
                                      device=device)
        einit.normal_embedding_(self.embedding.weight, generator)

    def embed(self, nodes):
        return self.embedding(nodes.reshape(-1))


class CifarNet(_GraphLevelNet):
    """CIFAR10 superpixels: a Linear ``embedding`` of the 5 features,
    ``dropout`` before each conv (``graph_layers.{i}.0``, so the conv and
    BN sit at ``.1`` / ``.2``), 10 outputs (reference
    ``cifar/models.py:18-130``)."""

    conv_slot = 1

    def __init__(self, conv: ConvSpec, hidden_dim: int, *,
                 num_layers: int = 4, dropout: float = 0.0,
                 readout: str = "mean", num_features: int = 5,
                 num_classes: int = 10,
                 generator: Optional[torch.Generator] = None, device=None):
        self.dropout = dropout
        super().__init__(conv, hidden_dim, num_classes,
                         num_layers=num_layers, in_feat_drop=0.0,
                         readout=readout, generator=generator, device=device)
        self.embedding = linear(num_features, hidden_dim,
                                generator=generator, device=device)

    def _lead(self, i):
        return [Dropout(self.dropout)]

    def embed(self, nodes):
        return self.embedding(nodes)


class HIVNet(_GraphLevelNet):
    """ogbg-molhiv: an ``AtomEncoder`` ``embedding``, ``in_feat_drop`` once
    after it, one logit (reference ``mol/pna_style_models.py:21-207``)."""

    def __init__(self, conv: ConvSpec, hidden_dim: int, *,
                 num_layers: int = 4, in_feat_drop: float = 0.0,
                 readout: str = "mean",
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(conv, hidden_dim, 1, num_layers=num_layers,
                         in_feat_drop=in_feat_drop, readout=readout,
                         generator=generator, device=device)
        self.embedding = AtomEncoder(hidden_dim, generator=generator,
                                     device=device)

    def embed(self, nodes):
        return self.embedding(nodes)


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
        with span("egc.embed"):
            x = self.embed(g.nodes)
        for conv, bn in zip(self.convs, self.bns):
            identity = x
            with span("egc.conv"):
                x = conv(g, x)
            x = bn(x, g.node_mask)
            with span("egc.pointwise"):
                x = torch.relu(x)
                x = dropout(x, self.dropout, self.training, generator)
                x = x + identity
        with span("egc.head"):
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

    def forward(self, g, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: unused (no dropout), the batched nets' signature."""
        x = self.embedding(g.nodes[:, :2], g.nodes[:, 2])   # (type, attr)
        for conv, bn in self.graph_layers:
            x = torch.relu(bn(conv(g, x), g.node_mask)) + x
        pooled = global_mean_pool(x, g.graph_ids, g.num_graphs, g.node_mask)
        return torch.stack([head(pooled) for head in self.token_predictors],
                           dim=1)


class MagNet(nn.Module):
    """Homogeneous ogbn-mag (reference ``mag/models.py``): ``num_layers``
    ``OptimizedEGConv`` layers (self-loops for every aggregator) at
    ``convs.{i}``, ReLU and dropout between them, no BatchNorm; the last
    emits ``out_rounded`` = 352 columns (a multiple of the heads), cut to
    the 349 classes before the log-softmax (raw logits with
    ``log_probs=False``)."""

    def __init__(self, hidden_dim: int, *, num_layers: int = 3,
                 dropout: float = 0.5, heads: int = 8, bases: int = 4,
                 aggrs: Tuple[str, ...] = ("symnorm",),
                 num_features: int = 128, out_rounded: int = 352,
                 out_true: int = 349, log_probs: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dropout = dropout
        self.out_true = out_true
        self.log_probs = log_probs
        dims = [num_features] + [hidden_dim] * (num_layers - 1) \
            + [out_rounded]
        self.convs = nn.ModuleList(
            OptimizedEGConv(dims[i], dims[i + 1], num_heads=heads,
                            num_bases=bases, aggrs=aggrs,
                            generator=generator, device=device)
            for i in range(num_layers))

    def forward(self, g, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = g.nodes
        for i, conv in enumerate(self.convs):
            with span("egc.conv"):
                x = conv(g, x)
            if i < len(self.convs) - 1:
                with span("egc.pointwise"):
                    x = dropout(torch.relu(x), self.dropout, self.training,
                                generator)
        with span("egc.head"):
            x = x[:, :self.out_true]
            return torch.log_softmax(x, dim=-1) if self.log_probs else x
