"""Input feature encoders of the batched task nets (counterpart of
``egc_tpu.models.encoders``).

- ``AtomEncoder``: the OGB molecule atom encoder, one embedding table per
  categorical atom feature (cardinalities ``ATOM_FEATURE_DIMS``), summed;
  glorot-uniform tables, submodules ``atom_embedding_list.{i}`` as in
  ``ogb.graphproppred.mol_encoder``.
- ``ASTNodeEncoder``: the ogbg-code2 AST node encoder, type + attribute +
  clamped-depth embeddings summed (reference
  ``experiments/code/models.py:27-45``), N(0, 1) tables named
  ``type_encoder``, ``attribute_encoder`` and ``depth_encoder``.

Tables are drawn from the CPU ``generator`` and follow the module to its
device.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from egc_tpu_torch.nn import init as einit

# ogb.utils.features.get_atom_feature_dims(): cardinalities of the 9
# categorical atom features of the OGB molecule datasets
ATOM_FEATURE_DIMS = (119, 4, 12, 12, 10, 6, 6, 2, 2)
NUM_NODETYPES = 98     # ogbg-code2 AST node types (reference code/utils.py)
MAX_DEPTH = 20         # depths past it share the last depth embedding


class AtomEncoder(nn.Module):
    def __init__(self, emb_dim: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.atom_embedding_list = nn.ModuleList(
            nn.Embedding(dim, emb_dim, device=device)
            for dim in ATOM_FEATURE_DIMS)
        for emb in self.atom_embedding_list:
            einit.glorot_uniform_(emb.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, 9] int -> [N, emb_dim]."""
        out = 0
        for i, emb in enumerate(self.atom_embedding_list):
            out = out + emb(x[:, i])
        return out


class ASTNodeEncoder(nn.Module):
    def __init__(self, emb_dim: int, *, num_nodeattributes: int = 10030,
                 generator: Optional[torch.Generator] = None, device=None):
        """``num_nodeattributes``: 10030 for ogbg-code2, 500 for the
        synthetic stand-in."""
        super().__init__()
        self.type_encoder = nn.Embedding(NUM_NODETYPES, emb_dim,
                                         device=device)
        self.attribute_encoder = nn.Embedding(num_nodeattributes, emb_dim,
                                              device=device)
        self.depth_encoder = nn.Embedding(MAX_DEPTH + 1, emb_dim,
                                          device=device)
        for emb in (self.type_encoder, self.attribute_encoder,
                    self.depth_encoder):
            einit.normal_embedding_(emb.weight, generator)

    def forward(self, x: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """x: [N, 2] int (type, attribute); depth: [N] int ->
        [N, emb_dim]."""
        depth = torch.clamp(depth, max=MAX_DEPTH)
        return (self.type_encoder(x[:, 0]) + self.attribute_encoder(x[:, 1])
                + self.depth_encoder(depth))
