"""JAX variables -> the port's state dict (counterpart of
``egc_tpu.exp.weight_port``).

``arxiv_state_dict_from_jax`` and ``code_state_dict_from_jax`` apply the
arxiv and code rules of the JAX package's ``build_rules`` to a flax
``{"params", "batch_stats"}`` tree given as nested dicts of numpy arrays,
and return the reference-named state dict that ``ArxivNet`` /
``CodeNet.load_state_dict(strict=True)`` takes. The conv and BN rules are
shared; only their key prefixes differ (``convs.{i}.`` / ``bns.{i}.`` and
``graph_layers.{i}.0.`` / ``graph_layers.{i}.1.``):

- Dense ``kernel`` [in, out] -> Linear ``weight`` [out, in];
- EGConv ``bases.kernel`` [in, B*L] -> ``bases_weight.{b}`` [in, L];
  ``comb`` columns are in (h, b, a) order on both sides;
- GATConv ``lin.kernel`` [in, H*C] -> ``lin_src.weight`` [H*C, in] (the
  columns are in (h, c) order on both sides); ``att_src`` / ``att_dst``
  [H, C] -> [1, H, C]; ``bias`` as it is (``weight_port.py:186-203``);
- GATv2Conv ``lin_l.kernel`` [in, H*C] -> ``lin_l.weight`` [H*C, in] and
  ``lin_l.bias``, ``lin_r`` the same way, ``att`` [H, C] -> [1, H, C],
  ``bias`` as it is (``weight_port.py:204-211``). A conv built with
  ``share_weights`` has no ``lin_r`` in flax; its ``lin_l`` fills both
  keys, as the state dict of a module whose ``lin_r`` is ``lin_l`` holds;
- MaskedBatchNorm ``scale/bias`` and ``mean/var`` -> ``weight/bias`` and
  ``running_mean/running_var``, plus ``num_batches_tracked`` = 0;
- code: the ASTNodeEncoder's ``type`` / ``attr`` / ``depth`` embeddings and
  the fused ``token_predictors`` Dense, split into its 5 heads
  (``weight_port.py:346-384``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List

import numpy as np
import torch


def _module_indices(params: Dict[str, Any], cls: str) -> List[int]:
    out = []
    for k in params:
        if k == cls or k.startswith(cls + "_"):
            out.append(int(k[len(cls) + 1:]) if k != cls else 0)
    return sorted(out)


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _conv_rules(sd, params, conv_prefix, bases: int) -> None:
    """The EGC, GAT and GATv2 conv rules, shared by every family; conv i
    goes under ``conv_prefix(i)``."""
    for i in _module_indices(params, "EGConv"):
        p, tp = params[f"EGConv_{i}"], conv_prefix(i)
        for b, chunk in enumerate(np.split(np.asarray(p["bases"]["kernel"]),
                                           bases, axis=1)):
            sd[f"{tp}bases_weight.{b}"] = chunk
        sd[tp + "comb_weights.weight"] = _t(p["comb"]["kernel"])
        sd[tp + "comb_weights.bias"] = np.asarray(p["comb"]["bias"])
        sd[tp + "bias"] = np.asarray(p["bias"])
    for i in _module_indices(params, "GATConv"):
        p, tp = params[f"GATConv_{i}"], conv_prefix(i)
        sd[tp + "lin_src.weight"] = _t(p["lin"]["kernel"])
        sd[tp + "att_src"] = np.asarray(p["att_src"])[None]
        sd[tp + "att_dst"] = np.asarray(p["att_dst"])[None]
        sd[tp + "bias"] = np.asarray(p["bias"])
    for i in _module_indices(params, "GATv2Conv"):
        p, tp = params[f"GATv2Conv_{i}"], conv_prefix(i)
        for side in ("lin_l", "lin_r"):
            lin = p.get(side, p["lin_l"])
            sd[f"{tp}{side}.weight"] = _t(lin["kernel"])
            sd[f"{tp}{side}.bias"] = np.asarray(lin["bias"])
        sd[tp + "att"] = np.asarray(p["att"])[None]
        sd[tp + "bias"] = np.asarray(p["bias"])


def _batchnorm_rules(sd, params, stats, bn_prefix) -> None:
    for i in _module_indices(params, "MaskedBatchNorm"):
        name, tp = f"MaskedBatchNorm_{i}", bn_prefix(i)
        sd[tp + "weight"] = np.asarray(params[name]["scale"])
        sd[tp + "bias"] = np.asarray(params[name]["bias"])
        sd[tp + "running_mean"] = np.asarray(stats[name]["mean"])
        sd[tp + "running_var"] = np.asarray(stats[name]["var"])


def _finish(sd) -> "OrderedDict[str, torch.Tensor]":
    """BN bookkeeping keys (``num_batches_tracked`` = 0, appended as the
    JAX export appends them), then torch tensors."""
    for k in list(sd):
        if k.endswith("running_mean"):
            sd[k[:-len("running_mean")] + "num_batches_tracked"] = \
                np.asarray(0, np.int64)
    return OrderedDict(
        (k, torch.from_numpy(np.array(v))) for k, v in sd.items())


def arxiv_state_dict_from_jax(variables: Dict[str, Any], *, bases: int = 4
                              ) -> "OrderedDict[str, torch.Tensor]":
    """``bases``: the EGC convs' basis count (GAT and GATv2 read none)."""
    params = variables["params"]
    sd: "OrderedDict[str, np.ndarray]" = OrderedDict()
    _conv_rules(sd, params, lambda i: f"convs.{i}.", bases)
    _batchnorm_rules(sd, params, variables.get("batch_stats", {}),
                     lambda i: f"bns.{i}.")
    sd["embed.0.weight"] = _t(params["embed"]["kernel"])
    sd["embed.0.bias"] = np.asarray(params["embed"]["bias"])
    sd["out.weight"] = _t(params["out"]["kernel"])
    sd["out.bias"] = np.asarray(params["out"]["bias"])
    return _finish(sd)


def code_state_dict_from_jax(variables: Dict[str, Any], *, bases: int = 4
                             ) -> "OrderedDict[str, torch.Tensor]":
    """The JAX ``CodeNet``'s variables -> the state dict that the port's
    ``CodeNet.load_state_dict(strict=True)`` takes: conv i under
    ``graph_layers.{i}.0.`` and its BN under ``graph_layers.{i}.1.``; the
    ``type``, ``attr`` and ``depth`` embeddings as ``embedding.
    {type,attribute,depth}_encoder.weight``; the fused token Dense
    [h, S*(V+2)] split into ``token_predictors.{s}`` Linears."""
    params = variables["params"]
    sd: "OrderedDict[str, np.ndarray]" = OrderedDict()
    _conv_rules(sd, params, lambda i: f"graph_layers.{i}.0.", bases)
    _batchnorm_rules(sd, params, variables.get("batch_stats", {}),
                     lambda i: f"graph_layers.{i}.1.")
    emb = params["embedding"]
    for ours, theirs in (("type", "type_encoder"),
                         ("attr", "attribute_encoder"),
                         ("depth", "depth_encoder")):
        sd[f"embedding.{theirs}.weight"] = np.asarray(emb[ours]["embedding"])
    tp = params["token_predictors"]     # 5 heads (code/models.py:95-98)
    for s, w in enumerate(np.split(np.asarray(tp["kernel"]), 5, 1)):
        sd[f"token_predictors.{s}.weight"] = _t(w)
    for s, b in enumerate(np.split(np.asarray(tp["bias"]), 5)):
        sd[f"token_predictors.{s}.bias"] = b
    return _finish(sd)
