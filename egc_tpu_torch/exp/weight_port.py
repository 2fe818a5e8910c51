"""JAX variables -> the port's state dict (counterpart of
``egc_tpu.exp.weight_port``).

``arxiv_state_dict_from_jax``, ``batched_state_dict_from_jax`` (zinc,
cifar, hiv, code), ``mag_state_dict_from_jax`` and
``rmag_state_dict_from_jax`` apply the rules of the
JAX package's ``build_rules`` to a flax ``{"params", "batch_stats"}`` tree
given as nested dicts of numpy arrays, and return the reference-named
state dict, key for key and in order ``export_model_state``'s, that the
port's net takes with ``load_state_dict(strict=True)``. The conv and BN
rules are shared; only their key prefixes differ (``convs.{i}.`` /
``bns.{i}.``; ``graph_layers.{i}.0.`` / ``.1.``, cifar's ``.1.`` / ``.2.``
behind its per-layer dropout):

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
- GCNConv ``lin.kernel`` -> ``lin.weight`` (no bias), ``bias`` as it
  is; GINConv ``eps`` as it is, and its net, the sibling ``MLP_{i}``'s
  ``Dense_0`` (the JAX package builds the conv's Linear in the net's
  scope, ``weight_port.py:212-214``), -> ``nn.weight`` / ``nn.bias``;
  SAGEConv ``lin_l`` (with bias) and ``lin_r`` (without);
- MPNNConv ``msg_kernel`` / ``upd_kernel`` [T, in, out] and their biases
  [T, out] -> one Linear a tower, ``message_layer.{t}`` /
  ``update_layer.{t}``, then ``lin``; PNAConv ``pre_kernel`` /
  ``post_kernel`` the same way to ``pre_nns.{t}.0`` / ``post_nns.{t}.0``
  (``weight_port.py:158-172``), then ``lin``;
- MaskedBatchNorm ``scale/bias`` and ``mean/var`` -> ``weight/bias`` and
  ``running_mean/running_var``, plus ``num_batches_tracked`` = 0;
- the batched readout ``MLP_{m}`` (``Dense_k`` -> ``mlp.{4k}.``, its
  ``MaskedBatchNorm_k`` -> ``mlp.{4k+1}.``), then the embedding: zinc's
  ``embedding.weight``, cifar's Linear, hiv's AtomEncoder tables
  ``embedding.atom_embedding_list.{i}.weight``; code: the ASTNodeEncoder's
  ``type`` / ``attr`` / ``depth`` embeddings and the fused
  ``token_predictors`` Dense, split into its 5 heads
  (``weight_port.py:234-243, 335-384``);
- mag: the optimized EGConv (``weight_port.py:139-155``): ``bases.kernel``
  as ``bases_weight`` [in, B*L], the ``comb`` columns taken from (h, b, a)
  to the reference's aggregator-major (h, a*B + b) order
  (``nn.conv.egc.comb_perm``), ``bias``; no BatchNorm.
- ``restore_pretrained_pt`` (``weight_port.py:507-542``) restores a
  reference ``checkpoint.pt`` for evaluation: the port's modules carry
  the reference's names and layouts (the EGConv ``comb`` order, the
  optimized EGConv's aggregator-major ``comb_weight``), so it is a
  ``torch.load`` into ``load_state_dict(strict=True)``.
- rmag (``rmag_state_dict_from_jax``, ``weight_port.py:387-430``):
  ``emb_{t}`` -> ``embs.{t}``; REGConv i's ``bases.kernel`` as
  ``convs.{i}.bases_weight``, ``root_comb_{t}`` -> ``root_combs.{t}``,
  ``rel_comb_{key}`` -> ``rel_combs.{src_rel_dst}``; RGCNConv's
  ``root_{t}`` -> ``root_lins.{t}`` and ``rel_{key}`` -> ``rel_lins.
  {src_rel_dst}`` (no bias), the final one after the REGConvs.
  ``partitioned_rmag_state_dict_from_jax`` takes JAX's partitioned state
  (its ``params`` and ``batch_stats["emb"]``, each embedding's stacked
  ``[P, n_local, F]`` rows), gathers each table through the plan, and
  applies the same rules.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from egc_tpu_torch.nn.conv.egc import comb_perm
from egc_tpu_torch.nn.conv.hetero import torch_rel_key


def _module_indices(params: Dict[str, Any], cls: str) -> List[int]:
    out = []
    for k in params:
        if k == cls or k.startswith(cls + "_"):
            out.append(int(k[len(cls) + 1:]) if k != cls else 0)
    return sorted(out)


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


CONV_MODULE = {"gcn": "GCNConv", "gat": "GATConv", "gatv2": "GATv2Conv",
               "gin": "GINConv", "sage": "SAGEConv", "mpnn-sum": "MPNNConv",
               "mpnn-max": "MPNNConv", "pna": "PNAConv", "egc": "EGConv"}


def _linear(sd, tp, p, bias=True) -> None:
    sd[tp + "weight"] = _t(p["kernel"])
    if bias:
        sd[tp + "bias"] = np.asarray(p["bias"])


def _towers(sd, kernel, bias, tower_prefix) -> None:
    """[T, in, out] kernel and [T, out] bias -> one Linear a tower at
    ``tower_prefix(t)``: every weight, then every bias (the JAX export's
    order)."""
    kernel, bias = np.asarray(kernel), np.asarray(bias)
    for t in range(kernel.shape[0]):
        sd[tower_prefix(t) + "weight"] = _t(kernel[t])
    for t in range(kernel.shape[0]):
        sd[tower_prefix(t) + "bias"] = bias[t]


def _conv_rules(sd, params, conv_prefix, bases: int) -> None:
    """The conv rules of every kind, shared by every family; conv i goes
    under ``conv_prefix(i)``."""
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
    for i in _module_indices(params, "GCNConv"):
        p, tp = params[f"GCNConv_{i}"], conv_prefix(i)
        _linear(sd, tp + "lin.", p["lin"], bias=False)
        sd[tp + "bias"] = np.asarray(p["bias"])
    for i in _module_indices(params, "GINConv"):
        sd[conv_prefix(i) + "eps"] = np.asarray(params[f"GINConv_{i}"]["eps"])
    for i in _module_indices(params, "SAGEConv"):
        p, tp = params[f"SAGEConv_{i}"], conv_prefix(i)
        _linear(sd, tp + "lin_l.", p["lin_l"])
        _linear(sd, tp + "lin_r.", p["lin_r"], bias=False)
    for i in _module_indices(params, "MPNNConv"):
        p, tp = params[f"MPNNConv_{i}"], conv_prefix(i)
        _towers(sd, p["msg_kernel"], p["msg_bias"],
                lambda t: f"{tp}message_layer.{t}.")
        _towers(sd, p["upd_kernel"], p["upd_bias"],
                lambda t: f"{tp}update_layer.{t}.")
        _linear(sd, tp + "lin.", p["lin"])
    for i in _module_indices(params, "PNAConv"):
        p, tp = params[f"PNAConv_{i}"], conv_prefix(i)
        _towers(sd, p["pre_kernel"], p["pre_bias"],
                lambda t: f"{tp}pre_nns.{t}.0.")
        _towers(sd, p["post_kernel"], p["post_bias"],
                lambda t: f"{tp}post_nns.{t}.0.")
        _linear(sd, tp + "lin.", p["lin"])


def _gin_net_rules(sd, params, conv_prefix) -> None:
    """GIN conv i's Linear: the sibling ``MLP_{i}``'s ``Dense_0``, after
    the BatchNorms as in the JAX export."""
    for i in _module_indices(params, "GINConv"):
        _linear(sd, conv_prefix(i) + "nn.", params[f"MLP_{i}"]["Dense_0"])


def _check_kind(params, kind: Optional[str]) -> None:
    if kind is None:
        return
    if kind not in CONV_MODULE:
        raise ValueError(f"unknown model kind {kind!r}")
    if not _module_indices(params, CONV_MODULE[kind]):
        raise ValueError(f"the variables hold no {CONV_MODULE[kind]} for "
                         f"kind {kind!r}")


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


def arxiv_state_dict_from_jax(variables: Dict[str, Any], *,
                              kind: Optional[str] = None, bases: int = 4
                              ) -> "OrderedDict[str, torch.Tensor]":
    """``kind``: the conv kind, checked against the variables (None: take
    whichever convs they hold); ``bases``: the EGC convs' basis count (the
    other kinds read none)."""
    params = variables["params"]
    _check_kind(params, kind)
    sd: "OrderedDict[str, np.ndarray]" = OrderedDict()
    _conv_rules(sd, params, lambda i: f"convs.{i}.", bases)
    _batchnorm_rules(sd, params, variables.get("batch_stats", {}),
                     lambda i: f"bns.{i}.")
    _gin_net_rules(sd, params, lambda i: f"convs.{i}.")
    sd["embed.0.weight"] = _t(params["embed"]["kernel"])
    sd["embed.0.bias"] = np.asarray(params["embed"]["bias"])
    sd["out.weight"] = _t(params["out"]["kernel"])
    sd["out.bias"] = np.asarray(params["out"]["bias"])
    return _finish(sd)


def _mlp_rules(sd, variables, m: int) -> None:
    """The readout ``MLP_{m}``: ``Dense_k`` at ``mlp.{4k}.`` and its
    ``MaskedBatchNorm_k`` at ``mlp.{4k+1}.``, in the JAX export's order."""
    p = variables["params"][f"MLP_{m}"]
    stats = variables.get("batch_stats", {}).get(f"MLP_{m}", {})
    dense = _module_indices(p, "Dense")
    for k in dense:
        _linear(sd, f"mlp.{4 * k}.", p[f"Dense_{k}"])
        if k < len(dense) - 1:
            _batchnorm_rules(sd, {f"MaskedBatchNorm_{k}":
                                  p[f"MaskedBatchNorm_{k}"]},
                             {f"MaskedBatchNorm_{k}":
                              stats.get(f"MaskedBatchNorm_{k}")},
                             lambda _, k=k: f"mlp.{4 * k + 1}.")


def batched_state_dict_from_jax(dataset: str, variables: Dict[str, Any], *,
                                bases: int = 4
                                ) -> "OrderedDict[str, torch.Tensor]":
    """The JAX ``ZincNet`` / ``CifarNet`` / ``HIVNet`` / ``CodeNet``'s
    variables -> the state dict that the port's net of ``dataset`` takes:
    conv i under ``graph_layers.{i}.{slot}.`` and its BN under
    ``graph_layers.{i}.{slot + 1}.`` (slot 1 for cifar, else 0), the
    readout ``mlp`` (not code's), then the embedding (and code's token
    heads)."""
    if dataset not in ("zinc", "cifar", "hiv", "code"):
        raise ValueError(f"no batched rules for {dataset!r}")
    params = variables["params"]
    slot = 1 if dataset == "cifar" else 0
    sd: "OrderedDict[str, np.ndarray]" = OrderedDict()
    _conv_rules(sd, params, lambda i: f"graph_layers.{i}.{slot}.", bases)
    _batchnorm_rules(sd, params, variables.get("batch_stats", {}),
                     lambda i: f"graph_layers.{i}.{slot + 1}.")
    _gin_net_rules(sd, params, lambda i: f"graph_layers.{i}.{slot}.")
    gin = len(_module_indices(params, "GINConv"))
    for m in _module_indices(params, "MLP"):
        if m >= gin:     # GIN's conv nets are MLP_0 .. MLP_{L-1}
            _mlp_rules(sd, variables, m)
    emb = params["embedding"]
    if dataset == "zinc":
        sd["embedding.weight"] = np.asarray(emb["embedding"])
    elif dataset == "cifar":
        _linear(sd, "embedding.", emb)
    elif dataset == "hiv":
        for i in sorted(int(k.rsplit("_", 1)[1]) for k in emb):
            sd[f"embedding.atom_embedding_list.{i}.weight"] = \
                np.asarray(emb[f"atom_emb_{i}"]["embedding"])
    else:
        for ours, theirs in (("type", "type_encoder"),
                             ("attr", "attribute_encoder"),
                             ("depth", "depth_encoder")):
            sd[f"embedding.{theirs}.weight"] = np.asarray(
                emb[ours]["embedding"])
        tp = params["token_predictors"]   # 5 heads (code/models.py:95-98)
        for s, w in enumerate(np.split(np.asarray(tp["kernel"]), 5, 1)):
            sd[f"token_predictors.{s}.weight"] = _t(w)
        for s, b in enumerate(np.split(np.asarray(tp["bias"]), 5)):
            sd[f"token_predictors.{s}.bias"] = b
    return _finish(sd)


def code_state_dict_from_jax(variables: Dict[str, Any], *, bases: int = 4
                             ) -> "OrderedDict[str, torch.Tensor]":
    """``batched_state_dict_from_jax("code", ...)``: the JAX ``CodeNet``'s
    variables -> the port's ``CodeNet`` state dict."""
    return batched_state_dict_from_jax("code", variables, bases=bases)


def mag_state_dict_from_jax(variables: Dict[str, Any], *, heads: int,
                            bases: int, num_aggrs: int
                            ) -> "OrderedDict[str, torch.Tensor]":
    """The JAX ``MagNet``'s variables -> the port's ``MagNet`` state dict:
    EGConv i at ``convs.{i}.`` under the optimized EGConv's names, its
    ``comb`` columns in the reference's aggregator-major order."""
    params = variables["params"]
    inv = np.argsort(comb_perm(heads, bases, num_aggrs))
    sd: "OrderedDict[str, np.ndarray]" = OrderedDict()
    for i in _module_indices(params, "EGConv"):
        p, tp = params[f"EGConv_{i}"], f"convs.{i}."
        sd[tp + "bases_weight"] = np.asarray(p["bases"]["kernel"])
        sd[tp + "comb_weight.weight"] = _t(np.asarray(
            p["comb"]["kernel"])[:, inv])
        sd[tp + "comb_weight.bias"] = np.asarray(p["comb"]["bias"])[inv]
        sd[tp + "bias"] = np.asarray(p["bias"])
    return _finish(sd)


def rmag_state_dict_from_jax(variables: Dict[str, Any], *,
                             relations, node_types, featureless_types=(),
                             model_kind: str = "egc"
                             ) -> "OrderedDict[str, torch.Tensor]":
    """The JAX ``REGCNet``'s variables -> the port's ``REGCNet`` state
    dict, key for key and in order ``export_model_state("rmag", ...)``'s
    for the same ``relations``, ``node_types`` and ``featureless_types``
    (``model_kind`` "egc" / "regc", or "rgcn" for a stack of RGCNConvs)."""
    params = variables["params"]
    sd: "OrderedDict[str, np.ndarray]" = OrderedDict()
    for t in featureless_types:
        sd[f"embs.{t}"] = np.asarray(params[f"emb_{t}"])
    regc = _module_indices(params, "REGConv")
    rgcn = _module_indices(params, "RGCNConv")
    for i in regc:
        p, tp = params[f"REGConv_{i}"], f"convs.{i}."
        sd[tp + "bases_weight"] = np.asarray(p["bases"]["kernel"])
        for t in node_types:
            _linear(sd, f"{tp}root_combs.{t}.", p[f"root_comb_{t}"])
        for rel in relations:
            _linear(sd, f"{tp}rel_combs.{torch_rel_key(rel)}.",
                    p[f"rel_comb_{rel}"])
    n_inner = len(regc) if model_kind in ("egc", "regc") else len(rgcn) - 1
    for j in rgcn:
        p = params[f"RGCNConv_{j}"]
        tp = f"convs.{j if model_kind == 'rgcn' else n_inner + j}."
        for t in node_types:
            _linear(sd, f"{tp}root_lins.{t}.", p[f"root_{t}"])
        for rel in relations:
            _linear(sd, f"{tp}rel_lins.{torch_rel_key(rel)}.",
                    p[f"rel_{rel}"], bias=False)
    return _finish(sd)


def partitioned_rmag_state_dict_from_jax(
        params: Dict[str, Any], emb: Dict[str, Any], type_plans, *,
        relations, node_types, featureless_types=(),
        model_kind: str = "egc") -> "OrderedDict[str, torch.Tensor]":
    """JAX's partitioned rmag state -> the port's ``REGCNet`` state dict:
    ``params`` (the replicated conv and head parameters) and ``emb`` (its
    ``batch_stats["emb"]``: each featureless type's stacked ``[P, n_local,
    F]`` rows), each table gathered to its ``[N_t, F]`` rows through its
    type's plan (``type_plans[t].gather``), then
    ``rmag_state_dict_from_jax``. A ``DistributedREGCNet`` takes its
    rows of it with ``load_full_state_dict``."""
    full = dict(params)
    for t in featureless_types:
        tp = type_plans[t]
        full[f"emb_{t}"] = tp.gather(np.asarray(emb[t]), len(tp.owner))
    return rmag_state_dict_from_jax(
        {"params": full}, relations=relations, node_types=node_types,
        featureless_types=featureless_types, model_kind=model_kind)


def restore_pretrained_pt(config, pt_path, *, seed: int = 0, data=None):
    """A reference ``checkpoint.pt`` (a bare state dict, or the trial
    payload ``{"model": state_dict, ...}``) restored into the config's
    net for evaluation, the counterpart of the reference's
    ``load_pretrained`` (``experiments/utils.py:69-79``): the config
    gives the architecture (checked against the pretrained registry by
    the caller), the file the weights. Returns ``(model, state, data)``,
    ``state`` the default hyperparameters' fresh optimizer."""
    hp = config.default_hparams()
    if data is None:
        data = config.data(hp)
    model = config.model(hp, seed=seed)
    state = config.init_state(model, hp, data, seed)
    sd = torch.load(pt_path, map_location=config.device, weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    model.load_state_dict(sd, strict=True)
    return model, state, data
