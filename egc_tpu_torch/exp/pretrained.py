"""The pretrained-model registry with its architecture checks
(counterpart of ``egc_tpu.exp.pretrained``, value for value).

The reference's ``PRETRAINED_CONF`` dicts and per-config ``pretrained``
assertions (reference ``experiments/zinc/configs.py:29-33,264-284``,
``cifar/configs.py:30-34,277-288``, ``mol/configs.py:39-49,348-358``,
``arxiv/configs.py:32-43,326-334``, ``code/configs.py:33-44,357-364``):
before a checkpoint is restored, the requested architecture must match
the published one exactly. The reference's download links are dead, so
``--pretrained`` restores a local experiment directory: the reference's
``checkpoint.pt`` (``exp.weight_port.restore_pretrained_pt``; the port's
modules carry the reference's names, so it loads as it is) or a trial
directory of this port.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from egc_tpu_torch.ops.segment import canonical_aggr


class PretrainedEntry:
    def __init__(self, hidden: int, heads: Optional[int] = None,
                 bases: Optional[int] = None,
                 aggrs: Optional[Tuple[str, ...]] = None):
        self.hidden = hidden
        self.heads = heads
        self.bases = bases
        self.aggrs = frozenset(canonical_aggr(a) for a in aggrs) \
            if aggrs else None


# hidden sizes from the reference PRETRAINED_CONF dicts; heads/bases/aggrs
# for EGC rows from the per-config pretrained() asserts (citations above).
PRETRAINED_CONF: Dict[str, Dict[str, PretrainedEntry]] = {
    "zinc": {
        "gatv2": PretrainedEntry(104),
        "egc_s": PretrainedEntry(168, 8, 4, ("symadd",)),
        "egc_m": PretrainedEntry(124, 4, 4, ("add", "std", "max")),
    },
    "cifar": {
        "gatv2": PretrainedEntry(104),
        "egc_s": PretrainedEntry(168, 8, 4, ("symadd",)),
        "egc_m": PretrainedEntry(128, 4, 4, ("symadd", "std", "max")),
    },
    "hiv": {
        "gcn": PretrainedEntry(240),
        "gat": PretrainedEntry(240),
        "gatv2": PretrainedEntry(184),
        "gin": PretrainedEntry(240),
        "sage": PretrainedEntry(180),
        "mpnn_max": PretrainedEntry(180),
        "mpnn_add": PretrainedEntry(180),
        "egc_s": PretrainedEntry(296, 8, 4, ("symadd",)),
        "egc_m": PretrainedEntry(224, 4, 4, ("add", "max", "mean")),
    },
    "arxiv": {
        "gcn": PretrainedEntry(156),
        "gat": PretrainedEntry(152),
        "gatv2": PretrainedEntry(112),
        "gin": PretrainedEntry(156),
        "sage": PretrainedEntry(115),
        "mpnn_max": PretrainedEntry(116),
        "mpnn_add": PretrainedEntry(116),
        "pna": PretrainedEntry(76),
        "egc_s": PretrainedEntry(184, 8, 4, ("symadd",)),
        "egc_m": PretrainedEntry(136, 4, 4, ("symadd", "max", "mean")),
    },
    "code": {
        "gcn": PretrainedEntry(304),
        "gat": PretrainedEntry(304),
        "gatv2": PretrainedEntry(296),
        "gin": PretrainedEntry(304),
        "sage": PretrainedEntry(293),
        "mpnn_max": PretrainedEntry(292),
        "mpnn_add": PretrainedEntry(292),
        "pna": PretrainedEntry(272),
        "egc_s": PretrainedEntry(304, 8, 8, ("symadd",)),
        "egc_m": PretrainedEntry(300, 4, 4, ("symadd", "min", "max")),
    },
}

_MODEL_KEYS = {"mpnn-max": "mpnn_max", "mpnn-sum": "mpnn_add"}


def validate_pretrained(dataset: str, model: str, config) -> str:
    """Assert the CLI-requested architecture matches the published
    pretrained one (reference load_pretrained + per-config asserts).
    Returns the registry model key."""
    if dataset not in PRETRAINED_CONF:
        raise ValueError(f"no pretrained models published for {dataset!r}")
    table = PRETRAINED_CONF[dataset]
    key = _MODEL_KEYS.get(model, model)
    conv = getattr(config, "conv", None)
    if model == "egc":
        aggrs = tuple(config.aggrs) if hasattr(config, "aggrs") and \
            config.aggrs else tuple(conv.aggrs or ())
        key = "egc_s" if len(aggrs) == 1 else "egc_m"
    if key not in table:
        raise ValueError(f"no pretrained {model!r} for {dataset!r} "
                         f"(published: {sorted(table)})")
    entry = table[key]
    hidden = config.hidden
    if hidden != entry.hidden:
        raise ValueError(f"pretrained {dataset}/{key} has hidden="
                         f"{entry.hidden}, requested {hidden}")
    if entry.heads is not None:
        heads = getattr(config, "heads", None) or conv.heads
        bases = getattr(config, "bases", None) or conv.bases
        got = frozenset(canonical_aggr(a) for a in aggrs)
        if heads != entry.heads or bases != entry.bases:
            raise ValueError(
                f"pretrained {dataset}/{key} uses H{entry.heads} "
                f"B{entry.bases}, requested H{heads} B{bases}")
        if got != entry.aggrs:
            raise ValueError(f"pretrained {dataset}/{key} uses aggrs "
                             f"{sorted(entry.aggrs)}, requested {sorted(got)}")
    return key
