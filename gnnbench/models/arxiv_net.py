"""The arxiv net through the program's ``ArxivConfig`` (full-graph
steps and whole trials)."""

from __future__ import annotations


def config_class(mode: str):
    from egc_tpu_torch.exp.fullgraph import ArxivConfig
    if mode in ("full", "trial"):
        return ArxivConfig
    raise ValueError(f"the arxiv net has no {mode!r} traffic")


def config_args(cfg: dict, traffic: dict):
    net = cfg["net"]
    return (net["kind"], net["hidden"]), dict(
        heads=net["heads"], bases=net["bases"], aggrs=tuple(net["aggrs"]))
