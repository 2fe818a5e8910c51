"""The homogeneous ogbn-mag net through the program's ``MagConfig``
(full-graph steps) and ``SampledMagConfig`` (neighbour-sampled steps,
with the traffic's fanouts, batch size and sampler)."""

from __future__ import annotations


def config_class(mode: str):
    from egc_tpu_torch.exp.fullgraph import MagConfig, SampledMagConfig
    if mode in ("full", "trial"):
        return MagConfig
    if mode == "sampled":
        return SampledMagConfig
    raise ValueError(f"the mag net has no {mode!r} traffic")


def config_args(cfg: dict, traffic: dict):
    net = cfg["net"]
    kwargs = dict(heads=net["heads"], bases=net["bases"],
                  aggrs=tuple(net["aggrs"]))
    if traffic["mode"] == "sampled":
        kwargs.update(fanouts=tuple(traffic["fanouts"]),
                      batch_size=traffic["batch_size"],
                      device_sampler=traffic["sampler"] == "device")
    return (net["kind"], net["hidden"]), kwargs
