"""The share of a trial iteration outside the configuration's ``train``
hook (evaluation, the plateau, checkpoints, the runner's own work), from
the host spans the benchmark records around the hooks in a traced run."""


def read(r):
    spans = r.get("spans")
    if r["mode"] != "trial" or not spans or not spans.get("iteration"):
        return None
    return 100.0 * (1.0 - sum(spans["train"]) / sum(spans["iteration"]))
