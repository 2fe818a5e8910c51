"""The share of the sampled window the training loop spent in ``next()``
on the program's batch iterator (host clock around the benchmark's own
call): waiting for the host sampler's threads and the batch's copy."""


def read(r):
    if r["mode"] != "sampled" or "loader_wait_s" not in r:
        return None
    return 100.0 * r["loader_wait_s"] / r["window_s"]
