"""The aggregation kernels' share of their roofline: the aggregation's
compulsory bytes a step, forward and backward (``counts/<model>.py``),
at 3.35 TB/s, over the device time a step of the kernels named here."""

from gnnbench.peaks import HBM_BYTES_PER_S
from gnnbench.trace import matching

KERNELS = ("gather_reduce",)


def read(r):
    if r["mode"] != "full" or "profile" not in r:
        return None
    prof = r["profile"]
    t = matching(prof["ops"], KERNELS) / prof["steps"]
    if t <= 0:
        return None
    return 100.0 * r["counts"]["gather_reduce_bytes"] / HBM_BYTES_PER_S / t
