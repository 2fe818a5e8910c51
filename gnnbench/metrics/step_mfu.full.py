"""The whole full-graph step's share of the card's float32 peak: the
model's operations a step (``counts/<model>.py``: every matmul forward
and backward, the aggregators' per-edge operations, the head mix) over
the step's time without the profiler in the same run, times 67 TFLOP/s.
"""

from gnnbench.peaks import F32_FLOPS


def read(r):
    if r["mode"] != "full" or "counts" not in r:
        return None
    step_s = r["window_s"] / r["steps"]
    return 100.0 * r["counts"]["flops"] / step_s / F32_FLOPS
