"""Aggregation ops (counterpart of ``egc_tpu.ops``): the same public
names, in plain PyTorch."""

from egc_tpu_torch.ops.segment import (  # noqa: F401
    AGGREGATORS,
    canonical_aggr,
    multi_aggregate,
    segment_count,
    segment_max,
    segment_mean,
    segment_min,
    segment_softmax,
    segment_std,
    segment_sum,
    segment_var,
)
