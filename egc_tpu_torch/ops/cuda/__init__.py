"""Hand-written CUDA kernels for Hopper (counterpart of
``egc_tpu.ops.pallas``), their ctypes wrappers and launch counters."""

from __future__ import annotations

from typing import Dict


def launch_counts() -> Dict[str, int]:
    """Kernel launches counted by every wrapper since the last reset."""
    from egc_tpu_torch.ops.cuda import (
        attention, batch_norm, gather_reduce, headmix,
    )
    return {**gather_reduce.launches, **headmix.launches,
            **attention.launches, **batch_norm.launches}


def reset_launch_counts() -> None:
    from egc_tpu_torch.ops.cuda import (
        attention, batch_norm, gather_reduce, headmix,
    )
    for counts in (gather_reduce.launches, headmix.launches,
                   attention.launches, batch_norm.launches):
        for k in counts:
            counts[k] = 0
