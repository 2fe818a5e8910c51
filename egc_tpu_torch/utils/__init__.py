"""Determinism, debugging and profiling helpers (counterpart of
``egc_tpu.utils``; its JSONL logger and throughput meter have no
counterpart: the port's runs record through ``exp/runner``'s history and
the benchmark). Its ``torch_pt`` reader has no counterpart: the port
reads a reference ``checkpoint.pt`` with ``torch.load``
(``exp.weight_port.restore_pretrained_pt``)."""

from egc_tpu_torch.utils.debug import (  # noqa: F401
    check_finite, enable_determinism, seed_all,
)
from egc_tpu_torch.utils.profiling import (  # noqa: F401
    device_op_table, profile_trace, span, span_totals,
)
