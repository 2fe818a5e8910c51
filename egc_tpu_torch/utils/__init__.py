"""Observability, determinism and profiling helpers (counterpart of
``egc_tpu.utils``). Its ``torch_pt`` reader has no counterpart: the port
reads a reference ``checkpoint.pt`` with ``torch.load``
(``exp.weight_port.restore_pretrained_pt``)."""

from egc_tpu_torch.utils.logging import JSONLLogger, ThroughputMeter  # noqa: F401
from egc_tpu_torch.utils.debug import (  # noqa: F401
    check_finite, enable_determinism, seed_all,
)
from egc_tpu_torch.utils.profiling import (  # noqa: F401
    device_op_table, print_op_table, profile_trace,
)
