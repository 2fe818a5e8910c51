"""One reader per metric, ``<metric>.py`` with ``read(records)``: the
number from a run's records, or None where the run has nothing for it
(the harness then leaves the metric out). ``records`` holds the run's
``mode``, ``setup_s``, ``window_s``, ``steps``, ``step_s`` (each step's
seconds, host clock), ``edges`` or ``seeds``, ``peak_bytes``; a traced
run adds ``profile`` (device ``ops`` as (name, seconds), ``busy_s``,
``steps``, ``window_s``), ``counts`` (a step's ``flops`` and kernel
bytes), ``loader_wait_s`` and ``spans``."""
