"""Distributed paths (counterpart of ``egc_tpu.parallel``): process groups
(``mesh``: ranks spawned on one host, or joined from a launcher's
environment on several), data parallelism for the batched tasks
(``dp``), and graph-partitioned full-graph training (``partition``,
``halo``; heterogeneous: ``hetero_partition``, ``hetero_halo``)."""
