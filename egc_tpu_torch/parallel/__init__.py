"""Distributed paths (counterpart of ``egc_tpu.parallel``): process groups
(``mesh``), data parallelism for the batched tasks (``dp``), and
graph-partitioned full-graph training (``partition``, ``halo``). The
heterogeneous partitioner (``hetero_partition``, ``hetero_halo``) is not
ported yet (ROADMAP.md A16)."""
