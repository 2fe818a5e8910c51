"""The benchmark of ``egc_tpu_torch`` on NVIDIA H100s, driven by data:
``python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (see ``README.md``)."""
