"""Experiment entry points (counterpart of ``egc_tpu.exp``)."""
