"""Datasets (counterpart of ``egc_tpu.data``)."""
