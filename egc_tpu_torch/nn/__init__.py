"""Layers (counterpart of ``egc_tpu.nn``)."""
