"""Aggregation ops (counterpart of ``egc_tpu.ops``)."""
