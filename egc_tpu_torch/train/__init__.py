"""Training helpers (counterpart of ``egc_tpu.train``)."""
