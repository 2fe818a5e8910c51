"""Task networks (counterpart of ``egc_tpu.models``)."""
