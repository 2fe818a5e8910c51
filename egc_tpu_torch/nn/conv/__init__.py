"""Graph convolutions (counterpart of ``egc_tpu.nn.conv``)."""
