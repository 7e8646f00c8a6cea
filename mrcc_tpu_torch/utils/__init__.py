"""Host utilities (port of ``mrcc_tpu/utils``)."""
