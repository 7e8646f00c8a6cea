"""Entry mains (port of ``mrcc_tpu/cli``)."""
