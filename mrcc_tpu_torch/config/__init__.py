"""YAML configuration (port of ``mrcc_tpu/config``)."""

from .config import DEFAULT_CONFIG, OVERRIDES_DIR, Config  # noqa: F401
