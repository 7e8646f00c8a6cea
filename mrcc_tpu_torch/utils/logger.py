"""Rotating-file logger (port of ``mrcc_tpu/utils/logger.py``): one
logger a name, INFO level, a stream handler and, with ``log_path``, a
rotating file handler (10 MiB, 3 backups), both with the format
``[time][LEVEL] message``."""

from __future__ import annotations

import logging
import logging.handlers
import os

_LOGGERS = {}


def get_logger(name="mrcc_tpu_torch", log_path=None):
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("[%(asctime)s][%(levelname)s] %(message)s")
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if log_path:
            os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
            fh = logging.handlers.RotatingFileHandler(
                log_path, maxBytes=10 * 1024 * 1024, backupCount=3)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    _LOGGERS[name] = logger
    return logger
