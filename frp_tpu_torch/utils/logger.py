"""Named loggers for the port (a minimal stand-in for
``frp_tpu/utils/logger.py``, whose file and audit sinks belong to the
platform layer the port has not taken on yet)."""

from __future__ import annotations

import logging


def get_logger(name: str = "frp") -> logging.Logger:
    return logging.getLogger(name)
