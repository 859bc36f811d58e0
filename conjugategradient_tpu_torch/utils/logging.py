"""Logging: the reference's compile-time Debuglevel tracing
(LinearAlgebraTypes.hpp:26-30) as Python logging with a verbosity switch.
Counterpart of ``conjugategradient_tpu/utils/logging.py``; the solve loops
log nothing and return their metadata instead."""

from __future__ import annotations

import logging

_LOGGER_NAME = "conjugategradient_tpu"


def get_logger(name: str = _LOGGER_NAME) -> logging.Logger:
    return logging.getLogger(name)


def set_verbosity(level: str = "info"):
    """'none' | 'info' | 'verbose' (the reference's None/Verbose enum)."""
    lut = {
        "none": logging.WARNING,
        "info": logging.INFO,
        "verbose": logging.DEBUG,
    }
    logger = get_logger()
    logger.setLevel(lut.get(level, logging.INFO))
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[%(name)s] %(levelname)s %(message)s"))
        logger.addHandler(h)
