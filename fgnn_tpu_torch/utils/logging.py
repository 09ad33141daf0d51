"""Leveled logging (the port's copy of ``fgnn_tpu/utils/logging.py``)."""
from __future__ import annotations

import logging
import os
import sys

from .. import constants

_LEVELS = {
    "TRACE": logging.DEBUG - 5,
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
}


def get_logger(name: str = "fgnn_tpu_torch") -> logging.Logger:
    """A stderr logger at the level ``FGNN_TPU_LOG_LEVEL`` names (INFO by
    default), set up once per name."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("[%(asctime)s %(levelname)s %(name)s] %(message)s")
        )
        logger.addHandler(handler)
        level = os.environ.get(constants.ENV_LOG_LEVEL, "INFO").upper()
        logger.setLevel(_LEVELS.get(level, logging.INFO))
        logger.propagate = False
    return logger
