"""Leveled logging and the apps' result lines (the port's copy of
``fgnn_tpu/utils/logging.py``).

``config:<k>=<v>`` and ``test_result:<k>=<v>`` are the source system's
machine-parseable app lines (common_config.py:221-230,
train_gcn.py:411-412), which the experiment runners parse."""
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


def log_config(key: str, value) -> None:
    """Emit a ``config:k=v`` line (common_config.py:221-230 format)."""
    print(f"config:{key}={value}", flush=True)


def log_test_result(key: str, value) -> None:
    """Emit a ``test_result:k=v`` line (train_gcn.py:411-412 format)."""
    print(f"test_result:{key}={value}", flush=True)
