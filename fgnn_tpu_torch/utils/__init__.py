"""Logging and timing (the port's copy of ``fgnn_tpu/utils``)."""
from .logging import get_logger
from .timer import Timer
