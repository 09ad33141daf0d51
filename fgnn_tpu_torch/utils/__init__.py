"""Logging and timing (the port's copy of ``fgnn_tpu/utils``)."""
from .logging import get_logger, log_config, log_test_result
from .timer import Timer
