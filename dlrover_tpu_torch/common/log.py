"""Process-wide logger: the port of ``dlrover_tpu/common/log.py``.

The same format and ``DLROVER_LOG_LEVEL`` knob, under the logger name
``dlrover_tpu_torch`` so that a process importing both packages keeps two
separately configured loggers.
"""

import logging
import os
import sys

_FORMAT = (
    "[%(asctime)s] [%(levelname)s] "
    "[%(filename)s:%(lineno)d:%(funcName)s] %(message)s"
)


def _build_logger() -> logging.Logger:
    logger = logging.getLogger("dlrover_tpu_torch")
    if logger.handlers:
        return logger
    level = os.getenv("DLROVER_LOG_LEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    logger.propagate = False
    return logger


default_logger = _build_logger()
logger = default_logger
