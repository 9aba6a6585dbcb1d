"""Logger interface (the port's copy of ``pilosa_tpu.utils.logger``)."""

from __future__ import annotations

import logging
import sys


def new_standard_logger(name: str = "pilosa_tpu", verbose: bool = False) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        logger.addHandler(handler)
    logger.setLevel(logging.DEBUG if verbose else logging.INFO)
    return logger


def nop_logger() -> logging.Logger:
    logger = logging.getLogger("pilosa_tpu.nop")
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger
