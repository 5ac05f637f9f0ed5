"""Package root and logger of the port."""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]  # sar_yolo_tpu_torch/ package root

VERBOSE = os.environ.get("SARYOLO_VERBOSE", "1") == "1"


def _make_logger(name: str = "sar_yolo_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
    logger.setLevel(logging.INFO if VERBOSE else logging.WARNING)
    logger.propagate = False
    return logger


LOGGER = _make_logger()
