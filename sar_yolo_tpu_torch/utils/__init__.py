"""Package root and logger of the port."""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path

import torch

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


def select_device(device=None) -> torch.device:
    """`cuda` unless the caller names another device; raises where CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
