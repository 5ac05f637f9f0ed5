"""Typed exceptions of the port (the part of `sar_yolo_tpu/utils/errors.py` it raises)."""

from __future__ import annotations


class ExportError(Exception):
    """An artifact that cannot be written as asked (an option with no mapping in the format)."""
