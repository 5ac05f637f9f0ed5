"""The host C of `csrc/` (PNG row filters, the JPEG decoder and encoder, mask contours):
each file is built with the system C compiler at first use into `sar_yolo_tpu_torch/build/`
(cached under a hash of the source and flags) and called through ctypes, which releases
the GIL while the C runs."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parent / "build"
_CFLAGS = ["-O3", "-std=c99", "-shared", "-fPIC"]

_lock = threading.Lock()
_libraries: dict = {}


def build(source: Path) -> Path:
    """Compile `source` (a file of `csrc/`) if its library is not built yet; returns its path."""
    key = hashlib.sha256(" ".join(_CFLAGS).encode() + b"\0" + source.read_bytes())
    lib = BUILD_DIR / f"lib{source.stem}_{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError(f"no C compiler (cc or gcc) to build {source}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cc, *_CFLAGS, "-o", str(tmp), str(source)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cc} failed ({proc.returncode}) for {source}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def library(source: Path, signatures: dict):
    """The ctypes handle of `source`'s library, built and bound once per process:
    `signatures` maps each function's name to its (argtypes, restype)."""
    with _lock:
        if source not in _libraries:
            handle = ctypes.CDLL(str(build(source)))
            for name, (argtypes, restype) in signatures.items():
                fn = getattr(handle, name)
                fn.argtypes, fn.restype = argtypes, restype
            _libraries[source] = handle
        return _libraries[source]
