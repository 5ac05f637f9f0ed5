"""Builds a CUDA source of `sar_yolo_tpu_torch/csrc/` for sm_90a into a shared library with
a plain C interface (loaded with ctypes by its wrapper), at first use, into the git-ignored
`sar_yolo_tpu_torch/build/`, cached under a hash of the nvcc flags and of every source file
it includes."""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def included_sources(path: Path) -> list[Path]:
    """`path` and every file it includes with `#include "..."`, recursively."""
    found, todo = [], [path.resolve()]
    while todo:
        src = todo.pop()
        if src in found:
            continue
        found.append(src)
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', src.read_text(), re.M):
            dep = (src.parent / name).resolve()
            if dep.is_file():
                todo.append(dep)
    return found


def nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build(source: Path) -> tuple[Path, str]:
    """Compile `source` if its library is not built yet. Returns (library path, compiler
    output, which holds ptxas's registers, shared memory and spills of each kernel)."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in included_sources(source):
        key.update(src.name.encode() + b"\0" + src.read_bytes())
    lib = BUILD_DIR / f"lib{source.stem}_{key.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return lib, log.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {source}:\n{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib, log.read_text()
