"""Area attention: the hand-written CUDA kernel, its plain PyTorch version and its build.

`flash_area_attention(q, k, v, num_heads, area)` has the contract of the JAX
package's `sar_yolo_tpu/ops/pallas/flash_attention.py::flash_area_attention`:
q, k, v are (B, N, C) with C = num_heads * 32; the N tokens split into `area`
contiguous chunks and attention runs inside each chunk, per head.

* A CPU tensor goes through `area_attention_plain`.
* A CUDA tensor launches the kernel of `csrc/flash_area_attention.cu`, or
  raises. There is no fallback.
* The backward recomputes through the plain version (as the JAX package's
  custom VJP does); there is no backward kernel.

The kernel is built with nvcc at first use into `sar_yolo_tpu_torch/build/`
(a plain C interface, loaded with ctypes) and cached there by source hash.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

HEAD_DIM = 32
_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "flash_area_attention.cu"
BUILD_DIR = _PKG / "build"
_MAX_GRID_Z = 65535


def area_attention_plain(q, k, v, num_heads: int, area: int):
    """Plain PyTorch area attention (math of `sar_yolo_tpu/nn/modules/block.py::area_attention`)."""
    B, N, C = q.shape
    hd = C // num_heads
    Ba, Na = B * area, N // area
    q = q.reshape(Ba, Na, num_heads, hd)
    k = k.reshape(Ba, Na, num_heads, hd)
    v = v.reshape(Ba, Na, num_heads, hd)
    attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    attn = attn.float().softmax(-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, N, C)


def build() -> tuple[Path, str]:
    """Compile the kernel for sm_90a if its library is not built yet.

    Returns (library path, compiler output; empty when the library was cached).
    """
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libflash_area_attention_{digest}.so"
    if lib.exists():
        return lib, ""
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


class _Library:
    """The loaded kernel library (loaded once per process, on first launch)."""

    handle = None

    @classmethod
    def get(cls):
        if cls.handle is None:
            path, _ = build()
            handle = ctypes.CDLL(str(path))
            for fn in (handle.flash_area_attention_f32, handle.flash_area_attention_bf16):
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                    ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
                fn.restype = ctypes.c_int
            cls.handle = handle
        return cls.handle


def _launch(q, k, v, num_heads: int, area: int):
    """Run the CUDA kernel on CUDA tensors; raise on anything it does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_area_attention: {name} is on {t.device}, "
                             f"expected the CUDA device of q ({q.device})")
        if t.dtype != q.dtype or t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flash_area_attention: {name} has dtype {t.dtype}; "
                            "q, k, v must all be float32 or all bfloat16")
        if t.shape != q.shape or t.dim() != 3:
            raise ValueError(f"flash_area_attention: {name} has shape {tuple(t.shape)}, "
                             f"expected (B, N, C) equal to q's {tuple(q.shape)}")
        # the kernel addresses through strides; one of the two inner axes must be
        # unit-stride so that neighbouring threads read neighbouring addresses
        if t.stride(2) != 1 and t.stride(1) != 1:
            raise ValueError(f"flash_area_attention: {name} has strides {t.stride()}; "
                             "its channel or token axis must be contiguous")
    B, N, C = q.shape
    if C != num_heads * HEAD_DIM:
        raise ValueError(f"flash_area_attention: C={C} with {num_heads} heads gives head dim "
                         f"{C / num_heads}; the kernel takes head dim {HEAD_DIM} only")
    if area < 1 or N % area or N == 0:
        raise ValueError(f"flash_area_attention: N={N} does not split into {area} areas")
    if B * area > _MAX_GRID_Z:
        raise ValueError(f"flash_area_attention: B*area={B * area} exceeds {_MAX_GRID_Z}")
    # the output takes q's layout: token-contiguous for views of NCHW maps
    if q.stride(1) == 1 and q.stride(2) != 1:
        out = torch.empty((B, C, N), dtype=q.dtype, device=q.device).transpose(1, 2)
    else:
        out = torch.empty((B, N, C), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride(), *k.stride(), *v.stride(), *out.stride())
    lib = _Library.get()
    fn = lib.flash_area_attention_f32 if q.dtype == torch.float32 else \
        lib.flash_area_attention_bf16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, N, area, num_heads, strides, stream)
    if rc != 0:
        raise RuntimeError(f"flash_area_attention: kernel launch failed with CUDA error {rc}")
    flash_area_attention.launches += 1
    return out


def _forward(q, k, v, num_heads: int, area: int):
    if q.device.type == "cpu":
        return area_attention_plain(q, k, v, num_heads, area)
    return _launch(q, k, v, num_heads, area)


class _FlashAreaAttention(torch.autograd.Function):
    """Kernel forward; backward recomputes through the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, area):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.area = num_heads, area
        return _forward(q, k, v, num_heads, area)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = area_attention_plain(q, k, v, ctx.num_heads, ctx.area)
        gq, gk, gv = torch.autograd.grad(out, (q, k, v), grad)
        return gq, gk, gv, None, None


def flash_area_attention(q, k, v, num_heads: int, area: int = 1):
    """Area attention on (B, N, C) tensors: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. Returns (B, N, C)."""
    return _FlashAreaAttention.apply(q, k, v, num_heads, area)


flash_area_attention.launches = 0  # kernel launches in this process
