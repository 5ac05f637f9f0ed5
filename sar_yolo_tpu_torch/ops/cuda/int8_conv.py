"""int8 convolution: the hand-written CUDA kernel, its plain PyTorch version and its build.

`int8_conv(xq, wq, sx, sw, bias, stride, padding, dilation, dtype)` computes the int8
path of the JAX package's `sar_yolo_tpu/nn/modules/conv.py::Int8Conv2D` after its
quantization: the exact int32 sums of the convolution of the int8 activations `xq`
(B, H, W, C) NHWC with the int8 filters `wq` (C_out, kh, kw, C), then
`float32(sums) * (sx[b] * sw[n]) + bias[n]` cast to `dtype`, as an NCHW
(B, C_out, Ho, Wo) tensor. Padding is symmetric (`padding` on every side).

* A CPU tensor goes through `int8_conv_plain`: a float64 convolution of the int8
  values, exact while |sum| < 2^53, then the same float32 rescale.
* A CUDA tensor launches the kernel of `csrc/int8_conv.cu`, or raises. There is no
  fallback. `int8_conv.launches` counts its launches.
* `int8_conv_sums` returns the int32 sums alone (the kernel's check entry; not counted).

The JAX package's int8 convolution is XLA's `conv_general_dilated`, not a Pallas kernel;
the quantization around it (abs-max, divide, round, clip) stays torch ops here as it is XLA
there (`nn/modules/conv.py::Int8Conv2d`).
"""

from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

from sar_yolo_tpu_torch.ops.cuda import nvcc

SOURCE = nvcc.CSRC / "int8_conv.cu"


def build():
    """Compile the kernel for sm_90a if its library is not built yet (`nvcc.build`)."""
    return nvcc.build(SOURCE)


class _Library:
    """The loaded kernel library (loaded once per process, on first launch)."""

    handle = None

    @classmethod
    def get(cls):
        if cls.handle is None:
            handle = ctypes.CDLL(str(build()[0]))
            for fn in (handle.int8_conv_f32, handle.int8_conv_bf16):
                fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_int),
                                                       ctypes.c_void_p]
                fn.restype = ctypes.c_int
            handle.int8_conv_sums.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
            handle.int8_conv_sums.restype = ctypes.c_int
            cls.handle = handle
        return cls.handle


def out_size(n: int, k: int, stride: int, padding: int, dilation: int) -> int:
    return (n + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def conv_sums_plain(xq, wq, stride: int, padding: int, dilation: int):
    """The exact sums, float64 (B, C_out, Ho, Wo), of int8 NHWC `xq` and (C_out, kh, kw, C)
    `wq`."""
    return F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.permute(0, 3, 1, 2).double(), None,
                    stride, padding, dilation)


def rescale(sums, sx, sw, bias, dtype):
    """float32(sums) * (sx * sw) + bias in the JAX package's order, cast to dtype."""
    s = sx.float().view(-1, 1, 1, 1) * sw.float().view(1, -1, 1, 1)
    return (sums.float() * s + bias.float().view(1, -1, 1, 1)).to(dtype)


def int8_conv_plain(xq, wq, sx, sw, bias, stride: int, padding: int, dilation: int, dtype):
    """Plain PyTorch version of the kernel."""
    return rescale(conv_sums_plain(xq, wq, stride, padding, dilation), sx, sw, bias, dtype)


def _pad_channels(t):
    """t (..., C) int8, zero-padded to a multiple of 4 channels (the kernel's 4-byte words)."""
    c = t.shape[-1]
    return t if c % 4 == 0 else F.pad(t, (0, -c % 4))


def _launch(xq, wq, stride: int, padding: int, dilation: int, out, fn, *scales):
    """Check the operands, lay them out for the kernel, launch it into `out`."""
    for name, t in (("xq", xq), ("wq", wq), *((f"scale {i}", s) for i, s in enumerate(scales))):
        if t.device != xq.device or t.device.type != "cuda":
            raise ValueError(f"int8_conv: {name} is on {t.device}, expected the CUDA device "
                             f"of xq ({xq.device})")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or xq.dim() != 4 or wq.dim() != 4:
        raise TypeError(f"int8_conv: xq {xq.dtype} {tuple(xq.shape)} and wq {wq.dtype} "
                        f"{tuple(wq.shape)} must be 4-d int8 (NHWC and C_out, kh, kw, C)")
    B, H, W, C = xq.shape
    N, kh, kw, Cw = wq.shape
    if C != Cw or min(stride, dilation) < 1 or padding < 0:
        raise ValueError(f"int8_conv: C={C} against the filters' {Cw}, stride {stride}, "
                         f"padding {padding}, dilation {dilation}")
    Ho, Wo = (out_size(H, kh, stride, padding, dilation), out_size(W, kw, stride, padding, dilation))
    if out.shape != (B, N, Ho, Wo) or not out.is_contiguous():
        raise ValueError(f"int8_conv: output {tuple(out.shape)}, expected {(B, N, Ho, Wo)}")
    x4, w4 = _pad_channels(xq).contiguous(), _pad_channels(wq).contiguous()
    if (kh * kw * x4.shape[-1]) >= 133_000:  # 127^2 K must stay under 2^31
        raise ValueError(f"int8_conv: K = {kh * kw * C} may overflow the int32 sums")
    geo = (ctypes.c_int * 12)(B, H, W, x4.shape[-1] // 4, N, kh, kw, Ho, Wo, stride, padding,
                              dilation)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        rc = fn(x4.data_ptr(), w4.data_ptr(), *(s.data_ptr() for s in scales), out.data_ptr(),
                geo, stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv: kernel launch failed with CUDA error {rc}")
    return out


def _out_shape(xq, wq, stride: int, padding: int, dilation: int) -> tuple:
    B, H, W, _ = xq.shape
    N, kh, kw, _ = wq.shape
    return (B, N, out_size(H, kh, stride, padding, dilation),
            out_size(W, kw, stride, padding, dilation))


def int8_conv(xq, wq, sx, sw, bias, stride: int = 1, padding: int = 0, dilation: int = 1,
              dtype=torch.float32):
    """The rescaled int8 convolution (B, C_out, Ho, Wo) in `dtype` (float32 or bfloat16): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors. sx (B,), sw and bias
    (C_out,) float32."""
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, wq, sx, sw, bias, stride, padding, dilation, dtype)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_conv: output dtype {dtype}; the kernel writes float32 or bfloat16")
    lib = _Library.get()
    out = torch.empty(_out_shape(xq, wq, stride, padding, dilation), dtype=dtype,
                      device=xq.device)
    fn = lib.int8_conv_f32 if dtype == torch.float32 else lib.int8_conv_bf16
    scales = tuple(t.float().contiguous() for t in (sx, sw, bias))
    _launch(xq, wq, stride, padding, dilation, out, fn, *scales)
    _counted.launches += 1
    return out


_counted = int8_conv  # the wrapper that holds the count, also while a caller wraps the name


def int8_conv_sums(xq, wq, stride: int = 1, padding: int = 0, dilation: int = 1):
    """The int32 sums (B, C_out, Ho, Wo): the kernel's for CUDA tensors (not counted in
    `int8_conv.launches`), the plain version's for CPU tensors."""
    if xq.device.type == "cpu":
        return conv_sums_plain(xq, wq, stride, padding, dilation).to(torch.int32)
    out = torch.empty(_out_shape(xq, wq, stride, padding, dilation), dtype=torch.int32,
                      device=xq.device)
    return _launch(xq, wq, stride, padding, dilation, out, _Library.get().int8_conv_sums)


def reset_launches():
    """Set the launch count to 0."""
    _counted.launches = 0


reset_launches()  # kernel launches in this process
