"""The int8 path of `Int8Conv2d`: two hand-written CUDA kernels, their plain PyTorch versions
and their build.

`int8_quantize(x, pad_to)` quantizes an NCHW activation per sample as the JAX package's
`sar_yolo_tpu/nn/modules/conv.py::Int8Conv2D` does: sx = max(max|x|, 1e-12) / 127 over each
sample, xq = clip(round(x / sx), -127, 127) (IEEE division, round half to even), returned as
an NHWC (B, H, W, Cp) int8 tensor whose channels are zero-padded to a multiple of `pad_to`,
and sx (B,) float32.

`int8_conv(xq, wq, sx, sw, bias, stride, padding, dilation, dtype)` computes the exact int32
sums of the convolution of the int8 activations `xq` (B, H, W, C) NHWC with the int8 filters
`wq` (C_out, kh, kw, C), then `float32(sums) * (sx[b] * sw[n]) + bias[n]` cast to `dtype`, as
an NCHW (B, C_out, Ho, Wo) tensor. Padding is symmetric (`padding` on every side).

* A CPU tensor goes through the plain versions: `int8_quantize_plain` (the torch ops of
  JAX's quantization) and `int8_conv_plain` (a float64 convolution of the int8 values, exact
  while |sum| < 2^53, then the same float32 rescale).
* A CUDA tensor launches the kernels of `csrc/int8_quant.cu` (one cooperative launch: the
  abs-max, a grid-wide barrier, the quantize-pack pass) and `csrc/int8_conv.cu` (mma.sync
  int8 tensor cores), or raises. There is no fallback. `int8_quantize.launches` and
  `int8_conv.launches` count their calls.
* `int8_conv_sums` returns the int32 sums alone (the kernel's check entry; not counted).
* `channel_multiple(c_in, device)` is the channel padding the kernels read: 16, or 4 where
  C_in <= 4 (the stem's 4-byte copies); 1 on the CPU, where the plain versions read any.
  `Int8Conv2d` pads its cached weights and asks `int8_quantize` for the same; on the card
  `int8_conv` raises on channels not padded so.

Neither replaces a Pallas kernel: the JAX package leaves both to XLA.
"""

from __future__ import annotations

import ctypes
import functools
from concurrent.futures import ThreadPoolExecutor

import torch
from torch.nn import functional as F

from sar_yolo_tpu_torch.ops.cuda import nvcc

SOURCE = nvcc.CSRC / "int8_conv.cu"
QUANT_SOURCE = nvcc.CSRC / "int8_quant.cu"
# the conv kernel's tiles (filters, pixels), in the order of csrc/int8_conv.cu's `launch_cb`;
# the 64-pixel ones need Cp % 16 == 0
TILES = ((128, 64), (64, 128), (64, 64), (32, 128), (16, 128))
MAX_K = 133_000  # 127^2 K must stay under 2^31
QUANT_TILE = 4096  # values of one quantize-pack tile (csrc/int8_quant.cu's kTile)


def build():
    """Compile both kernels for sm_90a where their libraries are not built yet, the two nvcc
    runs side by side (`nvcc.build`). Returns [(library path, compiler output)] for
    `int8_conv.cu` and `int8_quant.cu`."""
    with ThreadPoolExecutor(2) as pool:
        return list(pool.map(nvcc.build, (SOURCE, QUANT_SOURCE)))


class _Library:
    """The loaded kernel libraries (loaded once per process, on first launch)."""

    conv = quant = None

    @classmethod
    def get(cls):
        if cls.conv is None:
            (conv_path, _), (quant_path, _) = build()
            conv, quant = ctypes.CDLL(str(conv_path)), ctypes.CDLL(str(quant_path))
            geo = ctypes.POINTER(ctypes.c_int)
            for fn in (conv.int8_conv_f32, conv.int8_conv_bf16):
                fn.argtypes = [ctypes.c_void_p] * 6 + [geo, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            conv.int8_conv_sums.argtypes = [ctypes.c_void_p] * 3 + [geo, ctypes.c_void_p]
            conv.int8_conv_sums.restype = ctypes.c_int
            for fn in (quant.int8_quantize_f32, quant.int8_quantize_bf16):
                fn.argtypes = [ctypes.c_void_p] * 4 + [geo, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            cls.conv, cls.quant = conv, quant
        return cls


def channel_multiple(c_in: int, device) -> int:
    """The multiple the kernels pad C_in to on `device`: 1 on the CPU, 4 where C_in <= 4,
    else 16."""
    if torch.device(device).type == "cpu":
        return 1
    return 4 if c_in <= 4 else 16


def quant_scale(amax):
    """max(amax, 1e-12) / 127 in float32 with IEEE division, as JAX's quantization: PyTorch's
    CUDA division by a host scalar multiplies by its reciprocal, which can differ in the last
    bit, so the divisor is a tensor."""
    return torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)


def quantize_weight(w, multiple: int = 1):
    """(wq (C_out, kh, kw, Cp) int8, sw (C_out,) float32) of float (C_out, C_in, kh, kw)
    filters, quantized per output channel in float32 as JAX's `Int8Conv2D` does; Cp is C_in
    zero-padded to a multiple of `multiple`."""
    wf = w.detach().float()
    sw = quant_scale(wf.abs().amax((1, 2, 3)))
    wq = torch.clamp(torch.round(wf / sw.view(-1, 1, 1, 1)), -127, 127).to(torch.int8)
    return F.pad(wq.permute(0, 2, 3, 1), (0, -w.shape[1] % multiple)).contiguous(), sw


def int8_quantize_plain(x, pad_to: int = 1):
    """Plain PyTorch version of the quantize kernel: (xq (B, H, W, Cp) int8 NHWC, sx (B,)
    float32) of NCHW `x`, Cp = C rounded up to a multiple of `pad_to`, padding zero."""
    xf = x.float()
    sx = quant_scale(xf.abs().amax((1, 2, 3)))
    q = torch.clamp(torch.round(xf / sx.view(-1, 1, 1, 1)), -127, 127)
    B, C, H, W = x.shape
    cp = -(-C // pad_to) * pad_to
    xq = (torch.zeros if cp != C else torch.empty)((B, H, W, cp), dtype=torch.int8,
                                                   device=x.device)
    xq[..., :C].copy_(q.permute(0, 2, 3, 1))
    return xq, sx


def quantize_geometry(shape, pad_to: int, itemsize: int, aligned: bool,
                      sample_stride: int | None = None) -> tuple:
    """The quantize kernel's arguments: (B, C, HW, Cp, abs-max slices a sample, values a
    slice, the abs-max's 16-byte loads (0/1), channels a tile, the quantize phase's loads of
    4 pixels (0/1), the samples' stride in values). `aligned`: the data starts on 16 bytes."""
    B, C, H, W = shape
    hw, cp = H * W, -(-C // pad_to) * pad_to
    per = C * hw
    stride = per if sample_stride is None else sample_stride
    aligned = aligned and stride % (16 // itemsize) == 0
    parts = max(1, min(-(-per // 8192), max(16, 512 // B), 256))
    slice_ = -(-per // parts)
    slice_ += -slice_ % 8
    parts = -(-per // slice_)
    vec = int(aligned and per % (16 // itemsize) == 0)
    ct = cp if cp in (4, 8, 16, 32) else 64
    return B, C, hw, cp, parts, slice_, vec, ct, int(aligned and hw % 4 == 0), stride


def _call(device, fn, *args) -> int:
    """fn(*args, stream) on `device`'s current stream, with `device` the current one."""
    index = device.index
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


@functools.lru_cache(maxsize=1024)
def _quantize_plan(shape, strides, dtype, pad_to: int, aligned: bool) -> tuple:
    """(copy first, geometry as a ctypes array, scratch floats, Cp, kernel) of a quantize call
    on a tensor of this shape, strides and dtype (`aligned`: its data starts on 16 bytes),
    checked once and kept."""
    if len(shape) != 4 or dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_quantize: x {dtype} {tuple(shape)}; the kernel reads 4-d NCHW "
                        "float32 or bfloat16")
    B, C, H, W = shape
    if min(shape) < 1:
        raise ValueError(f"int8_quantize: empty input {tuple(shape)}")
    # a channel slice (chunk's views) is read as it lies; another layout is copied first
    copy = strides[1:] != (H * W, W, 1) or strides[0] < C * H * W
    sample_stride = C * H * W if copy else strides[0]
    cp = -(-C // pad_to) * pad_to
    if cp % 4 or B * H * W * max(cp, C) >= 2 ** 31 or sample_stride * B >= 2 ** 31 or B > 4096:
        raise ValueError(f"int8_quantize: {tuple(shape)} padded to {cp} channels; the kernel "
                         "writes 4-byte words of fewer than 2^31 values")
    geo = quantize_geometry(shape, pad_to, dtype.itemsize, copy or aligned, sample_stride)
    lib = _Library.get().quant
    fn = lib.int8_quantize_f32 if dtype == torch.float32 else lib.int8_quantize_bf16
    return copy, (ctypes.c_int * len(geo))(*geo), B * geo[4] + B, cp, fn


def int8_quantize(x, pad_to: int = 1):
    """(xq (B, H, W, Cp) int8, sx (B,) float32) of NCHW `x`: the CUDA kernels for a CUDA
    tensor (float32 or bfloat16, read as it is), the plain version for a CPU tensor."""
    if not x.is_cuda:
        return int8_quantize_plain(x, pad_to)
    copy, geo, floats, cp, fn = _quantize_plan(x.shape, x.stride(), x.dtype, pad_to,
                                               x.data_ptr() % 16 == 0)
    if copy:
        x = x.contiguous()
    B, _, H, W = x.shape
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)  # partial maxima, sx
    xq = torch.empty((B, H, W, cp), dtype=torch.int8, device=x.device)
    sx_ptr = scratch.data_ptr() + 4 * (floats - B)
    rc = _call(x.device, fn, x.data_ptr(), scratch.data_ptr(), sx_ptr, xq.data_ptr(), geo)
    if rc != 0:
        raise RuntimeError(f"int8_quantize: kernel launch failed with CUDA error {rc}")
    _counted_quantize.launches += 1
    return xq, scratch[floats - B:]


_counted_quantize = int8_quantize  # holds the count, also while a caller wraps the name


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
    """Plain PyTorch version of the conv kernel."""
    return rescale(conv_sums_plain(xq, wq, stride, padding, dilation), sx, sw, bias, dtype)


def pick_tile(M: int, N: int, K: int, cp: int) -> int:
    """The conv kernel's tile (an index of TILES) for M pixels, N filters, K bytes of depth and
    Cp channels: among the tiles no wider in filters than N needs (and 128 pixels wide for the
    4-byte copies of Cp % 16 != 0), the first in TILES' order that gives at least 400 blocks
    (~3 an SM), else the one with the most blocks; where K >= 1024, only tiles at least 64
    filters wide, the first with 400 blocks, else 64x64 (a narrow tile reloads the wide pixel
    operand once per 16 or 32 filters). Set by a sweep of every tile at every int8 conv shape
    of yolov13n/l-JDE @640 b8 on an H100."""
    cap = 16
    while cap < min(N, 128):
        cap *= 2
    tiles = [t for t in TILES if t[0] <= cap and (cp % 16 == 0 or t[1] == 128)]

    def blocks(t):
        return -(-M // t[1]) * -(-N // t[0])
    if K >= 1024:
        tiles = [t for t in tiles if t[0] >= min(64, cap)]
        return TILES.index(next((t for t in tiles if blocks(t) >= 400), tiles[-1]))
    return TILES.index(next((t for t in tiles if blocks(t) >= 400), max(tiles, key=blocks)))


def plan(xq, wq, stride: int = 1, padding: int = 0, dilation: int = 1) -> dict:
    """The conv kernel's GEMM sizes and tile for these operands, with C_in padded to what the
    kernel reads: {"M", "N", "K", "Cp", "tile"}, as `_conv_plan` gives them to the launch."""
    return _conv_plan(xq.shape, wq.shape, stride, padding, dilation)[2]


@functools.lru_cache(maxsize=1024)
def _conv_plan(xq_shape, wq_shape, stride: int, padding: int, dilation: int) -> tuple:
    """(output shape, geometry as a ctypes array, {"M", "N", "K", "Cp", "tile"}) of a conv call
    on operands of these shapes, Cp being C_in padded to `channel_multiple`; checked once and
    kept."""
    if len(xq_shape) != 4 or len(wq_shape) != 4:
        raise TypeError(f"int8_conv: xq {tuple(xq_shape)} and wq {tuple(wq_shape)} must be 4-d "
                        "(NHWC and C_out, kh, kw, C)")
    B, H, W, C = xq_shape
    N, kh, kw, Cw = wq_shape
    if C != Cw or min(*xq_shape, *wq_shape, stride, dilation) < 1 or padding < 0:
        raise ValueError(f"int8_conv: C={C} against the filters' {Cw}, stride {stride}, "
                         f"padding {padding}, dilation {dilation}")
    Ho, Wo = out_size(H, kh, stride, padding, dilation), out_size(W, kw, stride, padding, dilation)
    cp = C + -C % channel_multiple(C, "cuda")
    if kh * kw * cp >= MAX_K:
        raise ValueError(f"int8_conv: K = {kh * kw * C} may overflow the int32 sums")
    if B * H * W * cp >= 2 ** 31 or B * Ho * Wo >= 2 ** 31 or min(Ho, Wo) < 1:
        raise ValueError(f"int8_conv: operands of {B * H * W * cp} values, output {Ho}x{Wo}")
    M, K = B * Ho * Wo, kh * kw * cp
    tile = pick_tile(M, N, K, cp)
    geo = (ctypes.c_int * 13)(B, H, W, cp, N, kh, kw, Ho, Wo, stride, padding, dilation, tile)
    return (B, N, Ho, Wo), geo, {"M": M, "N": N, "K": K, "Cp": cp, "tile": TILES[tile]}


def _launch(xq, wq, stride: int, padding: int, dilation: int, dtype, fn, *scales):
    """Check the operands (C_in padded already, as `Int8Conv2d` hands them over) and launch
    the kernel into a new (B, C_out, Ho, Wo) tensor of `dtype`."""
    out_shape, geo, sizes = _conv_plan(xq.shape, wq.shape, stride, padding, dilation)
    dev = xq.get_device()
    if dev < 0 or any(t.get_device() != dev for t in (wq, *scales)):
        raise ValueError(f"int8_conv: operands on {[t.device for t in (xq, wq, *scales)]}, "
                         "expected one CUDA device")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_conv: xq {xq.dtype} and wq {wq.dtype} must be int8")
    if xq.shape[3] != sizes["Cp"]:
        raise ValueError(f"int8_conv: {xq.shape[3]} channels; the kernel reads them padded to "
                         f"{sizes['Cp']} (channel_multiple)")
    xq, wq = xq.contiguous(), wq.contiguous()
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("int8_conv: operands not 16-byte aligned")
    scales = [t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()
              for t in scales]  # kept referenced until the launch
    out = torch.empty(out_shape, dtype=dtype, device=xq.device)
    rc = _call(xq.device, fn, xq.data_ptr(), wq.data_ptr(), *(t.data_ptr() for t in scales),
               out.data_ptr(), geo)
    if rc != 0:
        raise RuntimeError(f"int8_conv: kernel launch failed with CUDA error {rc}")
    return out


def int8_conv(xq, wq, sx, sw, bias, stride: int = 1, padding: int = 0, dilation: int = 1,
              dtype=torch.float32):
    """The rescaled int8 convolution (B, C_out, Ho, Wo) in `dtype` (float32 or bfloat16): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors. sx (B,), sw and bias
    (C_out,) float32."""
    if not xq.is_cuda:
        return int8_conv_plain(xq, wq, sx, sw, bias, stride, padding, dilation, dtype)
    lib = _Library.get().conv
    if dtype == torch.float32:
        fn = lib.int8_conv_f32
    elif dtype == torch.bfloat16:
        fn = lib.int8_conv_bf16
    else:
        raise TypeError(f"int8_conv: output dtype {dtype}; the kernel writes float32 or bfloat16")
    out = _launch(xq, wq, stride, padding, dilation, dtype, fn, sx, sw, bias)
    _counted.launches += 1
    return out


_counted = int8_conv  # the wrapper that holds the count, also while a caller wraps the name


def int8_conv_sums(xq, wq, stride: int = 1, padding: int = 0, dilation: int = 1):
    """The int32 sums (B, C_out, Ho, Wo): the kernel's for CUDA tensors (not counted in
    `int8_conv.launches`), the plain version's for CPU tensors."""
    if not xq.is_cuda:
        return conv_sums_plain(xq, wq, stride, padding, dilation).to(torch.int32)
    return _launch(xq, wq, stride, padding, dilation, torch.int32,
                   _Library.get().conv.int8_conv_sums)


def reset_launches():
    """Set both launch counts to 0."""
    _counted.launches = 0
    _counted_quantize.launches = 0


reset_launches()  # kernel launches in this process
