"""Convolution building blocks in NCHW (port of `sar_yolo_tpu/nn/modules/conv.py`).

Submodules carry the Flax scope names of the JAX package (`conv`, `bn`, `dw`,
`pw`), so `utils/convert.py` maps weights between the two mechanically.
BatchNorm uses the JAX package's epsilon 1e-3 and momentum 0.97 (torch's
`momentum=0.03`), not torch's defaults, and Flax's train-mode statistics.

Precision follows Flax's `dtype=..., param_dtype=float32`: parameters stay
float32, and `Conv2d`, `ConvTranspose` and `Linear` cast their input and parameters to their
`compute_dtype` (set by `set_compute_dtype`; None: the parameters' dtype) and
output in it. A tensor that has that dtype already is not cast, so that a traced program
holds no identity casts. BatchNorm takes its statistics and normalizes in float32, then
returns the input's dtype.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn
from torch.nn import functional as F

from sar_yolo_tpu_torch.ops.boxes import as_dtype
from sar_yolo_tpu_torch.parallel import mesh as parallel

BN_EPS = 1e-3
BN_MOMENTUM = 0.03  # Flax momentum 0.97: running = 0.97 * running + 0.03 * batch


class _Mish(nn.Module):
    def forward(self, x):
        return x * torch.tanh(F.softplus(x))


# activation table of the yaml `activation:` key (JAX conv.py ACTIVATIONS)
ACTIVATIONS = {"silu": nn.SiLU, "relu": nn.ReLU, "relu6": nn.ReLU6,
               "leakyrelu": lambda: nn.LeakyReLU(0.01), "gelu": nn.GELU,
               "hardswish": nn.Hardswish, "mish": _Mish}
_DEFAULT_ACT = ["silu"]


class default_act:
    """Context manager: the activation that `Conv(act=True)` builds while it is active."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _DEFAULT_ACT.append(self.name)

    def __exit__(self, *exc):
        _DEFAULT_ACT.pop()


def autopad(k: int, p: int | None = None, d: int = 1) -> int:
    """'Same'-shape padding for stride-1 convs."""
    if d > 1:
        k = d * (k - 1) + 1
    if p is None:
        p = k // 2
    return p


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in `compute_dtype` (None: the weight's dtype)."""

    compute_dtype = None

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else as_dtype(self.bias, dt)
        return self._conv_forward(as_dtype(x, dt), as_dtype(self.weight, dt), bias)


class Int8Conv2d(Conv2d):
    """A fused Conv's biased convolution on the int8 path (the JAX package's `Int8Conv2D`):
    the same `weight` and `bias`, quantized symmetric in float32 whatever the serving
    dtype: the weights per output channel, the input per sample (abs-max / 127, divide,
    round half to even, clip to +-127); the int8 x int8 -> int32 convolution;
    float32(sums) * (sx * sw) + bias, output in the compute dtype. On the card the input's
    quantization is one kernel call and the convolution another (`ops/cuda/int8_conv.py`).
    The quantized weights, padded to the channels the kernels read, are kept until the
    weights change."""

    @classmethod
    def of(cls, conv: Conv2d) -> "Int8Conv2d":
        """An Int8Conv2d sharing `conv`'s parameters, stride, padding and dilation."""
        if conv.groups != 1 or conv.bias is None or len(set(conv.padding)) != 1 or \
                len(set(conv.stride)) != 1 or len(set(conv.dilation)) != 1:
            raise ValueError(f"Int8Conv2d: {conv} is not a biased dense square convolution")
        q = cls(conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride, conv.padding,
                conv.dilation, bias=True, device="meta")
        q.weight, q.bias, q.compute_dtype = conv.weight, conv.bias, conv.compute_dtype
        q.training = conv.training
        q._wq = None
        return q

    def quantized_weight(self):
        """(wq (C_out, kh, kw, Cp) int8, sw (C_out,) float32, bias (C_out,) float32), cached
        per weight and bias version; Cp is C_in zero-padded to `channel_multiple` on the
        weights' device (C_in itself on the CPU)."""
        from sar_yolo_tpu_torch.ops.cuda.int8_conv import channel_multiple, quantize_weight
        w, b = self.weight, self.bias
        key = (w._version, w.data_ptr(), w.dtype, b._version, b.data_ptr(), b.dtype)
        if self._wq is None or self._wq[0] != key:
            wq, sw = quantize_weight(w, channel_multiple(w.shape[1], w.device))
            self._wq = (key, wq, sw, b.detach().float())
        return self._wq[1:]

    def forward(self, x):
        from sar_yolo_tpu_torch.ops.cuda import int8_conv as ic
        dt = self.compute_dtype or self.weight.dtype
        wq, sw, bias = self.quantized_weight()
        xq, sx = ic.int8_quantize(x, ic.channel_multiple(x.shape[1], x.device))
        return ic.int8_conv(xq, wq, sx, sw, bias, self.stride[0], self.padding[0],
                            self.dilation[0], dt)


class ConvTranspose(nn.ConvTranspose2d):
    """nn.ConvTranspose2d computing in `compute_dtype` (None: the weight's dtype)."""

    compute_dtype = None

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else as_dtype(self.bias, dt)
        return F.conv_transpose2d(as_dtype(x, dt), as_dtype(self.weight, dt), bias, self.stride,
                                  self.padding, self.output_padding, self.groups, self.dilation)


class Linear(nn.Linear):
    """nn.Linear computing in `compute_dtype` (None: the weight's dtype)."""

    compute_dtype = None

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        return F.linear(as_dtype(x, dt), as_dtype(self.weight, dt), as_dtype(self.bias, dt))


def quantize_int8(model: nn.Module) -> int:
    """int8 serving of a fused model, in place: the conv of every BN-folded `Conv` (a
    `DWConv` too) with groups == 1 becomes an `Int8Conv2d`, as the JAX package's `Conv`
    takes `Int8Conv2D` in fused mode under `quant_mode("int8")`; `DSConv` and the heads'
    plain convolutions stay. Returns the count of quantized convolutions."""
    n = 0
    for m in model.modules():
        if isinstance(m, Conv) and m.bn is None and m.conv.groups == 1 and \
                not isinstance(m.conv, Int8Conv2d):
            m.conv = Int8Conv2d.of(m.conv)
            n += 1
    return n


def set_compute_dtype(model: nn.Module, dtype):
    """Run every Conv2d, ConvTranspose and Linear of `model` in `dtype` (its parameters keep
    theirs), and give every module that marks itself `follows_compute_dtype` (LayerNorm,
    Embed, a standalone BatchNorm) that output dtype. float32 means the parameters' own
    dtype, so a `.double()` copy computes in float64."""
    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose, Linear)) or \
                getattr(m, "follows_compute_dtype", False):
            m.compute_dtype = None if dtype == torch.float32 else dtype
    model.compute_dtype = dtype


_FROZEN_STATS = [False]


@contextlib.contextmanager
def frozen_bn_stats():
    """While active, train-mode BatchNorm leaves its running statistics as they are
    (a checkpointed block's recomputation must not move them a second time)."""
    _FROZEN_STATS.append(True)
    try:
        yield
    finally:
        _FROZEN_STATS.pop()


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with Flax's train-mode statistics and float32 reductions.

    Train mode normalizes with the biased batch variance max(E[x^2] - E[x]^2, 0)
    (Flax's `use_fast_variance`) and moves the running mean and variance toward
    the batch mean and that same variance at momentum 0.97. Gradients flow
    through the batch statistics. Under a process group of more than one rank
    (`parallel/`), E[x] and E[x^2] are the global batch's: sum(x), sum(x^2) and the
    count are all-reduced with autograd, as the JAX package's BN reduces over the
    sharded batch; every rank issues the same collectives in the same order (remat's
    recomputation and `frozen_bn_stats` included). Eval mode is torch's where the input has the
    parameters' dtype. Statistics and normalization run in at least float32 and the
    output takes the input's dtype, as Flax's BatchNorm with `dtype` does.
    """

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # Flax: at least float32
        if not self.training:
            if x.dtype == self.weight.dtype:
                return super().forward(x)
            mean, var = self.running_mean, self.running_var
        elif parallel.rank_and_world()[1] > 1:  # the global batch's statistics
            n = torch.full((1,), xf.numel() // xf.shape[1], dtype=xf.dtype, device=xf.device)
            sums = parallel.all_reduce_sum(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), n]))
            mean, ex2 = sums[:-1].view(2, -1) / sums[-1]
            var = (ex2 - mean * mean).clamp(min=0.0)
        else:
            mean = xf.mean((0, 2, 3))
            var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp(min=0.0)
        if self.training and not _FROZEN_STATS[-1]:
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.copy_(keep * self.running_mean + (1 - keep) * mean)
                self.running_var.copy_(keep * self.running_var + (1 - keep) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def batch_norm(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class Dropout(nn.Module):
    """Dropout whose masks come from `generator`, a torch.Generator on the input's device.

    Active in train mode with p > 0, where a missing generator raises: the
    trainer hands every Dropout its seeded generator (`set_generator`), so no
    mask comes from torch's global RNG. Under a process group each rank draws the
    global batch's masks and keeps its rows.
    """

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in train mode needs a generator (see set_generator)")
        rank, world = parallel.rank_and_world()
        # under a process group, the masks of the global batch, this rank's rows of them
        draw = torch.rand((x.shape[0] * world, *x.shape[1:]), generator=self.generator,
                          device=x.device)
        keep = draw[parallel.local_rows(len(draw))] >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


def set_generator(model: nn.Module, generator: torch.Generator):
    """Give every Dropout of `model` the generator its masks come from."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def _activation(act) -> nn.Module:
    if act is True:
        return ACTIVATIONS[_DEFAULT_ACT[-1]]()
    if isinstance(act, nn.Module):
        return act
    return nn.Identity()


class Conv(nn.Module):
    """Conv2d (no bias) + BatchNorm + activation. After `nn/fuse.py`, conv has a bias and bn is None."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, d: int = 1, act=True):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=False)
        self.bn = batch_norm(c2)
        self.act = _activation(act)

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)


class DWConv(Conv):
    """Depthwise conv block (groups = gcd(c1, c2)); its conv/bn sit in its own scope, as in JAX."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, d: int = 1, act=True):
        super().__init__(c1, c2, k, s, None, math.gcd(c1, c2), d, act)


class DSConv(nn.Module):
    """Depthwise-separable conv: depthwise kxk, pointwise 1x1, one BN and SiLU on the output."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, p: int | None = None, d: int = 1):
        super().__init__()
        pad = p if p is not None else (d * (k - 1)) // 2
        self.dw = Conv2d(c1, c1, k, s, pad, dilation=d, groups=c1, bias=False)
        self.pw = Conv2d(c1, c2, 1, bias=False)
        self.bn = batch_norm(c2)

    def forward(self, x):
        x = self.pw(self.dw(x))
        if self.bn is not None:
            x = self.bn(x)
        return F.silu(x)


class ChannelAttention(nn.Module):
    """Channel gate: the global mean, a 1x1 conv with bias, a sigmoid; x times the gate."""

    def __init__(self, c: int):
        super().__init__()
        self.fc = Conv2d(c, c, 1, bias=True)

    def forward(self, x):
        return x * torch.sigmoid(self.fc(x.mean((2, 3), keepdim=True)))


class SpatialAttention(nn.Module):
    """Spatial gate: the channel mean and max, a k x k conv without bias, a sigmoid."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.cv1 = Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False)

    def forward(self, x):
        pooled = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        return x * torch.sigmoid(self.cv1(pooled))


class CBAM(nn.Module):
    """Convolutional Block Attention Module: channel attention, then spatial attention."""

    def __init__(self, c1: int, kernel_size: int = 7):
        super().__init__()
        self.channel_attention = ChannelAttention(c1)
        self.spatial_attention = SpatialAttention(kernel_size)

    def forward(self, x):
        return self.spatial_attention(self.channel_attention(x))


class Concat(nn.Module):
    """Concatenate a list of NCHW maps along channels."""

    def forward(self, xs):
        return torch.cat(xs, 1)


class Upsample(nn.Module):
    """Nearest-neighbour upsample by an integer factor, as a repeat."""

    def __init__(self, scale: int = 2, mode: str = "nearest"):
        super().__init__()
        if mode != "nearest":
            raise ValueError(f"Upsample mode '{mode}' is not supported (nearest only)")
        self.scale = int(scale)

    def forward(self, x):
        return x.repeat_interleave(self.scale, 2).repeat_interleave(self.scale, 3)


class LightConv(nn.Module):
    """1x1 Conv without activation, then a depthwise k x k Conv with ReLU."""

    def __init__(self, c1: int, c2: int, k: int = 1):
        super().__init__()
        self.conv1 = Conv(c1, c2, 1, act=False)
        self.conv2 = DWConv(c2, c2, k, act=nn.ReLU())

    def forward(self, x):
        return self.conv2(self.conv1(x))


class RepConv(nn.Module):
    """RepVGG conv: a k x k and a 1x1 Conv (no activation) in parallel, summed, then SiLU
    (whatever the model's default activation). `nn/fuse.py` folds both branches into one
    biased k x k `conv` and drops conv1 and conv2."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        self.conv1 = Conv(c1, c2, k, s, act=False)
        self.conv2 = Conv(c1, c2, 1, s, act=False)
        self.conv = None

    def forward(self, x):
        if self.conv is not None:
            return F.silu(self.conv(x))
        return F.silu(self.conv1(x) + self.conv2(x))


class Conv2(nn.Module):
    """A k x k and a 1x1 convolution in parallel into one BatchNorm, then the activation.
    After `nn/fuse.py`, `conv` carries both and a bias, and cv2 and bn are None."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, p: int | None = None,
                 g: int = 1, d: int = 1, act=True):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=False)
        self.cv2 = Conv2d(c1, c2, 1, s, autopad(1, p, d), groups=g, bias=False)
        self.bn = batch_norm(c2)
        self.act = _activation(act)

    def forward(self, x):
        y = self.conv(x)
        if self.cv2 is not None:
            y = self.bn(y + self.cv2(x))
        return self.act(y)


class GhostConv(nn.Module):
    """Ghost convolution: a primary Conv to c2 / 2 channels, and a cheap 5x5 depthwise Conv
    of it, concatenated."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1, act=True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, None, g, act=act)
        self.cv2 = Conv(c_, c_, 5, 1, None, c_, act=act)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class Index(nn.Module):
    """One tensor of a list input."""

    def __init__(self, c2: int = 0, index: int = 0):
        super().__init__()
        self.index = index

    def forward(self, xs):
        return xs[self.index]


class ConvTranspose2d(nn.Module):
    """The YAML's `nn.ConvTranspose2d [c2, k, s, p]`: a biased transposed convolution
    (`conv`), no BatchNorm or activation; output side (H - 1) s - 2p + k."""

    def __init__(self, c1: int, c2: int, k: int = 2, s: int = 2, p: int = 0):
        super().__init__()
        self.conv = ConvTranspose(c1, c2, k, s, p, bias=True)

    def forward(self, x):
        return self.conv(x)


class MaxPool2d(nn.Module):
    """The YAML's `nn.MaxPool2d [k, s, p]` (padding with -inf)."""

    def __init__(self, k: int = 2, s: int = 2, p: int = 0):
        super().__init__()
        self.k, self.s, self.p = k, s, p

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p)


class ZeroPad2d(nn.Module):
    """The YAML's `nn.ZeroPad2d [[left, right, top, bottom]]`."""

    def __init__(self, pads: tuple = (0, 1, 0, 1)):
        super().__init__()
        self.pads = tuple(pads)

    def forward(self, x):
        return F.pad(x, self.pads)


class Identity(nn.Module):
    """The YAML's `nn.Identity` (yolov9e's input tap)."""

    def forward(self, x):
        return x
