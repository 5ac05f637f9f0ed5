"""Convolution building blocks in NCHW (port of `sar_yolo_tpu/nn/modules/conv.py`).

Submodules carry the Flax scope names of the JAX package (`conv`, `bn`, `dw`,
`pw`), so `utils/convert.py` maps weights between the two mechanically.
BatchNorm uses the JAX package's epsilon 1e-3 and momentum 0.97 (torch's
`momentum=0.03`), not torch's defaults.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

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


def batch_norm(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


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
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=False)
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
        self.dw = nn.Conv2d(c1, c1, k, s, pad, dilation=d, groups=c1, bias=False)
        self.pw = nn.Conv2d(c1, c2, 1, bias=False)
        self.bn = batch_norm(c2)

    def forward(self, x):
        x = self.pw(self.dw(x))
        if self.bn is not None:
            x = self.bn(x)
        return F.silu(x)


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
