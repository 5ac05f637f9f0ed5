"""Deploy-time BatchNorm folding and branch merging, in place (port of
`sar_yolo_tpu/nn/fuse.py`).

Folds each `Conv`'s bn into its conv and each `DSConv`'s bn into its pointwise
conv (epsilon 1e-3), leaving a biased conv and `bn = None`, and merges the
parallel branches of the re-parameterizable blocks into one biased conv:
`Conv2` (k x k + 1x1 into one BN) keeps `conv` and drops cv2 and bn; `RepConv`
(3x3 + 1x1 Convs) becomes one 3x3 `conv`; `RepVGGDW` (depthwise 7x7 + 3x3
Convs) one depthwise 7x7 `conv`. That is the module structure of the JAX
package's `fused=True` trace, so `utils/convert.py` maps a JAX `fuse_variables`
tree onto it. A `StandaloneBatchNorm` (RT-DETR's input projections, YOLO-World's
contrastive heads) stays, as JAX's fold leaves it; a BatchNorm anywhere else is a
structure this port does not know, and `fuse_model` raises rather than serve it
unfused; the model is marked `fused`. `half_model` then takes a
folded model to bf16 for `half` serving, and `nn/modules/conv.py::quantize_int8` a folded
model to int8 serving (its `quant` then reads "int8"): with `half`, quantized in float32
from the bf16 weights, output in bf16, as the JAX package's `quant` on its bf16 trace.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from sar_yolo_tpu_torch.nn.modules.block import RepVGGDW
from sar_yolo_tpu_torch.nn.modules.conv import (Conv, Conv2, Conv2d, DSConv, RepConv,
                                                set_compute_dtype)
from sar_yolo_tpu_torch.nn.modules.transformer import StandaloneBatchNorm


def _scale_shift(bn: nn.BatchNorm2d):
    g = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return g, bn.bias - bn.running_mean * g


@torch.no_grad()
def _fold(conv: nn.Conv2d, bn: nn.BatchNorm2d):
    g, b = _scale_shift(bn)
    conv.weight.mul_(g.view(-1, 1, 1, 1))
    conv.bias = nn.Parameter(b)


def _folded(m: Conv, k: int):
    """(weight, bias) of a Conv with its BN folded, the kernel zero-padded to k x k."""
    g, b = _scale_shift(m.bn)
    w = m.conv.weight * g.view(-1, 1, 1, 1)
    p = (k - w.shape[-1]) // 2
    return F.pad(w, (p, p, p, p)), b


@torch.no_grad()
def _merged(big: Conv, small: Conv) -> Conv2d:
    """One biased Conv2d equal to big(x) + small(x) (two Convs without activation, the small
    kernel centred in the big one)."""
    k = big.conv.kernel_size[0]
    (w1, b1), (w2, b2) = _folded(big, k), _folded(small, k)
    c = big.conv
    out = Conv2d(c.in_channels, c.out_channels, k, c.stride, c.padding, dilation=c.dilation,
                 groups=c.groups, bias=True).to(w1.device, w1.dtype)
    out.weight.copy_(w1 + w2)
    out.bias.copy_(b1 + b2)
    out.compute_dtype = c.compute_dtype
    return out


def fuse_model(model: nn.Module) -> nn.Module:
    """Fold every BatchNorm of `model` into its conv and merge the re-parameterizable
    branches, in place. Returns `model`."""
    for mod in list(model.modules()):
        if isinstance(mod, RepConv) and mod.conv is None:
            mod.conv, mod.conv1, mod.conv2 = _merged(mod.conv1, mod.conv2), None, None
        elif isinstance(mod, RepVGGDW) and mod.conv1 is not None:
            mod.conv, mod.conv1 = _merged(mod.conv, mod.conv1), None
        elif isinstance(mod, Conv2) and mod.cv2 is not None:
            with torch.no_grad():
                k = mod.conv.kernel_size[0]
                p = (k // 2, k - 1 - k // 2)
                mod.conv.weight.add_(F.pad(mod.cv2.weight, (*p, *p)))
            _fold(mod.conv, mod.bn)
            mod.cv2, mod.bn = None, None
    for mod in list(model.modules()):
        if isinstance(mod, Conv) and mod.bn is not None:
            _fold(mod.conv, mod.bn)
            mod.bn = None
        elif isinstance(mod, DSConv) and mod.bn is not None:
            _fold(mod.pw, mod.bn)
            mod.bn = None
    left = [name for name, mod in model.named_modules()
            if isinstance(mod, nn.BatchNorm2d) and not isinstance(mod, StandaloneBatchNorm)]
    if left:
        raise ValueError(f"fuse_model: BatchNorm outside Conv/DSConv at {left[:5]}")
    model.fused = True
    return model


def half_model(model: nn.Module) -> nn.Module:
    """`half` serving, in place: the (already float32-folded) parameters and the compute
    in bf16, as the JAX package casts its fused variables and model. Returns `model`."""
    set_compute_dtype(model.to(torch.bfloat16), torch.bfloat16)
    return model
