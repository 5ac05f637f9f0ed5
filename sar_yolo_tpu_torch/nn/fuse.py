"""Deploy-time BatchNorm folding, in place (port of `sar_yolo_tpu/nn/fuse.py`).

Folds each `Conv`'s bn into its conv and each `DSConv`'s bn into its pointwise
conv (epsilon 1e-3), leaving a biased conv and `bn = None`: the module
structure of the JAX package's `fused=True` trace, so `utils/convert.py` maps
a JAX `fuse_variables` tree onto it. A BatchNorm anywhere else is a structure
this slice does not know, and `fuse_model` raises rather than serve it unfused.
`half_model` then takes a folded model to bf16 for `half` serving.
"""

from __future__ import annotations

import torch
from torch import nn

from sar_yolo_tpu_torch.nn.modules.conv import Conv, DSConv, set_compute_dtype


@torch.no_grad()
def _fold(conv: nn.Conv2d, bn: nn.BatchNorm2d):
    g = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    conv.weight.mul_(g.view(-1, 1, 1, 1))
    conv.bias = nn.Parameter(bn.bias - bn.running_mean * g)


def fuse_model(model: nn.Module) -> nn.Module:
    """Fold every BatchNorm of `model` into its conv, in place. Returns `model`."""
    for mod in list(model.modules()):
        if isinstance(mod, Conv) and mod.bn is not None:
            _fold(mod.conv, mod.bn)
            mod.bn = None
        elif isinstance(mod, DSConv) and mod.bn is not None:
            _fold(mod.pw, mod.bn)
            mod.bn = None
    left = [name for name, mod in model.named_modules() if isinstance(mod, nn.BatchNorm2d)]
    if left:
        raise ValueError(f"fuse_model: BatchNorm outside Conv/DSConv at {left[:5]}")
    return model


def half_model(model: nn.Module) -> nn.Module:
    """`half` serving, in place: the (already float32-folded) parameters and the compute
    in bf16, as the JAX package casts its fused variables and model. Returns `model`."""
    set_compute_dtype(model.to(torch.bfloat16), torch.bfloat16)
    return model
