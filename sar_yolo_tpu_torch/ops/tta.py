"""Test-time augmentation: three passes at scales (1, 0.83, 0.67), the second flipped left to
right, their decoded predictions mapped back to the input's pixels and concatenated with the
tails clipped (port of `sar_yolo_tpu/ops/tta.py`).

Each pass resizes the (B, 3, H, W) batch bilinearly (`F.interpolate`, half-pixel centres, no
antialias: `jax.image.resize(..., "bilinear", antialias=False)`'s sampling at the same output
size) to (int(H s), int(W s)), pads bottom and right to a multiple of the largest stride with
0.447, runs the model, decodes, divides the boxes by s and mirrors the flipped pass's centres
about W. The full-scale pass drops its coarsest level and the smallest pass its finest,
counted from the real per-level anchor counts. Detect heads only: the callers warn and serve
one scale for any other head, as the JAX package does.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from sar_yolo_tpu_torch.ops.decode import decode_detect

TTA_SCALES = (1.0, 0.83, 0.67)
TTA_FLIPS = (None, "lr", None)


def scale_pad_image(x: torch.Tensor, ratio: float, gs: int = 32,
                    pad_value: float = 0.447) -> torch.Tensor:
    """(B, C, H, W) resized by `ratio` to (int(H ratio), int(W ratio)) and padded bottom and
    right to ceil(d ratio / gs) gs with `pad_value`; ratio 1 returns x."""
    if ratio == 1.0:
        return x
    H, W = x.shape[2:]
    nh, nw = int(H * ratio), int(W * ratio)
    xi = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False, antialias=False)
    ph = math.ceil(H * ratio / gs) * gs
    pw = math.ceil(W * ratio / gs) * gs
    return F.pad(xi, (0, pw - nw, 0, ph - nh), value=pad_value)


def forward_tta(model, x: torch.Tensor, strides, nc: int, reg_max: int = 16) -> torch.Tensor:
    """(B, N clipped, 4 + nc) decoded predictions of the three passes: xywh boxes in x's
    pixels, sigmoided scores, ready for `non_max_suppression`. `model`: a callable from a
    (B, 3, h, w) batch to the Detect head's per-level maps."""
    H, W = x.shape[2:]
    gs = int(max(strides))
    ys, level_counts = [], []
    for s, flip in zip(TTA_SCALES, TTA_FLIPS):
        xi = scale_pad_image(x.flip(3) if flip == "lr" else x, s, gs)
        feats = model(xi)
        level_counts.append([f.shape[2] * f.shape[3] for f in feats])
        p = decode_detect(feats, strides, nc, reg_max)
        box = p[..., :4] / s
        bx = W - box[..., 0:1] if flip == "lr" else box[..., 0:1]
        ys.append(torch.cat([bx, box[..., 1:4], p[..., 4:].to(box.dtype)], -1))
    ys[0] = ys[0][:, : -level_counts[0][-1]]
    ys[-1] = ys[-1][:, level_counts[-1][0]:]
    return torch.cat(ys, 1)
