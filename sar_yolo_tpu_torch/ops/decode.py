"""Prediction decode: raw NCHW head maps -> (B, N, 4 + nc + E) detections
(port of `sar_yolo_tpu/ops/decode.py`: `decode_detect`, `decode_obb`, `kpts_decode` and
`flatten_feats`)."""

from __future__ import annotations

import math

import torch

from .boxes import dfl_decode, dist2bbox, dist2rbox, make_anchors


def flatten_feats(feats):
    """[(B, C, H, W), ...] -> (B, sum(H*W), C) plus [(H, W), ...].

    Tokens are row-major per level, levels concatenated: the order of `make_anchors`.
    """
    hw = [(f.shape[2], f.shape[3]) for f in feats]
    return torch.cat([f.flatten(2).transpose(1, 2) for f in feats], 1), hw


def decode_detect(feats, strides, nc: int, reg_max: int = 16, extra_sigmoid: int = 0,
                  split_extras: int = 0, kpt_shape=None):
    """Decode per-level (B, 4*reg_max + nc + E, H, W) maps.

    Returns (B, N, 4 + nc + E): xywh boxes in input pixels, sigmoided class
    scores, then the extra channels with the last `extra_sigmoid` of them
    sigmoided (JDE states). With split_extras > 0 the first split_extras extra
    channels (JDE embeddings) come back separately, as a (B, N, split_extras)
    bank, and are left out of the predictions. With `kpt_shape` (K, D) the extras are
    pose keypoints: xy to input pixels as (k 2 + anchor - 0.5) stride, the visibility
    (D = 3) sigmoided. Tokens are row-major per level, levels concatenated, as in the JAX
    package.
    """
    outs, banks = [], []
    for f, s in zip(feats, strides):
        B, _, H, W = f.shape
        f = f.flatten(2)  # (B, C, H*W)
        box = f[:, :4 * reg_max]
        cls = f[:, 4 * reg_max:4 * reg_max + nc]
        extras = f[:, 4 * reg_max + nc:]
        anchors = make_anchors([(H, W)], [s], device=f.device)[0].T  # (2, H*W)
        dbox = dist2bbox(dfl_decode(box, reg_max, dim=1), anchors, xywh=True, dim=1) * float(s)
        parts = [dbox, cls.sigmoid()]
        if kpt_shape is not None and extras.shape[1]:
            K, D = kpt_shape
            k = extras.reshape(B, K, D, H * W)
            kxy = (k[:, :, :2] * 2.0 + (anchors[None, None] - 0.5)) * float(s)
            k = torch.cat([kxy, k[:, :, 2:].sigmoid()], 2) if D == 3 else kxy
            outs.append(torch.cat([*parts, k.reshape(B, K * D, H * W)], 1).transpose(1, 2))
            continue
        tail = extras[:, extras.shape[1] - extra_sigmoid:] if extra_sigmoid else extras[:, :0]
        mid = extras[:, :extras.shape[1] - extra_sigmoid]
        if split_extras:
            banks.append(mid[:, :split_extras].transpose(1, 2))
            mid = mid[:, split_extras:]
        if mid.shape[1]:
            parts.append(mid)
        if extra_sigmoid:
            parts.append(tail.sigmoid())
        outs.append(torch.cat(parts, 1).transpose(1, 2))
    preds = torch.cat(outs, 1)
    if split_extras:
        return preds, torch.cat(banks, 1)
    return preds


def kpts_decode(anchor_points, pred_kpts):
    """Keypoint offsets to grid units (the loss's): pred_kpts (B, N, K, D), xy -> xy 2 +
    anchor - 0.5, the rest as it is."""
    xy = pred_kpts[..., :2] * 2.0 + (anchor_points[None, :, None, :] - 0.5)
    return torch.cat([xy, pred_kpts[..., 2:]], -1)


def decode_obb(feats, strides, nc: int, reg_max: int = 16):
    """Decode per-level (B, 4*reg_max + nc + ne, H, W) OBB maps into (B, N, 4 + nc + 1):
    rotated xywh in input pixels (`dist2rbox` around the anchors, times the stride),
    sigmoided class scores, the angle (sigmoid - 0.25) pi of the first angle channel."""
    x, hw = flatten_feats(feats)
    anchors, stride_t = make_anchors(hw, strides, device=x.device)
    box = x[..., :4 * reg_max]
    cls = x[..., 4 * reg_max:4 * reg_max + nc]
    angle = (x[..., 4 * reg_max + nc:].sigmoid() - 0.25) * math.pi
    rbox = dist2rbox(dfl_decode(box, reg_max), angle[..., :1], anchors[None]) * stride_t[None]
    return torch.cat([rbox, cls.sigmoid(), angle[..., :1]], -1)
