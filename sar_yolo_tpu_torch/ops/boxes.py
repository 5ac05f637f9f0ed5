"""Box geometry ops on tensors (port of the serving subset of `sar_yolo_tpu/ops/boxes.py`)."""

from __future__ import annotations

import torch


def xywh2xyxy(x):
    """(cx, cy, w, h) -> (x1, y1, x2, y2) on the last axis."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def make_anchors(feat_hw, strides, grid_cell_offset: float = 0.5, device=None):
    """Anchor centres (N, 2) in grid units and strides (N, 1), levels concatenated."""
    points, strds = [], []
    for (h, w), s in zip(feat_hw, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=torch.float32, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        strds.append(torch.full((h * w, 1), float(s), dtype=torch.float32, device=device))
    return torch.cat(points, 0), torch.cat(strds, 0)


def dist2bbox(distance, anchor_points, xywh: bool = True, dim: int = -1):
    """Decode (l, t, r, b) distances around anchor points into boxes along `dim`."""
    lt, rb = distance.chunk(2, dim)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim)
    return torch.cat([x1y1, x2y2], dim)


def dfl_decode(pred_dist, reg_max: int = 16, dim: int = -1):
    """DFL decode: softmax over reg_max bins (in f32) -> expected distance.

    pred_dist has 4 * reg_max channels along `dim` (side-major); returns 4 there.
    """
    dim = dim % pred_dist.dim()
    shape = pred_dist.shape
    p = pred_dist.reshape(*shape[:dim], 4, reg_max, *shape[dim + 1:]).float().softmax(dim + 1)
    proj = torch.arange(reg_max, dtype=torch.float32, device=pred_dist.device)
    proj = proj.view(reg_max, *([1] * (len(shape) - dim - 1)))
    return (p * proj).sum(dim + 1).to(pred_dist.dtype)
