"""Box geometry ops on tensors, axis-aligned and rotated (port of `sar_yolo_tpu/ops/boxes.py`)."""

from __future__ import annotations

import math

import torch


def xywh2xyxy(x):
    """(cx, cy, w, h) -> (x1, y1, x2, y2) on the last axis."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy2xywh(x):
    """(x1, y1, x2, y2) -> (cx, cy, w, h) on the last axis."""
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def bbox2dist(anchor_points, bbox, reg_max: float):
    """Encode xyxy boxes as (l, t, r, b) distances from anchor points, clamped to [0, reg_max - 0.01]."""
    x1y1, x2y2 = bbox.chunk(2, -1)
    return torch.cat([anchor_points - x1y1, x2y2 - anchor_points], -1).clamp(0, reg_max - 0.01)


def bbox_iou(box1, box2, xywh: bool = False, GIoU: bool = False, DIoU: bool = False,
             CIoU: bool = False, eps: float = 1e-7):
    """IoU / GIoU / DIoU / CIoU of broadcastable boxes (last axis 4). Returns (..., 1).

    CIoU's alpha carries no gradient (the JAX package's stop_gradient).
    """
    if xywh:
        box1, box2 = xywh2xyxy(box1), xywh2xyxy(box2)
    b1x1, b1y1, b1x2, b1y2 = box1.chunk(4, -1)
    b2x1, b2y1, b2x2, b2y2 = box2.chunk(4, -1)
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1
    inter = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(0) * \
            (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not (GIoU or DIoU or CIoU):
        return iou
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    if CIoU or DIoU:
        c2 = cw ** 2 + ch ** 2 + eps
        rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
        if CIoU:
            v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
            alpha = (v / (v - iou + (1 + eps))).detach()
            return iou - (rho2 / c2 + v * alpha)
        return iou - rho2 / c2
    c_area = cw * ch + eps
    return iou - (c_area - union) / c_area


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


def as_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x in `dtype`: x itself where it has it, so that a traced program holds no identity
    casts."""
    return x if x.dtype == dtype else x.to(dtype)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or as it is where it is float64 (a model computing in float64)."""
    return as_dtype(x, torch.promote_types(x.dtype, torch.float32))


def dfl_decode(pred_dist, reg_max: int = 16, dim: int = -1):
    """DFL decode: softmax over reg_max bins (in f32, f64 for f64) -> expected distance.

    pred_dist has 4 * reg_max channels along `dim` (side-major); returns 4 there.
    """
    dim = dim % pred_dist.dim()
    shape = pred_dist.shape
    p = at_least_f32(pred_dist.reshape(*shape[:dim], 4, reg_max, *shape[dim + 1:]))
    p = p.softmax(dim + 1)
    proj = torch.arange(reg_max, dtype=torch.float32, device=pred_dist.device)
    proj = proj.view(reg_max, *([1] * (len(shape) - dim - 1)))
    return as_dtype((p * proj).sum(dim + 1), pred_dist.dtype)


def _obb_covariance(boxes):
    """Gaussian covariance terms (a, b, c) of xywhr boxes, each (..., 1)."""
    w, h, r = boxes[..., 2:3], boxes[..., 3:4], boxes[..., 4:5]
    a = w ** 2 / 12.0
    b = h ** 2 / 12.0
    cos, sin = torch.cos(r), torch.sin(r)
    cos2, sin2 = cos ** 2, sin ** 2
    return a * cos2 + b * sin2, a * sin2 + b * cos2, (a - b) * cos * sin


def probiou(obb1, obb2, CIoU: bool = False, eps: float = 1e-7):
    """Probabilistic IoU (1 - the Hellinger distance of the boxes' Gaussians) of broadcastable
    xywhr boxes, (..., 1); the JAX package's arithmetic in its order. CIoU subtracts the
    aspect term v alpha, alpha carrying no gradient."""
    x1, y1 = obb1[..., 0:1], obb1[..., 1:2]
    x2, y2 = obb2[..., 0:1], obb2[..., 1:2]
    a1, b1, c1 = _obb_covariance(obb1)
    a2, b2, c2 = _obb_covariance(obb2)
    denom = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / denom * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / denom * 0.5
    det1 = (a1 * b1 - c1 ** 2).clamp(min=0)
    det2 = (a2 * b2 - c2 ** 2).clamp(min=0)
    t3 = torch.log(((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2) /
                   (4 * torch.sqrt(det1 * det2) + eps) + eps) * 0.5
    bd = (t1 + t2 + t3).clamp(eps, 100.0)
    hd = torch.sqrt(1.0 - torch.exp(-bd) + eps)
    iou = 1 - hd
    if CIoU:
        w1, h1 = obb1[..., 2:3], obb1[..., 3:4]
        w2, h2 = obb2[..., 2:3], obb2[..., 3:4]
        v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
        alpha = (v / (v - iou + (1 + eps))).detach()
        return iou - v * alpha
    return iou


def dist2rbox(pred_dist, pred_angle, anchor_points):
    """Rotated boxes (cx, cy, w, h) from (l, t, r, b) distances and an angle (..., 1) around
    anchor points: the offset (r - l, b - t) / 2 rotated by the angle."""
    lt, rb = pred_dist.chunk(2, -1)
    cos, sin = torch.cos(pred_angle), torch.sin(pred_angle)
    xf, yf = ((rb - lt) / 2).chunk(2, -1)
    x = xf * cos - yf * sin
    y = xf * sin + yf * cos
    xy = torch.cat([x, y], -1) + anchor_points
    return torch.cat([xy, lt + rb], -1)


def xywhr2xyxyxyxy(boxes):
    """xywhr -> the 4 corners (..., 4, 2)."""
    cx, cy, w, h, r = boxes.unbind(-1)
    cos, sin = torch.cos(r), torch.sin(r)
    dx1, dy1 = w / 2 * cos, w / 2 * sin
    dx2, dy2 = -h / 2 * sin, h / 2 * cos
    p1 = torch.stack([cx + dx1 + dx2, cy + dy1 + dy2], -1)
    p2 = torch.stack([cx + dx1 - dx2, cy + dy1 - dy2], -1)
    p3 = torch.stack([cx - dx1 - dx2, cy - dy1 - dy2], -1)
    p4 = torch.stack([cx - dx1 + dx2, cy - dy1 + dy2], -1)
    return torch.stack([p1, p2, p3, p4], -2)
