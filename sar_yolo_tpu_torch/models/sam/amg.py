"""Automatic mask generation helpers (port of `sar_yolo_tpu/models/sam/amg.py`).

The mask statistics run on the device over the low-resolution (256 x 256 at 1024 px)
logits, so segment-everything never builds full-size masks for rejected candidates.
`remove_small_regions` labels 8-connected components with scipy in place of OpenCV's
`connectedComponentsWithStats`, numbered as OpenCV numbers them.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage


def build_point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) xy grid of cell centres in [0, 1], float32."""
    offset = 1.0 / (2 * n_per_side)
    pts = np.linspace(offset, 1.0 - offset, n_per_side, dtype=np.float32)
    gx, gy = np.meshgrid(pts, pts)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def stability_score(mask_logits, threshold: float = 0.0, offset: float = 1.0):
    """IoU of the masks binarized at threshold + offset and threshold - offset:
    (..., h, w) -> (...,) float32."""
    hi = (mask_logits > threshold + offset).sum((-1, -2)).to(torch.float32)
    lo = (mask_logits > threshold - offset).sum((-1, -2)).to(torch.float32)
    return hi / lo.clamp(min=1.0)


def batched_mask_to_box(masks):
    """Boolean masks (..., h, w) -> xyxy boxes (..., 4) float32, x2 / y2 one past the last
    pixel; an empty mask gives zeros."""
    h, w = masks.shape[-2:]
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)
    any_row, any_col = masks.any(-1), masks.any(-2)                     # (..., h), (..., w)
    big = torch.tensor(1e9, device=masks.device)
    y1 = torch.where(any_row, ys, big).amin(-1)
    y2 = torch.where(any_row, ys, -big).amax(-1)
    x1 = torch.where(any_col, xs, big).amin(-1)
    x2 = torch.where(any_col, xs, -big).amax(-1)
    box = torch.stack([x1, y1, x2 + 1, y2 + 1], -1)
    return torch.where(any_row.any(-1)[..., None], box, torch.zeros((), device=masks.device))


def connected_components(working: np.ndarray) -> tuple[int, np.ndarray, np.ndarray]:
    """(n_labels, labels, areas) of the 8-connected components of a 2-D 0/1 array, as
    `cv2.connectedComponentsWithStats(working, 8)` gives them: label 0 is the background
    (its area at index 0), the components numbered 1.. in the order in which OpenCV's
    block-based scan meets them: by the 2 x 2 block of their first pixel, blocks in raster
    order (no two components share a block under 8-connectivity)."""
    labels, n = ndimage.label(working, structure=np.ones((3, 3), int))
    if n:  # scipy's numbering -> OpenCV's
        r, c = np.nonzero(labels)
        first = np.full(n + 1, np.iinfo(np.int64).max)
        np.minimum.at(first, labels[r, c], (r // 2) * labels.shape[1] + c)
        remap = np.zeros(n + 1, np.int64)
        remap[np.argsort(first[1:], kind="stable") + 1] = np.arange(1, n + 1)
        labels = remap[labels]
    areas = np.bincount(labels.reshape(-1), minlength=n + 1)
    return n + 1, labels, areas


def remove_small_regions(mask: np.ndarray, area_thresh: float, mode: str):
    """Fill holes ('holes') or remove islands ('islands') smaller than `area_thresh`.
    Returns (mask, modified)."""
    correct_holes = mode == "holes"
    working = (correct_holes ^ mask).astype(np.uint8)
    n_labels, regions, areas = connected_components(working)
    sizes = areas[1:]
    small = [i + 1 for i, s in enumerate(sizes) if s < area_thresh]
    if not small:
        return mask, False
    fill = [0] + small
    if not correct_holes:
        fill = [i for i in range(n_labels) if i not in fill] or [int(np.argmax(sizes)) + 1]
    return np.isin(regions, fill), True
