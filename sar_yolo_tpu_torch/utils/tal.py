"""Task-aligned assigner, axis-aligned and rotated boxes (port of `sar_yolo_tpu/utils/tal.py`).

Static shapes throughout, as in the JAX package: no boolean indexing and no
host synchronisation, so the whole assignment runs on the device inside the
loss.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn import functional as F

from sar_yolo_tpu_torch.ops.boxes import bbox_iou, probiou


class AssignResult(NamedTuple):
    target_labels: torch.Tensor   # (B, N) int64
    target_bboxes: torch.Tensor   # (B, N, 4) xyxy, rotated (B, N, 5) xywhr
    target_scores: torch.Tensor   # (B, N, nc)
    fg_mask: torch.Tensor         # (B, N) bool
    target_gt_idx: torch.Tensor   # (B, N) int64
    target_tags: torch.Tensor     # (B, N) int64, zeros without tags


@torch.no_grad()
def task_aligned_assigner(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt,
                          gt_tags=None, *, topk: int = 10, num_classes: int = 80,
                          alpha: float = 0.5, beta: float = 6.0, eps: float = 1e-9,
                          rotated: bool = False):
    """Assign ground truths to anchors by the metric score^alpha * CIoU^beta.

    pd_scores (B, N, nc) sigmoided scores; pd_bboxes (B, N, 4) xyxy in image
    units; anc_points (N, 2) in image units; gt_labels (B, M); gt_bboxes
    (B, M, 4) xyxy, padded rows zero; mask_gt (B, M) validity; gt_tags
    (B, M) person ids or None. `rotated`: boxes are xywhr (B, N, 5) and (B, M, 5); an
    anchor is a candidate where, in the ground truth's own frame, |dx| < w/2 - eps and
    |dy| < h/2 - eps (the JAX package's test), and the overlap is probiou.
    """
    B, N, nc = pd_scores.shape
    M = gt_bboxes.shape[1]
    dtype = pd_scores.dtype
    mask_gt_f = mask_gt.to(dtype)

    # candidates whose centre lies inside the ground-truth box: (B, M, N)
    if rotated:
        delta = anc_points[None, None] - gt_bboxes[:, :, None, :2]  # (B, M, N, 2)
        r = gt_bboxes[:, :, None, 4]
        cos, sin = torch.cos(r), torch.sin(r)
        dx = delta[..., 0] * cos + delta[..., 1] * sin
        dy = -delta[..., 0] * sin + delta[..., 1] * cos
        mask_in_gts = ((dx.abs() < gt_bboxes[:, :, None, 2] / 2 - eps) &
                       (dy.abs() < gt_bboxes[:, :, None, 3] / 2 - eps)).to(dtype)
    else:
        lt = anc_points[None, None] - gt_bboxes[:, :, None, :2]
        rb = gt_bboxes[:, :, None, 2:] - anc_points[None, None]
        mask_in_gts = (torch.minimum(lt.amin(-1), rb.amin(-1)) > eps).to(dtype)

    # alignment metric: the score of the ground truth's class times its CIoU
    gl = gt_labels.long().clamp(0, nc - 1)
    bbox_scores = pd_scores.transpose(1, 2).gather(1, gl[:, :, None].expand(B, M, N))
    valid = (mask_in_gts * mask_gt_f[:, :, None]).bool()
    if rotated:
        overlaps = probiou(gt_bboxes[:, :, None], pd_bboxes[:, None]).squeeze(-1)
    else:
        overlaps = bbox_iou(gt_bboxes[:, :, None], pd_bboxes[:, None], CIoU=True).squeeze(-1)
    overlaps = torch.where(valid, overlaps.clamp(0), 0.0).to(dtype)
    bbox_scores = torch.where(valid, bbox_scores, 0.0)
    align_metric = bbox_scores ** alpha * overlaps ** beta

    # per-gt top-k anchors as `topk` argmax-and-mask rounds: argmax returns the
    # first maximum, so ties go to the lower index as in the JAX package; a
    # round whose maximum is not positive picks nothing
    mask_topk = torch.zeros_like(align_metric)
    work = align_metric
    for _ in range(topk):
        val, idx = work.amax(-1, keepdim=True), work.argmax(-1, keepdim=True)
        pick = torch.zeros_like(work).scatter_(-1, idx, (val > 0).to(dtype))
        mask_topk = mask_topk + pick
        work = torch.where(pick > 0, -1.0, work)
    mask_pos = mask_topk * mask_in_gts * mask_gt_f[:, :, None]

    # an anchor matched to several ground truths keeps the one of largest overlap
    mask_multi = (mask_pos.sum(-2) > 1)[:, None]                         # (B, 1, N)
    is_max = F.one_hot(overlaps.argmax(1), M).to(dtype).transpose(1, 2)  # (B, M, N)
    mask_pos = torch.where(mask_multi, is_max, mask_pos)
    fg_mask = mask_pos.sum(-2) > 0
    target_gt_idx = mask_pos.argmax(-2)

    target_labels = gl.gather(1, target_gt_idx)
    target_bboxes = gt_bboxes.gather(1, target_gt_idx[..., None].expand(B, N, gt_bboxes.shape[-1]))
    target_scores = F.one_hot(target_labels, nc).to(dtype) * fg_mask[..., None].to(dtype)
    if gt_tags is not None:
        tags = gt_tags.long().gather(1, target_gt_idx)
        target_tags = torch.where(fg_mask, tags, 0)
    else:
        target_tags = torch.zeros_like(target_labels)

    # scores scaled by each ground truth's largest metric and overlap
    align_metric = align_metric * mask_pos
    pos_align = align_metric.amax(-1, keepdim=True)
    pos_overlap = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = (align_metric * pos_overlap / (pos_align + eps)).amax(-2)
    target_scores = target_scores * norm[..., None]
    return AssignResult(target_labels, target_bboxes, target_scores, fg_mask, target_gt_idx,
                        target_tags)
