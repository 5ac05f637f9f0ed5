"""The DETR loss of RT-DETR (port of `sar_yolo_tpu/utils/detr_loss.py`): Hungarian matching,
varifocal (or focal) class term, L1 and GIoU box terms, over the decoder layers and the
encoder's top-k, plus the contrastive-denoising branch.

The JAX package solves each assignment on its device inside the step
(`optax.assignment.hungarian_algorithm`). Here the matching costs of every layer and image
of a step (6 decoder layers and the encoder: 7 x B matrices of Q x M) are built on the
device in one batch, copied to the host in one transfer, each image's real-gt columns are
solved with `scipy.optimize.linear_sum_assignment`, and the indices go back to the device.
JAX gives padded gt rows a constant cost of 1e6, which moves no real row's optimum, so on
costs without ties both solvers give the same assignment.

The total is not scaled by the batch size (the reference sums the loss dict): the
matched-gt normalizer already follows the batch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from sar_yolo_tpu_torch.ops.boxes import bbox_iou, xywh2xyxy

COST_GAIN = {"class": 2.0, "bbox": 5.0, "giou": 2.0}
LOSS_GAIN = {"class": 1.0, "bbox": 5.0, "giou": 2.0}


class DETRLossOut(NamedTuple):
    total: torch.Tensor
    items: torch.Tensor  # (3,) cls, bbox, giou (summed over layers), detached


class Assignment(NamedTuple):
    index: torch.Tensor  # (L, B, M) query of each gt row (Q where the row is padding)
    n_gt: int            # the batch's valid gt count (it came to the host with the costs)


def _focal_cost(p, alpha: float = 0.25, gamma: float = 2.0):
    """Per-class focal matching cost of sigmoided scores."""
    neg = (1 - alpha) * p ** gamma * (-torch.log(1 - p + 1e-8))
    pos = alpha * (1 - p) ** gamma * (-torch.log(p + 1e-8))
    return pos - neg


def matching_costs(pred_boxes, pred_scores, gt_boxes, gt_cls, gt_mask):
    """Hungarian costs (..., Q, M) of predictions against the padded gt, on the device.

    pred_boxes (..., B, Q, 4) normalized cxcywh; pred_scores (..., B, Q, nc) logits;
    gt_boxes (B, M, 4); gt_cls (B, M); gt_mask (B, M). Non-finite costs and padded gt
    columns cost 1e6, as in the JAX package.
    """
    nc = pred_scores.shape[-1]
    p = torch.sigmoid(pred_scores)
    fc = _focal_cost(p)                                                  # (..., B, Q, nc)
    idx = gt_cls.long().clamp(0, nc - 1)[:, None, :].expand(*fc.shape[:-1], -1)
    cost_cls = torch.gather(fc, -1, idx)                                 # (..., B, Q, M)
    cost_bbox = (pred_boxes[..., :, None, :] - gt_boxes[:, None, :, :]).abs().sum(-1)
    giou = bbox_iou(xywh2xyxy(pred_boxes)[..., :, None, :],
                    xywh2xyxy(gt_boxes)[:, None, :, :], GIoU=True)[..., 0]
    cost = (COST_GAIN["class"] * cost_cls + COST_GAIN["bbox"] * cost_bbox +
            COST_GAIN["giou"] * (1 - giou))
    cost = torch.where(torch.isfinite(cost), cost, 1e6)
    return torch.where(gt_mask[:, None, :] > 0, cost, 1e6)


def solve_assignments(costs, gt_mask) -> Assignment:
    """Optimal assignments of (L, B, Q, M) costs: the (L, B, M) query index of each gt row
    (Q where the row is padding), on the costs' device, and the valid gt count. One copy to
    the host (the costs and the mask together), `linear_sum_assignment` on each image's
    real-gt columns, one copy back."""
    L, B, Q, M = costs.shape
    flat = torch.cat([costs.detach().float().reshape(-1),
                      gt_mask.float().reshape(-1)]).cpu().numpy()
    cost = flat[:L * B * Q * M].reshape(L, B, Q, M)
    valid = flat[L * B * Q * M:].reshape(B, M) > 0
    out = np.full((L, B, M), Q, np.int64)
    for b in range(B):
        cols = np.flatnonzero(valid[b])
        if not len(cols):
            continue
        for lyr in range(L):
            rows, q = linear_sum_assignment(cost[lyr, b][:, cols].T)
            out[lyr, b, cols[rows]] = q
    return Assignment(torch.from_numpy(out).to(costs.device, non_blocking=True),
                      int(valid.sum()))


def _bce_elem(logits, targets):
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _layer_terms(pred_boxes, pred_scores, gt_boxes, gt_cls, valid, assign_q, use_vfl: bool):
    """Raw sums (cls, l1, giou), each of shape (...), over the images (and groups) of a
    stack of layers.

    pred_boxes (..., Q, 4); pred_scores (..., Q, nc); gt_boxes (..., M, 4), gt_cls (..., M),
    valid (..., M) broadcast to the predictions' leading axes; assign_q (..., M) the query
    of each gt row (padded rows are skipped). VarifocalLoss where the batch has a gt, else
    FocalLoss (gamma 1.5, alpha 0.25) on the one-hot target.
    """
    *lead, Q, nc = pred_scores.shape
    M = assign_q.shape[-1]
    gt_boxes = gt_boxes.expand(*lead, M, 4)
    gt_cls = gt_cls.expand(*lead, M)
    valid = valid.expand(*lead, M)
    q = torch.where(valid, assign_q, Q)                                  # Q: a spare slot
    pb = torch.gather(pred_boxes, -2, assign_q.clamp(max=Q - 1)[..., None].expand(*lead, M, 4))
    matched_iou = bbox_iou(xywh2xyxy(pb), xywh2xyxy(gt_boxes))[..., 0].detach()
    tgt_scores = matched_iou.new_zeros((*lead, Q + 1)).scatter(
        -1, q, torch.where(valid, matched_iou.clamp(min=0), 0.0))[..., :Q]
    tgt_labels = torch.full((*lead, Q + 1), nc, device=pred_scores.device).scatter(
        -1, q, torch.where(valid, gt_cls.long(), nc))[..., :Q]
    onehot = torch.nn.functional.one_hot(tgt_labels, nc + 1)[..., :nc].to(matched_iou.dtype)
    p = torch.sigmoid(pred_scores)
    if use_vfl:
        gt_score_map = onehot * tgt_scores[..., None]
        cls = _bce_elem(pred_scores, gt_score_map) * (
            0.75 * p ** 2.0 * (1 - onehot) + gt_score_map)
    else:
        p_t = onehot * p + (1 - onehot) * (1 - p)
        cls = _bce_elem(pred_scores, onehot) * (1.0 - p_t) ** 1.5 * (
            onehot * 0.25 + (1 - onehot) * 0.75)
    l1 = (pb - gt_boxes).abs().sum(-1)
    giou = bbox_iou(xywh2xyxy(pb), xywh2xyxy(gt_boxes), GIoU=True)[..., 0]
    return (cls.sum((-2, -1)), torch.where(valid, l1, 0.0).sum(-1),
            torch.where(valid, 1 - giou, 0.0).sum(-1))


def dn_loss(dn_meta: dict, batch: dict, total_gt: int):
    """The contrastive-denoising branch: in each of the G groups query m of the positive
    half reconstructs gt row m and the negative half trains toward background; normalized
    by G x the batch's valid gt count. Returns (cls, bbox, giou) sums over the layers."""
    dn_boxes = dn_meta["dn_bboxes"].float()                              # (L, B, DN, 4)
    dn_scores = dn_meta["dn_scores"].float()                             # (L, B, DN, nc)
    G = dn_meta["G"]
    L, B, DN, nc = dn_scores.shape
    M2 = DN // G
    M = M2 // 2
    gt_boxes = batch["bboxes"].float()[:, None]                          # (B, 1, M, 4)
    gt_cls = batch["cls"].long()[:, None]
    valid = (batch["mask"] > 0)[:, None]
    assign = torch.arange(M, device=dn_scores.device).expand(L, B, G, M)
    denom = float(max(total_gt * G, 1))
    c, b, g = _layer_terms(dn_boxes.reshape(L, B, G, M2, 4), dn_scores.reshape(L, B, G, M2, nc),
                           gt_boxes, gt_cls, valid, assign, total_gt > 0)
    c, b, g = (t.sum((1, 2)) / denom for t in (c, b, g))
    if not total_gt:
        return c.sum(), torch.zeros_like(b.sum()), torch.zeros_like(g.sum())
    return c.sum(), b.sum(), g.sum()


def detr_loss(outputs, batch: dict, assign: Assignment | None = None) -> DETRLossOut:
    """Total RT-DETR loss over the decoder layers, the encoder's top-k and the CDN branch.

    outputs: (dec_bboxes (L, B, Q, 4), dec_scores (L, B, Q, nc), enc_bboxes, enc_scores
    [, dn_meta]); batch: padded {'cls' (B, M), 'bboxes' (B, M, 4) normalized xywh, 'mask'
    (B, M)} on the device. `assign`: the `solve_assignments` of the L + 1 layers when the
    caller made them (a step's timing splits them off); else they are made here.
    """
    dn_meta = outputs[4] if len(outputs) > 4 else None
    dec_bboxes, dec_scores, enc_bboxes, enc_scores = outputs[:4]
    gt_boxes = batch["bboxes"].float()
    gt_cls = batch["cls"]
    gt_mask = batch["mask"].float()
    all_boxes = torch.cat([dec_bboxes, enc_bboxes[None]], 0)
    all_scores = torch.cat([dec_scores, enc_scores[None]], 0)
    if assign is None:
        with torch.no_grad():
            assign = solve_assignments(matching_costs(all_boxes, all_scores, gt_boxes, gt_cls,
                                                      gt_mask), gt_mask)
    total_gt = assign.n_gt
    denom = float(max(total_gt, 1))
    c, b, g = _layer_terms(all_boxes, all_scores, gt_boxes, gt_cls, gt_mask > 0, assign.index,
                           total_gt > 0)
    lc, lb, lg = (t.sum(1) / denom for t in (c, b, g))
    lc = lc.sum()
    lb = lb.sum() if total_gt else torch.zeros_like(lb.sum())
    lg = lg.sum() if total_gt else torch.zeros_like(lg.sum())
    if dn_meta is not None:
        dc, db, dg = dn_loss(dn_meta, batch, total_gt)
        lc, lb, lg = lc + dc, lb + db, lg + dg
    items = torch.stack([LOSS_GAIN["class"] * lc, LOSS_GAIN["bbox"] * lb, LOSS_GAIN["giou"] * lg])
    return DETRLossOut(items.sum(), items.detach())
