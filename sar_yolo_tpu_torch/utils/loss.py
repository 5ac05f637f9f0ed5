"""Training losses: v8 detection (BCE + CIoU + DFL), v13 JDE (+ triplet embedding
+ class-balanced focal state), v8 pose (+ OKS keypoints and visibility), v8 segment
(+ prototype mask BCE), v8 OBB (probiou + DFL on the hull) and classification
(cross-entropy), port of `sar_yolo_tpu/utils/loss.py`.

Everything is float32 (float64 where the model computes in float64) and of static
shape: masked sums instead of boolean indexing, so no loss term synchronises the host.
The class-balanced state counts are explicit state that the caller threads through the
steps.
`batch` holds device tensors: 'cls' (B, M), 'bboxes' (B, M, 4) normalized
xywh, 'mask' (B, M) and, for JDE, 'tags' (B, M); for pose 'keypoints' (B, M, K, D)
(normalized xy, visibility), for segment 'masks' (B, h, w) (0 background, i + 1 the
i-th instance); OBB's 'bboxes' are (B, M, 5) normalized xywh and the angle in radians;
classify's batch is 'cls' (B,) alone.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.nn import functional as F

from sar_yolo_tpu_torch.ops.boxes import (at_least_f32, bbox2dist, bbox_iou, dfl_decode,
                                          dist2bbox, dist2rbox, make_anchors, probiou, xywh2xyxy)
from sar_yolo_tpu_torch.nn.modules.block import resize_nearest
from sar_yolo_tpu_torch.ops.decode import flatten_feats, kpts_decode
from sar_yolo_tpu_torch.ops.masks import crop_mask
from sar_yolo_tpu_torch.utils.tal import task_aligned_assigner


def _bce_logits(logits, targets):
    """Elementwise binary cross-entropy on logits."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _df_loss(pred_dist, target, reg_max: int):
    """Distribution focal loss per anchor.

    pred_dist: (..., 4, reg_max) logits; target: (..., 4) in [0, reg_max - 1).
    Returns (...,), the mean over the 4 sides.
    """
    target = target.clamp(0, reg_max - 1 - 0.01)
    tl = target.floor().long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    logp = F.log_softmax(at_least_f32(pred_dist), -1)
    pl = logp.gather(-1, tl[..., None]).squeeze(-1)
    pr = logp.gather(-1, tr.clamp(max=reg_max - 1)[..., None]).squeeze(-1)
    return -(pl * wl + pr * wr).mean(-1)


def _box_terms(x, hw, batch, *, nc: int, reg_max: int, strides, tal_topk: int, tags: bool):
    """Assignment and the box, cls and DFL terms of flattened head output x (B, N, C)."""
    B, N, _ = x.shape
    pred_distri = at_least_f32(x[..., :4 * reg_max])
    pred_scores = at_least_f32(x[..., 4 * reg_max:4 * reg_max + nc])
    anchor_points, stride_t = make_anchors(hw, strides, device=x.device)
    imgsz_h, imgsz_w = hw[0][0] * strides[0], hw[0][1] * strides[0]
    scale = torch.tensor([imgsz_w, imgsz_h, imgsz_w, imgsz_h], dtype=torch.float32,
                         device=x.device)
    gt_bboxes = xywh2xyxy(batch["bboxes"].float() * scale)
    mask_gt = batch["mask"].float() * (gt_bboxes.sum(-1) > 0)

    pred_bboxes = dist2bbox(dfl_decode(pred_distri, reg_max), anchor_points[None], xywh=False)
    assign = task_aligned_assigner(
        pred_scores.detach().sigmoid(), pred_bboxes.detach() * stride_t[None],
        anchor_points * stride_t, batch["cls"].long(), gt_bboxes, mask_gt,
        batch["tags"].long() if tags else None, topk=tal_topk, num_classes=nc)

    tss = assign.target_scores.sum().clamp(min=1.0)
    fg = assign.fg_mask.float()
    loss_cls = _bce_logits(pred_scores, assign.target_scores).sum() / tss
    target_bboxes = assign.target_bboxes / stride_t[None]
    weight = assign.target_scores.sum(-1) * fg
    iou = bbox_iou(pred_bboxes, target_bboxes, CIoU=True).squeeze(-1)
    loss_box = ((1.0 - iou) * weight).sum() / tss
    target_ltrb = bbox2dist(anchor_points[None], target_bboxes, reg_max - 1)
    loss_dfl = (_df_loss(pred_distri.reshape(B, N, 4, reg_max), target_ltrb, reg_max)
                * weight).sum() / tss
    return loss_box, loss_cls, loss_dfl, assign, pred_scores


class DetLossOut(NamedTuple):
    total: torch.Tensor
    items: torch.Tensor  # (3,) box, cls, dfl, detached


def detection_loss(feats, batch, hyp, *, nc: int, reg_max: int, strides, tal_topk: int = 10):
    """v8 detection loss of per-level (B, 4*reg_max + nc, H, W) maps over padded targets.

    Returns the total (scaled by the batch size) and the gained parts.
    """
    x, hw = flatten_feats(feats)
    box, cls, dfl, _, _ = _box_terms(x, hw, batch, nc=nc, reg_max=reg_max, strides=strides,
                                     tal_topk=tal_topk, tags=False)
    items = torch.stack([box * hyp.box, cls * hyp.cls, dfl * hyp.dfl])
    return DetLossOut(items.sum() * x.shape[0], items.detach())


def triplet_embedding_loss(embeds, tags, conf, valid, *, margin: float = 0.075,
                           conf_fraction: float = 0.5, n_total=None):
    """Hard-positive / semi-hard-negative triplet loss over K fixed candidates.

    Distances are L2 between unit-normalized embeddings. The candidates kept
    are the floor(conf_fraction * n_total) most confident valid ones (ties at
    the cut all kept). An anchor without a negative farther than its hardest
    positive is dropped; the mean runs over triplets with loss > 0 only.

    embeds (K, D); tags (K,) person ids; conf (K,); valid (K,) bool; n_total:
    the foreground count before the top-K gather (defaults to valid.sum()).
    """
    K = embeds.shape[0]
    n_valid = valid.sum()
    nt = n_total if n_total is not None else n_valid
    keep = torch.minimum(torch.floor(conf_fraction * nt.float()).long(), n_valid)
    conf_m = torch.where(valid, conf, -math.inf)
    thresh = conf_m.sort(descending=True).values[(keep - 1).clamp(0, K - 1)]
    sel = valid & (conf_m >= thresh) & (keep > 0)

    e = embeds / embeds.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    sq = ((e[:, None, :] - e[None, :, :]) ** 2).sum(-1)
    # zero-distance pairs get zero gradient, not 1/sqrt(eps)
    d = torch.where(sq > 1e-12, sq, 1e-12).sqrt()
    same = tags[:, None] == tags[None, :]
    pair_ok = sel[:, None] & sel[None, :]
    eye = torch.eye(K, dtype=torch.bool, device=embeds.device)
    pos_mask = same & ~eye & pair_ok
    neg_mask = ~same & pair_ok

    big = 1e9
    hard_pos = torch.where(pos_mask, d, -big).amax(1)
    semi = neg_mask & (d > hard_pos[:, None])
    semi_min = torch.where(semi, d, big).amin(1)
    anchor_ok = sel & pos_mask.any(1) & semi.any(1)
    per_anchor = (hard_pos - semi_min + margin).clamp(min=0.0)
    nz = anchor_ok & (per_anchor > 0)
    return torch.where(nz, per_anchor, 0.0).sum() / nz.sum().clamp(min=1)


class JDELossOut(NamedTuple):
    total: torch.Tensor
    items: torch.Tensor      # (5,) box, cls, dfl, emb, state, detached
    cb_counts: torch.Tensor  # updated class-balanced EMA counts (state_classes,), detached


def jde_loss_components(feats, batch, hyp, *, nc: int, reg_max: int, strides, embed_dim: int,
                        state_classes: int, cb_counts, tal_topk: int = 10, triplet_k: int = 128):
    """Raw (ungained) JDE loss components; see jde_loss."""
    x, hw = flatten_feats(feats)
    B, N, _ = x.shape
    c0 = 4 * reg_max + nc
    pred_embeds = at_least_f32(x[..., c0:c0 + embed_dim])
    pred_states = at_least_f32(x[..., c0 + embed_dim:])
    loss_box, loss_cls, loss_dfl, assign, pred_scores = _box_terms(
        x, hw, batch, nc=nc, reg_max=reg_max, strides=strides, tal_topk=tal_topk, tags=True)
    fg = assign.fg_mask.float()

    # triplet loss on the most confident foreground anchors; a stable sort
    # breaks ties toward the lower index, as lax.top_k does
    conf_all = (pred_scores.detach().sigmoid().amax(-1) * fg).reshape(-1)
    k = min(triplet_k, conf_all.shape[0])
    top_conf, top_idx = conf_all.sort(descending=True, stable=True)
    top_conf, top_idx = top_conf[:k], top_idx[:k]
    loss_emb = triplet_embedding_loss(
        pred_embeds.reshape(-1, embed_dim)[top_idx], assign.target_tags.reshape(-1)[top_idx],
        top_conf, top_conf > 0, n_total=assign.fg_mask.sum())

    # state loss: focal cross-entropy with class-balanced EMA weights, foreground only;
    # the target tags clamped into the state range are the state labels
    onehot = F.one_hot(assign.target_tags.clamp(0, state_classes - 1), state_classes).float()
    ce = -(onehot * F.log_softmax(pred_states, -1)).sum(-1)
    focal_w = (1.0 - torch.exp(-ce)) ** hyp.state_focal_gamma
    cb_beta = hyp.state_cb_beta
    new_counts = cb_beta * cb_counts + (1.0 - cb_beta) * (onehot * fg[..., None]).sum((0, 1))
    if hyp.use_state_cb:
        eps = 1e-8
        # 1 - beta^n as -expm1(n log beta), with log beta in float32 as in the JAX package
        log_beta = torch.log(torch.tensor(cb_beta, dtype=torch.float32, device=x.device))
        cb_raw = (1.0 - cb_beta) / (-torch.expm1(new_counts * log_beta)).clamp(min=eps)
        # normalized over the classes seen so far: an unseen class has weight ~1/eps
        seen = (new_counts > 1e-6).float()
        seen_mean = (cb_raw * seen).sum() / seen.sum().clamp(min=1.0)
        cb_w = torch.where(seen > 0, cb_raw / (seen_mean + eps), 1.0)
        sample_w = (onehot * cb_w).sum(-1)
    else:
        sample_w = torch.ones_like(ce)
    loss_state = (sample_w * focal_w * ce * fg).sum() / fg.sum().clamp(min=1.0)
    return {"box": loss_box, "cls": loss_cls, "dfl": loss_dfl, "emb": loss_emb,
            "state": loss_state, "cb_counts": new_counts, "batch_size": B}


def jde_loss(feats, batch, hyp, *, nc: int, reg_max: int, strides, embed_dim: int,
             state_classes: int, cb_counts, tal_topk: int = 10, triplet_k: int = 128):
    """v13 JDE loss: box + cls + dfl + triplet embedding + class-balanced focal state.

    cb_counts: (state_classes,) EMA class counts; the updated counts come back.
    """
    c = jde_loss_components(feats, batch, hyp, nc=nc, reg_max=reg_max, strides=strides,
                            embed_dim=embed_dim, state_classes=state_classes,
                            cb_counts=cb_counts, tal_topk=tal_topk, triplet_k=triplet_k)
    items = torch.stack([c["box"] * hyp.box, c["cls"] * hyp.cls, c["dfl"] * hyp.dfl,
                         c["emb"] * hyp.clr,
                         c["state"] * hyp.state])
    return JDELossOut(items.sum() * c["batch_size"], items.detach(), c["cb_counts"].detach())


# COCO's 17 keypoint OKS sigmas
OKS_SIGMA = torch.tensor([0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
                          0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089])


class PoseLossOut(NamedTuple):
    total: torch.Tensor
    items: torch.Tensor  # (5,) box, pose, kobj, cls, dfl, detached


def _grid(hw, strides, device):
    """(anchor points (N, 2), strides (N, 1), input width, input height) of the maps."""
    anchor_points, stride_t = make_anchors(hw, strides, device=device)
    return anchor_points, stride_t, hw[0][1] * strides[0], hw[0][0] * strides[0]


def pose_loss(feats, batch, hyp, *, nc: int, reg_max: int, strides, kpt_shape=(17, 3),
              tal_topk: int = 10):
    """v8 pose loss: the detection terms, the OKS keypoint term (COCO's sigmas where K is 17,
    else 1 / K; the target box area in grid units) and the visibility BCE, both over the
    foreground anchors' K keypoints."""
    x, hw = flatten_feats(feats)
    B, N, _ = x.shape
    K, kdim = kpt_shape
    loss_box, loss_cls, loss_dfl, assign, _ = _box_terms(
        x, hw, batch, nc=nc, reg_max=reg_max, strides=strides, tal_topk=tal_topk, tags=False)
    anchor_points, stride_t, imgsz_w, imgsz_h = _grid(hw, strides, x.device)
    fg = assign.fg_mask.float()
    pred_kpts = kpts_decode(anchor_points,
                            at_least_f32(x[..., 4 * reg_max + nc:]).reshape(B, N, K, kdim))

    gt = batch["keypoints"].float()  # (B, M, K, D) normalized
    gt = torch.cat([gt[..., :1] * imgsz_w, gt[..., 1:2] * imgsz_h, gt[..., 2:]], -1)
    sel = gt.gather(1, assign.target_gt_idx[:, :, None, None].expand(B, N, K, kdim))
    sel = torch.cat([sel[..., :2] / stride_t[None, :, :, None], sel[..., 2:]], -1)
    kpt_mask = (sel[..., 2] != 0).float() if kdim == 3 else torch.ones_like(sel[..., 0])
    tb = assign.target_bboxes / stride_t[None]
    area = (tb[..., 2] - tb[..., 0]) * (tb[..., 3] - tb[..., 1])
    sigmas = OKS_SIGMA.to(x.device) if K == 17 else torch.full((K,), 1.0 / K, device=x.device)
    d = (pred_kpts[..., 0] - sel[..., 0]) ** 2 + (pred_kpts[..., 1] - sel[..., 1]) ** 2
    e = d / ((2 * sigmas) ** 2 * (area[..., None] + 1e-9) * 2)
    factor = K / (kpt_mask.sum(-1, keepdim=True) + 1e-9)
    n_fg_k = (fg.sum() * K).clamp(min=1.0)
    loss_pose = (factor * (1 - torch.exp(-e)) * kpt_mask * fg[..., None]).sum() / n_fg_k
    if kdim == 3:
        loss_kobj = (_bce_logits(pred_kpts[..., 2], kpt_mask) * fg[..., None]).sum() / n_fg_k
    else:
        loss_kobj = torch.zeros((), device=x.device)
    items = torch.stack([loss_box * hyp.box, loss_pose * hyp.pose, loss_kobj * hyp.kobj,
                         loss_cls * hyp.cls, loss_dfl * hyp.dfl])
    return PoseLossOut(items.sum() * B, items.detach())


class SegLossOut(NamedTuple):
    total: torch.Tensor
    items: torch.Tensor  # (4,) box, seg, cls, dfl, detached


def segmentation_loss(feats_and_proto, batch, hyp, *, nc: int, reg_max: int, strides,
                      nm: int = 32, tal_topk: int = 10, mask_topk: int = 64):
    """v8 segmentation loss: the detection terms and the mask BCE of the `mask_topk` anchors
    of largest assigned weight per image (the JAX package's static-shape choice; Ultralytics
    runs every foreground anchor), each cropped to its target box and divided by that box's
    normalized area, the sum over the foreground count, gained by `box`. Ties in the weight
    keep the lower anchor first, as `lax.top_k` does. The gt overlap map is resized to the
    prototypes' grid with `jax.image.resize`'s nearest rule where it differs."""
    feats, protos = feats_and_proto
    x, hw = flatten_feats(feats)
    B, N, _ = x.shape
    mh, mw = protos.shape[2:]
    loss_box, loss_cls, loss_dfl, assign, _ = _box_terms(
        x, hw, batch, nc=nc, reg_max=reg_max, strides=strides, tal_topk=tal_topk, tags=False)
    _, stride_t, imgsz_w, imgsz_h = _grid(hw, strides, x.device)
    fg = assign.fg_mask.float()
    weight = assign.target_scores.sum(-1) * fg

    k = min(mask_topk, N)
    sel_w, sel_idx = weight.sort(dim=1, descending=True, stable=True)
    sel_w, sel_idx = sel_w[:, :k], sel_idx[:, :k]
    sel_valid = (sel_w > 0).float()
    coeffs = at_least_f32(x[..., 4 * reg_max + nc:]).gather(1, sel_idx[..., None].expand(B, k, nm))
    gt_idx = assign.target_gt_idx.gather(1, sel_idx)
    tb = assign.target_bboxes.gather(1, sel_idx[..., None].expand(B, k, 4))  # input pixels

    gt_masks = batch["masks"].float()
    if gt_masks.shape[1:] != (mh, mw):
        gt_masks = resize_nearest(gt_masks[:, None], mh, mw)[:, 0]
    inst = (gt_masks[:, None] == (gt_idx[..., None, None] + 1.0)).float()
    pred_m = torch.einsum("bkc,bchw->bkhw", coeffs, at_least_f32(protos))
    norm = torch.tensor([imgsz_w, imgsz_h, imgsz_w, imgsz_h], dtype=torch.float32,
                        device=x.device)
    tb_n = tb / norm
    mxyxy = tb_n * torch.tensor([mw, mh, mw, mh], dtype=torch.float32, device=x.device)
    area = ((tb_n[..., 2] - tb_n[..., 0]) * (tb_n[..., 3] - tb_n[..., 1])).clamp(min=1e-4)
    per_anchor = crop_mask(_bce_logits(pred_m, inst), mxyxy).mean((-1, -2)) / area
    loss_seg = (per_anchor * sel_valid).sum() / fg.sum().clamp(min=1.0)
    items = torch.stack([loss_box * hyp.box, loss_seg * hyp.box, loss_cls * hyp.cls,
                         loss_dfl * hyp.dfl])
    return SegLossOut(items.sum() * B, items.detach())


class OBBLossOut(NamedTuple):
    total: torch.Tensor
    items: torch.Tensor  # (3,) box, cls, dfl, detached


def obb_loss(feats, batch, hyp, *, nc: int, reg_max: int, strides, tal_topk: int = 10):
    """v8 OBB loss: the rotated assigner (probiou overlaps, candidates inside each ground
    truth's own frame), the class BCE, 1 - probiou as the box term and the DFL of the
    distances to the axis-aligned hull of the rotated target (`xywh2xyxy` of its xywh, as
    Ultralytics' RotatedBboxLoss encodes it). Ground truths under 2 px a side are dropped.
    The angle is (sigmoid - 0.25) pi of the first angle channel."""
    x, hw = flatten_feats(feats)
    B, N, _ = x.shape
    pred_distri = at_least_f32(x[..., :4 * reg_max])
    pred_scores = at_least_f32(x[..., 4 * reg_max:4 * reg_max + nc])
    pred_angle = (at_least_f32(x[..., 4 * reg_max + nc:]).sigmoid() - 0.25) * math.pi
    anchor_points, stride_t, imgsz_w, imgsz_h = _grid(hw, strides, x.device)
    scale = torch.tensor([imgsz_w, imgsz_h, imgsz_w, imgsz_h], dtype=torch.float32,
                         device=x.device)
    gb = batch["bboxes"].float()
    gt_bboxes = torch.cat([gb[..., :4] * scale, gb[..., 4:5]], -1)  # xywhr pixels
    size_ok = (gt_bboxes[..., 2] >= 2) & (gt_bboxes[..., 3] >= 2)
    mask_gt = batch["mask"].float() * size_ok

    pred_rbox = dist2rbox(dfl_decode(pred_distri, reg_max), pred_angle[..., :1],
                          anchor_points[None])  # grid units
    pred_bboxes = torch.cat([pred_rbox, pred_angle[..., :1]], -1)
    assign = task_aligned_assigner(
        pred_scores.detach().sigmoid(),
        torch.cat([pred_rbox * stride_t[None], pred_angle[..., :1]], -1).detach(),
        anchor_points * stride_t, batch["cls"].long(), gt_bboxes, mask_gt,
        topk=tal_topk, num_classes=nc, rotated=True)

    tss = assign.target_scores.sum().clamp(min=1.0)
    fg = assign.fg_mask.float()
    loss_cls = _bce_logits(pred_scores, assign.target_scores).sum() / tss
    tb = assign.target_bboxes
    tb = torch.cat([tb[..., :4] / stride_t[None], tb[..., 4:5]], -1)
    weight = assign.target_scores.sum(-1) * fg
    iou = probiou(pred_bboxes, tb).squeeze(-1)
    loss_box = ((1.0 - iou) * weight).sum() / tss
    target_ltrb = bbox2dist(anchor_points[None], xywh2xyxy(tb[..., :4]), reg_max - 1)
    loss_dfl = (_df_loss(pred_distri.reshape(B, N, 4, reg_max), target_ltrb, reg_max)
                * weight).sum() / tss
    items = torch.stack([loss_box * hyp.box, loss_cls * hyp.cls, loss_dfl * hyp.dfl])
    return OBBLossOut(items.sum() * B, items.detach())


class ClsLossOut(NamedTuple):
    total: torch.Tensor
    items: torch.Tensor  # (1,) the loss, detached


def classification_loss(logits, batch):
    """The mean softmax cross-entropy of (B, nc) logits in float32 against batch['cls']."""
    ce = F.cross_entropy(at_least_f32(logits), batch["cls"].long().reshape(-1))
    return ClsLossOut(ce, ce.detach()[None])
