"""Batched class-aware NMS with a fixed (B, max_det, 6 + E) output, single- or
multi-label, rotated NMS by probiou with a (B, max_det, 7) output, and the NMS-free top-k
of end-to-end (v10) heads (port of `sar_yolo_tpu/ops/nms.py`: `_nms_single`,
`non_max_suppression`, `_nms_single_rotated`, `non_max_suppression_rotated` and
`postprocess_end2end`)."""

from __future__ import annotations

import torch

from .boxes import as_dtype, probiou, xywh2xyxy


def _nms_batched(boxes, scores, classes, extras, iou_thres: float, max_det: int,
                 agnostic: bool = False):
    """Exact greedy NMS of a batch of images (`_suppress`), IoU of boxes moved apart by class.

    boxes (B, K, 4) xyxy, scores (B, K) sorted descending, classes (B, K),
    extras (B, K, E). Returns (B, max_det, 6 + E) rows [x1, y1, x2, y2, conf, cls,
    *extras], kept rows first in score order; unused rows are zero.
    """
    K = boxes.shape[1]
    if agnostic:
        off_boxes = boxes
    else:
        off = boxes.abs().amax((1, 2), keepdim=True) + 1.0  # per-image class offset
        off_boxes = boxes + classes[..., None] * off
    x1, y1, x2, y2 = off_boxes.unbind(-1)
    areas = (x2 - x1) * (y2 - y1)
    xx1 = torch.maximum(x1[:, :, None], x1[:, None, :])
    yy1 = torch.maximum(y1[:, :, None], y1[:, None, :])
    xx2 = torch.minimum(x2[:, :, None], x2[:, None, :])
    yy2 = torch.minimum(y2[:, :, None], y2[:, None, :])
    inter = (xx2 - xx1).clamp(min=0) * (yy2 - yy1).clamp(min=0)
    iou = inter / (areas[:, :, None] + areas[:, None, :] - inter + 1e-7)
    valid = scores > 0.0
    rank = torch.arange(K, device=boxes.device)
    # overlap[b, i, j]: higher-ranked valid j overlaps i beyond the threshold
    overlap = (iou > iou_thres) & (rank[None, :] < rank[:, None])[None] & valid[:, None, :]

    rows = torch.cat([boxes, scores[..., None], classes[..., None], extras], -1)
    return _suppress(overlap, valid, rows, max_det)


# fixed-point iterations of the last `_suppress` call (the host syncs once for each)
last_iterations = [0]


def _suppress(overlap, valid, rows, max_det: int):
    """Greedy NMS as a fixed point, then the kept rows compacted.

    overlap (B, K, K): higher-ranked j overlaps i beyond the threshold; valid (B, K); rows
    (B, K, C) in score order. alive[i] = valid[i] and no alive j with overlap[i, j]: iterated
    from alive = valid until it stops changing (one host sync an iteration; an image
    already at its fixed point stays there, so the batch iterates together). Under
    `torch.export` the same iteration is a `while_loop` on the device (`_fixed_point_traced`).
    Returns (B, max_det, C), the alive rows first in score order; unused rows are zero.
    """
    if torch.compiler.is_exporting():
        alive = _fixed_point_traced(overlap, valid)
    else:
        alive, n = valid, 0
        while True:
            n += 1
            new_alive = ~(overlap & alive[:, None, :]).any(2) & valid
            if torch.equal(new_alive, alive):
                break
            alive = new_alive
        last_iterations[0] = n

    # compact alive rows (stable, score order) into max_det slots; slot max_det is a sink
    Bn = rows.shape[0]
    keep_rank = torch.cumsum(alive, 1) - 1
    keep = alive & (keep_rank < max_det)
    slot = torch.where(keep, keep_rank, torch.full_like(keep_rank, max_det))
    out = torch.zeros((Bn, max_det + 1, rows.shape[-1]), dtype=rows.dtype, device=rows.device)
    src = torch.where(keep[..., None], rows, torch.zeros_like(rows))
    out.scatter_(1, slot[..., None].expand(-1, -1, rows.shape[-1]), src)
    return out[:, :max_det]


def _fixed_point_traced(overlap, valid):
    """`_suppress`'s fixed point as a `while_loop` that `torch.export` can trace: the same
    iterations from alive = valid, stopping once an iteration changes nothing. The body
    returns fresh tensors and the condition a copy of the carried flag, as the higher-order
    op requires."""
    from torch._higher_order_ops import while_loop

    def cond(alive, changed):
        return changed.clone()

    def body(alive, changed):
        new_alive = ~(overlap & alive[:, None, :]).any(2) & valid
        return new_alive.clone(), (new_alive != alive).any()

    alive, _ = while_loop(cond, body, (valid.clone(), valid.new_ones(())))
    return alive


def non_max_suppression(preds, conf_thres: float = 0.25, iou_thres: float = 0.7,
                        max_det: int = 300, pre_topk: int = 1024, nc: int = 80,
                        agnostic: bool = False, extras_bank=None, multi_label: bool = False):
    """Batched NMS over decoded predictions.

    preds (B, N, 4 + nc + E): xywh boxes, sigmoided class scores, E extras
    carried through. Single-label, each anchor is one candidate with its best
    class; with multi_label (validation, nc > 1) every (anchor, class) pair is
    one, and the top `pre_topk` pairs over the flattened N * nc scores are kept.
    extras_bank (B, N, Eb), if given, is gathered for the kept detections only,
    after suppression, and spliced in right after cls.
    Returns (B, max_det, 6 + Eb + E) [x1, y1, x2, y2, conf, cls, *bank, *extras];
    rows with conf == 0 are padding.
    """
    B, N, _ = preds.shape
    boxes = xywh2xyxy(preds[..., :4])
    cls_scores = preds[..., 4:4 + nc]
    extras = preds[..., 4 + nc:]
    # stable descending sorts: ties keep the lower index first, as lax.top_k does
    if multi_label and nc > 1:
        k = min(pre_topk, N * nc)
        top_conf, top_flat = torch.sort(cls_scores.reshape(B, N * nc), dim=1, descending=True,
                                        stable=True)
        top_conf, top_flat = top_conf[:, :k], top_flat[:, :k]
        top_conf = torch.where(top_conf >= conf_thres, top_conf, torch.zeros_like(top_conf))
        top_idx = top_flat // nc  # the source anchor
        top_cls = (top_flat % nc).to(preds.dtype)
    else:
        conf, cls = cls_scores.max(-1)
        conf = torch.where(conf >= conf_thres, conf, torch.zeros_like(conf))
        k = min(pre_topk, N)
        top_conf, top_idx = torch.sort(conf, dim=1, descending=True, stable=True)
        top_conf, top_idx = top_conf[:, :k], top_idx[:, :k]
        top_cls = torch.gather(cls.to(preds.dtype), 1, top_idx)

    def gather(t):
        return torch.gather(t, 1, top_idx[..., None].expand(-1, -1, t.shape[-1]))

    top_boxes = gather(boxes)
    top_extras = gather(extras)
    if extras_bank is not None:
        # the source anchor index rides through suppression as one f32 column
        # (exact below 2^24 anchors)
        top_extras = torch.cat([as_dtype(top_extras, torch.float32),
                                top_idx.float()[..., None]], -1)
    out = _nms_batched(top_boxes, top_conf, top_cls, top_extras, iou_thres, max_det, agnostic)
    if extras_bank is None:
        return out
    kept_idx = out[..., -1].long()
    kept = torch.gather(extras_bank, 1, kept_idx[..., None].expand(-1, -1, extras_bank.shape[-1]))
    kept = torch.where(out[..., 4:5] > 0, as_dtype(kept, out.dtype),
                       torch.zeros((), dtype=out.dtype, device=out.device))
    return torch.cat([out[..., :6], kept, out[..., 6:-1]], -1)


def non_max_suppression_rotated(preds, conf_thres: float = 0.25, iou_thres: float = 0.7,
                                max_det: int = 300, pre_topk: int = 1024, nc: int = 80):
    """Class-aware greedy NMS of rotated boxes by probiou.

    preds (B, N, 4 + nc + 1): xywh, sigmoided class scores, the angle in radians (last).
    Each anchor is one candidate with its best class; the top `pre_topk` by score (a stable
    sort: ties keep the lower index, as lax.top_k does) are suppressed by the K x K
    probiou of their boxes, each class's centres moved by class x (max |xy| + max wh + 1),
    added in the JAX package's order. Returns (B, max_det, 7) rows [cx, cy, w, h, r, conf,
    cls]; rows with conf == 0 are padding.
    """
    B, N, _ = preds.shape
    boxes5 = torch.cat([preds[..., :4], preds[..., -1:]], -1)
    conf, cls = preds[..., 4:4 + nc].max(-1)
    conf = torch.where(conf >= conf_thres, conf, torch.zeros_like(conf))
    k = min(pre_topk, N)
    top_conf, top_idx = torch.sort(conf, dim=1, descending=True, stable=True)
    top_conf, top_idx = top_conf[:, :k], top_idx[:, :k]
    b = torch.gather(boxes5, 1, top_idx[..., None].expand(-1, -1, 5))
    c = torch.gather(cls.to(preds.dtype), 1, top_idx)
    off_val = b[..., :2].abs().amax((1, 2)) + b[..., 2:4].amax((1, 2)) + 1.0
    off = torch.cat([b[..., :2] + c[..., None] * off_val[:, None, None], b[..., 2:]], -1)
    iou = probiou(off[:, :, None], off[:, None]).squeeze(-1)
    valid = top_conf > 0.0
    rank = torch.arange(k, device=preds.device)
    overlap = (iou > iou_thres) & (rank[None, :] < rank[:, None])[None] & valid[:, None, :]
    rows = torch.cat([b, top_conf[..., None], c[..., None]], -1)
    return _suppress(overlap, valid, rows, max_det)


def postprocess_end2end(preds, max_det: int = 300, conf_thres: float = 0.0, nc: int = 80):
    """NMS-free detections of an end-to-end (v10) head: the global top `max_det` of the
    flattened (anchor, class) scores of each image, one `torch.topk` for the batch and no
    host sync.

    preds (B, N, 4 + nc): xywh boxes and sigmoided class scores. Returns (B, max_det, 6)
    rows [x1, y1, x2, y2, conf, cls], highest score first and, among equal scores, the
    lower flat index (anchor * nc + class) first, as `jax.lax.top_k` orders them (which k
    rows tie at the k-th score is torch's choice); a score under conf_thres becomes 0 and
    its box zeros, and rows past N * nc are zero padding.
    """
    B, N, _ = preds.shape
    boxes = xywh2xyxy(preds[..., :4])
    flat = preds[..., 4:4 + nc].reshape(B, N * nc)
    k = min(max_det, N * nc)
    topv, topi = torch.topk(flat, k, dim=1)
    # torch.topk orders equal values as it likes: re-sort the k by (value desc, index asc)
    topi, perm = topi.sort(dim=1)
    topv, order = torch.gather(topv, 1, perm).sort(dim=1, descending=True, stable=True)
    topi = torch.gather(topi, 1, order)
    b = torch.gather(boxes, 1, (topi // nc)[..., None].expand(-1, -1, 4))
    conf = torch.where(topv >= conf_thres, topv, torch.zeros_like(topv))
    b = torch.where(conf[..., None] > 0, b, torch.zeros_like(b))
    out = torch.cat([b, conf[..., None], (topi % nc).to(preds.dtype)[..., None]], -1)
    return torch.nn.functional.pad(out, (0, 0, 0, max_det - k)) if k < max_det else out
