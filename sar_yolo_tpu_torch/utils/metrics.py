"""Detection metrics on the host: AP per class (101-point interpolation), mAP50 / 75 /
50-95 and fitness (port of `sar_yolo_tpu/utils/metrics.py:13-143`); and the ReID
clustering scores that the JAX package takes from scikit-learn.

All numpy, applied once per batch to the (B, max_det, C) detections that the
device hands back.
"""

from __future__ import annotations

import numpy as np

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) xyxy -> (N,M) IoU."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=2)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-7)


def match_predictions(pred_boxes, pred_cls, gt_boxes, gt_cls, thresholds=IOU_THRESHOLDS):
    """Per-image TP matrix (n_pred, n_thr): IoU matching, class-aware.

    Candidate pairs sorted by IoU descending, then deduplicated per detection and
    per GT by first occurrence. Not pure greedy, on purpose: a detection whose best
    GT is taken does not fall back to its second best, and the second dedup keeps
    detection-index order (each GT keeps its lowest-indexed detection), as the
    Ultralytics validator does.
    """
    n_pred = len(pred_boxes)
    n_thr = len(thresholds)
    tp = np.zeros((n_pred, n_thr), dtype=bool)
    if n_pred == 0 or len(gt_boxes) == 0:
        return tp
    iou = box_iou_np(gt_boxes, pred_boxes)
    correct_class = gt_cls[:, None] == pred_cls[None, :]
    iou = iou * correct_class
    for t, thr in enumerate(thresholds):
        gi, pi = np.nonzero(iou >= thr)
        if len(gi):
            order = iou[gi, pi].argsort()[::-1]
            gi, pi = gi[order], pi[order]
            keep = np.unique(pi, return_index=True)[1]  # best GT per detection
            gi, pi = gi[keep], pi[keep]  # now in detection-index order
            keep = np.unique(gi, return_index=True)[1]
            tp[pi[keep], t] = True
    return tp


def compute_ap(recall, precision):
    """AP from the PR curve via 101-point interpolation (COCO style)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    return np.trapezoid(np.interp(x, mrec, mpre), x)


def ap_per_class(tp, conf, pred_cls, target_cls, eps=1e-16):
    """AP per class over IoU thresholds.

    Args:
        tp: (n_pred, n_thr) bool.
        conf, pred_cls: (n_pred,).
        target_cls: (n_gt,).

    Returns dict with p, r, ap (nc, n_thr), unique_classes, nt.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = len(unique_classes)
    n_thr = tp.shape[1] if tp.ndim == 2 else 1
    ap = np.zeros((nc, n_thr))
    p = np.zeros(nc)
    r = np.zeros(nc)
    for ci, c in enumerate(unique_classes):
        mask = pred_cls == c
        n_l = nt[ci]
        n_p = mask.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[mask]).cumsum(0)
        tpc = tp[mask].cumsum(0)
        recall = tpc / (n_l + eps)
        precision = tpc / (tpc + fpc)
        for t in range(n_thr):
            ap[ci, t] = compute_ap(recall[:, t], precision[:, t])
        # P/R at the conf producing max F1 on the 0.5 IoU curve
        f1 = 2 * precision[:, 0] * recall[:, 0] / (precision[:, 0] + recall[:, 0] + eps)
        idx = f1.argmax()
        p[ci] = precision[idx, 0]
        r[ci] = recall[idx, 0]
    return {"p": p, "r": r, "ap": ap, "unique_classes": unique_classes.astype(int), "nt": nt}


class DetMetrics:
    """Accumulates per-batch stats, finalizes to mp/mr/mAP50/mAP75/mAP50-95 + fitness."""

    def __init__(self, names: dict | None = None):
        self.names = names or {}
        self.stats = {"tp": [], "conf": [], "pred_cls": [], "target_cls": []}
        self.results = {}

    def update(self, tp, conf, pred_cls, target_cls):
        self.stats["tp"].append(tp)
        self.stats["conf"].append(conf)
        self.stats["pred_cls"].append(pred_cls)
        self.stats["target_cls"].append(target_cls)

    def process(self) -> dict:
        if not self.stats["tp"]:
            return {}
        tp = np.concatenate(self.stats["tp"])
        conf = np.concatenate(self.stats["conf"])
        pred_cls = np.concatenate(self.stats["pred_cls"])
        target_cls = np.concatenate(self.stats["target_cls"])
        if len(target_cls) == 0:
            return {}
        res = ap_per_class(tp, conf, pred_cls, target_cls)
        ap = res["ap"]
        map50 = ap[:, 0].mean() if ap.size else 0.0
        map75 = ap[:, 5].mean() if ap.shape[1] > 5 else 0.0
        map_ = ap.mean() if ap.size else 0.0
        self.results = {
            "metrics/precision(B)": float(res["p"].mean() if res["p"].size else 0),
            "metrics/recall(B)": float(res["r"].mean() if res["r"].size else 0),
            "metrics/mAP50(B)": float(map50),
            "metrics/mAP75(B)": float(map75),
            "metrics/mAP50-95(B)": float(map_),
            "fitness": float(0.1 * map50 + 0.9 * map_),
        }
        self.per_class = res
        return self.results


def _cluster_ids(labels) -> tuple[np.ndarray, np.ndarray]:
    """(ids 0..k-1 in sorted label order, count per id)."""
    _, ids, counts = np.unique(labels, return_inverse=True, return_counts=True)
    return ids, counts


def silhouette_cosine(x: np.ndarray, labels) -> float:
    """Mean silhouette coefficient under cosine distance, as
    `sklearn.metrics.silhouette_score(x, labels, metric="cosine")` computes it:
    distance 1 - cos clipped to [0, 2], 0 to itself; a sample alone in its cluster
    scores 0. Needs 2 <= clusters < samples."""
    x = x.astype(np.float64)
    ids, counts = _cluster_ids(labels)
    norm = np.linalg.norm(x, axis=1, keepdims=True)
    xn = x / np.where(norm == 0, 1, norm)
    dist = np.clip(1.0 - xn @ xn.T, 0.0, 2.0)
    np.fill_diagonal(dist, 0.0)
    onehot = (ids[:, None] == np.arange(len(counts))[None, :]).astype(dist.dtype)
    sums = dist @ onehot  # (n, k): distance of each sample to all of cluster k
    rows = np.arange(len(ids))
    with np.errstate(divide="ignore", invalid="ignore"):
        intra = sums[rows, ids] / (counts[ids] - 1)
        mean_to = sums / counts[None, :]
        mean_to[rows, ids] = np.inf
        inter = mean_to.min(1)
        sil = (inter - intra) / np.maximum(intra, inter)
    return float(np.nan_to_num(sil).mean())


def _euclidean(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise euclidean distances by |a|^2 - 2 a.b + |b|^2, as scikit-learn computes
    them in float64 (its rounding included)."""
    d = -2 * (a @ b.T)
    d += np.einsum("ij,ij->i", a, a)[:, None]
    d += np.einsum("ij,ij->i", b, b)[None, :]
    return np.sqrt(np.maximum(d, 0))


def davies_bouldin(x: np.ndarray, labels) -> float:
    """Davies-Bouldin index under euclidean distance, as
    `sklearn.metrics.davies_bouldin_score` computes it (0 where every cluster or
    every centroid distance is 0). Needs 2 <= clusters < samples."""
    x = x.astype(np.float64)
    ids, counts = _cluster_ids(labels)
    k = len(counts)
    centroids = np.stack([x[ids == c].mean(0) for c in range(k)])
    intra = np.array([_euclidean(x[ids == c], centroids[c:c + 1]).mean() for c in range(k)])
    between = _euclidean(centroids, centroids)
    np.fill_diagonal(between, 0.0)
    if np.allclose(intra, 0) or np.allclose(between, 0):
        return 0.0
    between[between == 0] = np.inf
    return float(((intra[:, None] + intra[None, :]) / between).max(1).mean())
