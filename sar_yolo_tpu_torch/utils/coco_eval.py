"""COCO-protocol bbox evaluation in numpy, without pycocotools (port of
`sar_yolo_tpu/utils/coco_eval.py`).

The COCOeval bbox protocol: per (image, category) greedy matching with
detections sorted by score, each GT matched at most once, crowd and ignored
regions absorbing extra detections; 10 IoU thresholds 0.50:0.05:0.95, 101
recall points, area ranges all/small/medium/large, maxDets 1/10/100; AP the
mean precision over recall points, classes and IoUs (ignoring -1 cells). It
scores the validator's `save_json` predictions the way COCO would, beside
`DetMetrics`' f1-max P/R convention.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
MAX_DETS = (1, 10, 100)


def _iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU between dt (D,4) and gt (G,4) boxes in COCO xywh; crowd GT uses
    intersection-over-det-area (pycocotools maskUtils.iou semantics)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = iw * ih
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None, :]
    union = np.where(iscrowd[None, :], d_area, d_area + g_area - inter)
    return inter / np.maximum(union, 1e-12)


class CocoEval:
    """Evaluate COCO-format detections against COCO-format ground truth.

    Args:
        gt: dict with "annotations" (image_id, category_id, bbox xywh, area?,
            iscrowd?, id) and optionally "images"/"categories"; or a json path.
        dt: list of prediction dicts (image_id, category_id, bbox xywh, score);
            or a json path (the validator's predictions.json).
    """

    def __init__(self, gt, dt):
        if isinstance(gt, (str, Path)):
            gt = json.loads(Path(gt).read_text())
        if isinstance(dt, (str, Path)):
            dt = json.loads(Path(dt).read_text())
        anns = gt["annotations"] if isinstance(gt, dict) else gt
        self.gts = {}
        for i, a in enumerate(anns):
            a = dict(a)
            a.setdefault("id", i + 1)
            a.setdefault("iscrowd", 0)
            a.setdefault("area", a["bbox"][2] * a["bbox"][3])
            a.setdefault("ignore", a["iscrowd"])
            self.gts.setdefault((a["image_id"], a["category_id"]), []).append(a)
        self.dts = {}
        for d in dt:
            self.dts.setdefault((d["image_id"], d["category_id"]), []).append(d)
        img_ids = {k[0] for k in self.gts} | {k[0] for k in self.dts}
        cat_ids = {k[1] for k in self.gts} | {k[1] for k in self.dts}
        if isinstance(gt, dict) and gt.get("images"):
            img_ids |= {im["id"] for im in gt["images"]}
        if isinstance(gt, dict) and gt.get("categories"):
            cat_ids = {c["id"] for c in gt["categories"]}
        self.img_ids = sorted(img_ids)
        self.cat_ids = sorted(cat_ids)

    # ---- per-(img, cat, area) matching ------------------------------------
    def _evaluate_img(self, img_id, cat_id, arng, max_det):
        gt = self.gts.get((img_id, cat_id), [])
        dt = self.dts.get((img_id, cat_id), [])
        if not gt and not dt:
            return None
        g_ignore = np.array(
            [g["ignore"] or not (arng[0] <= g["area"] < arng[1]) for g in gt], bool)
        # sort gts: valid first, ignored last (pycocotools convention)
        g_order = np.argsort(g_ignore, kind="stable")
        gt = [gt[i] for i in g_order]
        g_ignore = g_ignore[g_order]
        d_order = np.argsort([-d["score"] for d in dt], kind="stable")[:max_det]
        dt = [dt[i] for i in d_order]

        g_boxes = np.array([g["bbox"] for g in gt], float).reshape(-1, 4)
        d_boxes = np.array([d["bbox"] for d in dt], float).reshape(-1, 4)
        iscrowd = np.array([g["iscrowd"] for g in gt], bool)
        ious = _iou_xywh(d_boxes, g_boxes, iscrowd)

        T, D, G = len(IOU_THRS), len(dt), len(gt)
        dtm = np.zeros((T, D), dtype=np.int64)   # matched gt id (0 = unmatched)
        gtm = np.zeros((T, G), dtype=np.int64)
        dt_ignore = np.zeros((T, D), bool)
        for t, thr in enumerate(IOU_THRS):
            for di in range(D):
                best_iou = min(thr, 1 - 1e-10)
                best_g = -1
                for gi in range(G):
                    if gtm[t, gi] and not iscrowd[gi]:
                        continue
                    # stop at ignored gts once a valid match was found
                    if best_g > -1 and not g_ignore[best_g] and g_ignore[gi]:
                        break
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    best_g = gi
                if best_g == -1:
                    continue
                dt_ignore[t, di] = g_ignore[best_g]
                dtm[t, di] = gt[best_g]["id"]
                gtm[t, best_g] = 1
        # dets outside the area range and unmatched are ignored too
        d_area = d_boxes[:, 2] * d_boxes[:, 3]
        d_out = (d_area < arng[0]) | (d_area >= arng[1])
        dt_ignore |= (dtm == 0) & d_out[None, :]
        return {
            "dt_scores": np.array([d["score"] for d in dt], float),
            "dt_matched": dtm > 0,
            "dt_ignore": dt_ignore,
            "n_gt": int((~g_ignore).sum()),
        }

    # ---- accumulate over images -------------------------------------------
    def accumulate(self):
        T, R = len(IOU_THRS), len(REC_THRS)
        K, A, M = len(self.cat_ids), len(AREA_RANGES), len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        for k, cat in enumerate(self.cat_ids):
            for a, arng in enumerate(AREA_RANGES.values()):
                for m, max_det in enumerate(MAX_DETS):
                    evs = [self._evaluate_img(i, cat, arng, max_det) for i in self.img_ids]
                    evs = [e for e in evs if e is not None]
                    if not evs:
                        continue
                    n_gt = sum(e["n_gt"] for e in evs)
                    if n_gt == 0:
                        continue
                    scores = np.concatenate([e["dt_scores"] for e in evs])
                    order = np.argsort(-scores, kind="mergesort")
                    matched = np.concatenate([e["dt_matched"] for e in evs], 1)[:, order]
                    ignored = np.concatenate([e["dt_ignore"] for e in evs], 1)[:, order]
                    tps = matched & ~ignored
                    fps = ~matched & ~ignored
                    tp_sum = tps.cumsum(1).astype(float)
                    fp_sum = fps.cumsum(1).astype(float)
                    for t in range(T):
                        tp, fp = tp_sum[t], fp_sum[t]
                        nd = len(tp)
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if nd else 0.0
                        # monotone precision envelope
                        q = np.zeros(R)
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                        precision[t, :, k, a, m] = q
        self.precision = precision
        self.recall = recall
        return self

    def summarize(self) -> dict:
        def ap(iou=None, area="all", max_det=100):
            a = list(AREA_RANGES).index(area)
            m = MAX_DETS.index(max_det)
            p = self.precision[:, :, :, a, m]
            if iou is not None:
                p = p[[int(round((iou - 0.5) / 0.05))]]
            p = p[p > -1]
            return float(p.mean()) if p.size else -1.0

        def ar(area="all", max_det=100):
            a = list(AREA_RANGES).index(area)
            m = MAX_DETS.index(max_det)
            r = self.recall[:, :, a, m]
            r = r[r > -1]
            return float(r.mean()) if r.size else -1.0

        return {
            "AP": ap(), "AP50": ap(iou=0.5), "AP75": ap(iou=0.75),
            "APsmall": ap(area="small"), "APmedium": ap(area="medium"),
            "APlarge": ap(area="large"),
            "AR1": ar(max_det=1), "AR10": ar(max_det=10), "AR100": ar(),
            "ARsmall": ar(area="small"), "ARmedium": ar(area="medium"),
            "ARlarge": ar(area="large"),
        }


def eval_json(pred_json, gt, prefix="coco") -> dict:
    """predictions.json + GT -> {"metrics/coco_mAP50-95": ..., ...}.

    Mirrors reference DetectionValidator.eval_json (models/yolo/detect/val.py)
    which runs pycocotools on save_json output.
    """
    s = CocoEval(gt, pred_json).accumulate().summarize()
    return {
        f"metrics/{prefix}_mAP50-95": s["AP"],
        f"metrics/{prefix}_mAP50": s["AP50"],
        f"metrics/{prefix}_mAP75": s["AP75"],
        f"metrics/{prefix}_AR100": s["AR100"],
    }
