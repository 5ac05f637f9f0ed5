"""Host augmentation of the detect, JDE, pose and segment samples (port of
`sar_yolo_tpu/data/augment.py`: letterbox, HSV, flip, the affine `random_perspective`,
`mosaic4`, `mixup`, `copy_paste`).

Samples flow as dicts: img uint8 HWC BGR, cls (n,), bboxes (n, 4) xyxy pixels, tags
(n,) person ids, keypoints (n, K, D) in pixels (pose), polygons (a list of n (k, 2)
pixel arrays; segment), which every step keeps aligned with the boxes. Each function
makes the same numpy draws in the same order as the JAX package's, so one (seed, epoch,
index) key gives the same sample in both packages; the OpenCV calls are the bit-exact
numpy versions of `data/cv.py`.

Not ported, and refused where asked for: the perspective warp (`perspective > 0`) and
`mosaic9`. The JAX package's `Albumentations` step is a no-op where that library is
missing, as it is wherever this port runs, and has no counterpart here.
"""

from __future__ import annotations

import math

import numpy as np

from sar_yolo_tpu_torch.data import cv


def letterbox(img: np.ndarray, new_shape=(640, 640), color=(114, 114, 114),
              scaleup: bool = True, center: bool = True):
    """Resize + pad to new_shape keeping aspect ratio. Returns img, ratio, (dw, dh)."""
    shape = img.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = (round(shape[1] * r), round(shape[0] * r))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if center:
        dw /= 2
        dh /= 2
    if shape[::-1] != new_unpad:
        img = cv.resize(img, new_unpad)
    top, bottom = round(dh - 0.1), round(dh + 0.1)
    left, right = round(dw - 0.1), round(dw + 0.1)
    img = cv.copy_make_border(img, top, bottom, left, right, value=color)
    return img, r, (left, top)


def augment_hsv(img: np.ndarray, hgain=0.015, sgain=0.7, vgain=0.4, rng=None) -> np.ndarray:
    """HSV jitter in uint8 LUT space; returns the new image."""
    if hgain or sgain or vgain:
        r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
        hsv = cv.bgr2hsv(img)
        x = np.arange(0, 256, dtype=r.dtype)
        lut_hue = ((x * r[0]) % 180).astype(img.dtype)
        lut_sat = np.clip(x * r[1], 0, 255).astype(img.dtype)
        lut_val = np.clip(x * r[2], 0, 255).astype(img.dtype)
        img = cv.hsv2bgr(np.stack([lut_hue[hsv[..., 0]], lut_sat[hsv[..., 1]],
                                   lut_val[hsv[..., 2]]], -1))  # cv2.LUT
    return img


def random_flip(labels: dict, fliplr=0.5, flipud=0.0, rng=None, flip_idx=None) -> dict:
    """Vertical, then horizontal flip of the image, boxes, keypoints and polygons; a
    horizontal flip also permutes the keypoints by `flip_idx` (left/right pairs)."""
    img = labels["img"]
    h, w = img.shape[:2]
    boxes = labels["bboxes"]
    kpts = labels.get("keypoints")
    polys = labels.get("polygons")
    if flipud and rng.random() < flipud:
        labels["img"] = np.flipud(img).copy()
        if len(boxes):
            boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
        if kpts is not None and len(kpts):
            kpts[..., 1] = h - kpts[..., 1]
        for p in polys or ():
            p[:, 1] = h - p[:, 1]
    img = labels["img"]
    if fliplr and rng.random() < fliplr:
        labels["img"] = np.fliplr(img).copy()
        if len(boxes):
            boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        if kpts is not None and len(kpts):
            kpts[..., 0] = w - kpts[..., 0]
            if flip_idx is not None:
                kpts[:] = kpts[:, list(flip_idx)]
        for p in polys or ():
            p[:, 0] = w - p[:, 0]
    labels["bboxes"] = boxes
    return labels


def _box_candidates(box1, box2, wh_thr=2, ar_thr=100, area_thr=0.1, eps=1e-16):
    """Keep boxes that survived the affine transform."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def _rotation_matrix(angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D(center=(0, 0), angle, scale)."""
    angle *= math.pi / 180
    alpha, beta = math.cos(angle) * scale, math.sin(angle) * scale
    return np.array([[alpha, beta, 0.0], [-beta, alpha, 0.0]])


def random_perspective(labels: dict, degrees=0.0, translate=0.1, scale=0.5, shear=0.0,
                       perspective=0.0, border=(0, 0), rng=None) -> dict:
    """Random affine warp of the image and labels. Boxes of polygon (segment) samples
    come from the warped polygons' extents and keep area_thr 0.01; keypoints outside the
    canvas lose their visibility. The perspective terms are drawn as the JAX package draws
    them; a non-zero gain raises."""
    if perspective:
        raise NotImplementedError("perspective > 0 (cv2.warpPerspective) is not part of this "
                                  "port yet")
    img = labels["img"]
    h = img.shape[0] + border[0] * 2
    w = img.shape[1] + border[1] * 2

    # center -> perspective -> rotate/scale -> shear -> translate
    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = _rotation_matrix(a, s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * w
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * h
    M = T @ S @ R @ P @ C

    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        img = cv.warp_affine(img, M[:2], (w, h))

    def warp_points(pts):
        xy1 = np.ones((len(pts), 3))
        xy1[:, :2] = pts
        return (xy1 @ M.T)[:, :2]

    boxes = labels["bboxes"]
    n = len(boxes)
    if n:
        polys = labels.get("polygons")
        if polys:
            new_polys = [warp_points(p) for p in polys]
            new = np.array([[p[:, 0].min(), p[:, 1].min(), p[:, 0].max(), p[:, 1].max()]
                            for p in new_polys], np.float32)
        else:
            xy = warp_points(boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)).reshape(n, 8)
            x = xy[:, [0, 2, 4, 6]]
            y = xy[:, [1, 3, 5, 7]]
            new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, w)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, h)
        keep = _box_candidates(boxes.T * s, new.T, area_thr=0.01 if polys else 0.1)
        labels["bboxes"] = new[keep]
        labels["cls"] = labels["cls"][keep]
        if "tags" in labels:
            labels["tags"] = labels["tags"][keep]
        kpts = labels.get("keypoints")
        if kpts is not None and len(kpts):
            K = kpts.shape[1]
            xy = warp_points(kpts[..., :2].reshape(n * K, 2)).reshape(n, K, 2)
            if kpts.shape[-1] == 3:
                outside = (xy[..., 0] < 0) | (xy[..., 0] > w) | (xy[..., 1] < 0) | (xy[..., 1] > h)
                kpts = np.concatenate([xy, np.where(outside, 0.0, kpts[..., 2])[..., None]], -1)
            else:
                kpts = xy
            labels["keypoints"] = kpts[keep].astype(np.float32)
        if polys:
            labels["polygons"] = [np.clip(p, [0, 0], [w, h]).astype(np.float32)
                                  for p, k in zip(new_polys, keep) if k]
    labels["img"] = img
    return labels


def mosaic4(items: list[dict], imgsz: int, rng=None) -> dict:
    """4-image mosaic on a (2 imgsz)^2 canvas around a random centre; tags, keypoints and
    polygons move and concatenate like boxes."""
    s = imgsz
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    img4 = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
    cls4, boxes4, tags4, kpts4, polys4 = [], [], [], [], []
    has_tags = "tags" in items[0]
    has_kpts = "keypoints" in items[0]
    has_polys = "polygons" in items[0]
    for i, it in enumerate(items):
        img = it["img"]
        h, w = img.shape[:2]
        if i == 0:
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif i == 1:
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        img4[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b
        b = it["bboxes"].copy()
        if len(b):
            b[:, [0, 2]] += padw
            b[:, [1, 3]] += padh
        boxes4.append(b)
        cls4.append(it["cls"])
        if has_tags:
            tags4.append(it["tags"])
        if has_kpts:
            k = it["keypoints"].copy()
            if len(k):
                k[..., 0] += padw
                k[..., 1] += padh
            kpts4.append(k)
        if has_polys:
            polys4 += [p + np.array([padw, padh], np.float32) for p in it["polygons"]]
    out = {"img": img4, "cls": np.concatenate(cls4), "bboxes": np.concatenate(boxes4),
           "mosaic_border": (-s // 2, -s // 2)}
    if has_tags:
        out["tags"] = np.concatenate(tags4)
    if has_kpts:
        out["keypoints"] = np.concatenate(kpts4)
    if has_polys:
        out["polygons"] = polys4
    out["bboxes"][:, [0, 2]] = out["bboxes"][:, [0, 2]].clip(0, 2 * s)
    out["bboxes"][:, [1, 3]] = out["bboxes"][:, [1, 3]].clip(0, 2 * s)
    return out


def mixup(item1: dict, item2: dict, rng=None) -> dict:
    """MixUp of two samples: a beta(32, 32) image blend; labels, tags, keypoints and polygons
    concatenate."""
    r = rng.beta(32.0, 32.0)
    out = {
        "img": (item1["img"].astype(np.float32) * r +
                item2["img"].astype(np.float32) * (1 - r)).astype(np.uint8),
        "cls": np.concatenate([item1["cls"], item2["cls"]]),
        "bboxes": np.concatenate([item1["bboxes"], item2["bboxes"]]),
    }
    if "tags" in item1:
        out["tags"] = np.concatenate([item1["tags"], item2.get("tags", np.zeros(len(item2["cls"])))])
    if "keypoints" in item1:
        out["keypoints"] = np.concatenate([item1["keypoints"], item2["keypoints"]])
    if "polygons" in item1:
        out["polygons"] = list(item1["polygons"]) + list(item2.get("polygons", []))
    return out


def copy_paste(labels: dict, p: float = 0.1, ioa_thres: float = 0.30, rng=None) -> dict:
    """Copy-paste, 'flip' mode: each instance is, with probability p, pasted lr-flipped at
    its mirrored place where that box overlaps the existing ones by IoA < ioa_thres: the
    pixels inside its polygon (`cv.fill_poly` of the mirrored polygon in the patch), or
    its whole rectangle where the sample has no polygons; its keypoints mirror too."""
    boxes = labels["bboxes"]
    n = len(boxes)
    if n == 0 or p <= 0:
        return labels
    img = labels["img"]
    h, w = img.shape[:2]
    polys = labels.get("polygons")
    kpts = labels.get("keypoints")
    new_boxes, new_cls, new_tags, new_kpts, new_polys = [], [], [], [], []
    for j in range(n):
        if rng.random() >= p:
            continue
        x1, y1, x2, y2 = boxes[j]
        fx1, fx2 = w - x2, w - x1
        cand = np.array([fx1, y1, fx2, y2])
        ix1 = np.maximum(cand[0], boxes[:, 0])
        iy1 = np.maximum(cand[1], boxes[:, 1])
        ix2 = np.minimum(cand[2], boxes[:, 2])
        iy2 = np.minimum(cand[3], boxes[:, 3])
        inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
        area = np.maximum((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]), 1e-9)
        if (inter / area).max() >= ioa_thres:
            continue
        xi1, yi1, xi2, yi2 = int(x1), int(y1), int(np.ceil(x2)), int(np.ceil(y2))
        fxi1 = w - xi2
        fxi2 = w - xi1
        if xi2 <= xi1 or yi2 <= yi1 or fxi1 < 0 or fxi2 > w:
            continue
        patch = img[yi1:yi2, xi1:xi2][:, ::-1]
        if polys:
            mask = np.zeros(patch.shape[:2], np.uint8)
            rel = polys[j] - np.array([xi1, yi1], np.float32)
            rel[:, 0] = (xi2 - xi1) - rel[:, 0]  # mirrored inside the patch
            cv.fill_poly(mask, np.round(rel).astype(np.int32), 1)
            region = img[yi1:yi2, fxi1:fxi2]
            img[yi1:yi2, fxi1:fxi2] = np.where(mask[..., None] > 0, patch, region)
            flipped = polys[j].copy()
            flipped[:, 0] = w - flipped[:, 0]
            new_polys.append(flipped)
        else:
            img[yi1:yi2, fxi1:fxi2] = patch
        new_boxes.append(cand)
        new_cls.append(labels["cls"][j])
        if "tags" in labels:
            new_tags.append(labels["tags"][j])
        if kpts is not None and len(kpts):
            k = kpts[j].copy()
            k[..., 0] = w - k[..., 0]
            new_kpts.append(k)
    if new_boxes:
        labels["img"] = img
        labels["bboxes"] = np.concatenate([boxes, np.stack(new_boxes)]).astype(np.float32)
        labels["cls"] = np.concatenate([labels["cls"], np.array(new_cls, np.float32)])
        if "tags" in labels:
            labels["tags"] = np.concatenate([labels["tags"], np.array(new_tags, np.float32)])
        if kpts is not None and len(kpts):
            labels["keypoints"] = np.concatenate([kpts, np.stack(new_kpts)]).astype(np.float32)
        if polys is not None:
            labels["polygons"] = list(polys) + new_polys
    return labels
