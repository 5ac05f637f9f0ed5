"""Host augmentation of the detect and JDE samples (port of the box branches of
`sar_yolo_tpu/data/augment.py`: letterbox, HSV, flip, the affine `random_perspective`,
`mosaic4`, `mixup`, `copy_paste`).

Samples flow as dicts: img uint8 HWC BGR, cls (n,), bboxes (n, 4) xyxy pixels, tags
(n,) person ids, which every step keeps aligned with the boxes. Each function makes
the same numpy draws in the same order as the JAX package's, so one (seed, epoch,
index) key gives the same sample in both packages; the OpenCV calls are the bit-exact
numpy versions of `data/cv.py`.

Not ported, and refused where asked for: the perspective warp (`perspective > 0`),
`mosaic9`, and the keypoint and polygon branches. The JAX package's `Albumentations`
step is a no-op where that library is missing, as it is wherever this port runs, and
has no counterpart here.
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


def random_flip(labels: dict, fliplr=0.5, flipud=0.0, rng=None) -> dict:
    """Vertical, then horizontal flip of the image and boxes."""
    img = labels["img"]
    h, w = img.shape[:2]
    boxes = labels["bboxes"]
    if flipud and rng.random() < flipud:
        labels["img"] = np.flipud(img).copy()
        if len(boxes):
            boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
    img = labels["img"]
    if fliplr and rng.random() < fliplr:
        labels["img"] = np.fliplr(img).copy()
        if len(boxes):
            boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
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
    """Random affine warp of image and boxes (tags kept aligned). The perspective
    terms are drawn as the JAX package draws them; a non-zero gain raises."""
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

    boxes = labels["bboxes"]
    n = len(boxes)
    if n:
        xy1 = np.ones((n * 4, 3))
        xy1[:, :2] = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
        xy = (xy1 @ M.T)[:, :2].reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, w)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, h)
        keep = _box_candidates(boxes.T * s, new.T, area_thr=0.1)
        labels["bboxes"] = new[keep]
        labels["cls"] = labels["cls"][keep]
        if "tags" in labels:
            labels["tags"] = labels["tags"][keep]
    labels["img"] = img
    return labels


def mosaic4(items: list[dict], imgsz: int, rng=None) -> dict:
    """4-image mosaic on a (2 imgsz)^2 canvas around a random centre; tags concatenate
    like boxes."""
    s = imgsz
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    img4 = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
    cls4, boxes4, tags4 = [], [], []
    has_tags = "tags" in items[0]
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
    out = {"img": img4, "cls": np.concatenate(cls4), "bboxes": np.concatenate(boxes4),
           "mosaic_border": (-s // 2, -s // 2)}
    if has_tags:
        out["tags"] = np.concatenate(tags4)
    out["bboxes"][:, [0, 2]] = out["bboxes"][:, [0, 2]].clip(0, 2 * s)
    out["bboxes"][:, [1, 3]] = out["bboxes"][:, [1, 3]].clip(0, 2 * s)
    return out


def mixup(item1: dict, item2: dict, rng=None) -> dict:
    """MixUp of two samples: a beta(32, 32) image blend; labels and tags concatenate."""
    r = rng.beta(32.0, 32.0)
    out = {
        "img": (item1["img"].astype(np.float32) * r +
                item2["img"].astype(np.float32) * (1 - r)).astype(np.uint8),
        "cls": np.concatenate([item1["cls"], item2["cls"]]),
        "bboxes": np.concatenate([item1["bboxes"], item2["bboxes"]]),
    }
    if "tags" in item1:
        out["tags"] = np.concatenate([item1["tags"], item2.get("tags", np.zeros(len(item2["cls"])))])
    return out


def copy_paste(labels: dict, p: float = 0.1, ioa_thres: float = 0.30, rng=None) -> dict:
    """Copy-paste, 'flip' mode, box branch: each instance is, with probability p, pasted
    as its lr-flipped rectangle at its mirrored place where that box overlaps the
    existing ones by IoA < ioa_thres."""
    boxes = labels["bboxes"]
    n = len(boxes)
    if n == 0 or p <= 0:
        return labels
    img = labels["img"]
    h, w = img.shape[:2]
    new_boxes, new_cls, new_tags = [], [], []
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
        img[yi1:yi2, fxi1:fxi2] = img[yi1:yi2, xi1:xi2][:, ::-1]
        new_boxes.append(cand)
        new_cls.append(labels["cls"][j])
        if "tags" in labels:
            new_tags.append(labels["tags"][j])
    if new_boxes:
        labels["img"] = img
        labels["bboxes"] = np.concatenate([boxes, np.stack(new_boxes)]).astype(np.float32)
        labels["cls"] = np.concatenate([labels["cls"], np.array(new_cls, np.float32)])
        if "tags" in labels:
            labels["tags"] = np.concatenate([labels["tags"], np.array(new_tags, np.float32)])
    return labels
