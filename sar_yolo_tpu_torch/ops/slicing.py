"""Sliced (SAHI-style) inference for large aerial frames (port of
`sar_yolo_tpu/ops/slicing.py`: host numpy around the port's `YOLO.predict`).

  * the tile grid is computed on the host from the image geometry;
  * all tiles of a frame go through one `YOLO.predict` call at imgsz = tile;
  * per-tile detections are shifted to global coordinates and merged with a
    greedy class-aware NMS on the host (few rows after per-tile NMS).

Typical use on 4000 px SAR/UAV imagery where small persons vanish at 640 px:

    from sar_yolo_tpu_torch.ops.slicing import sliced_predict
    boxes = sliced_predict(model, frame, tile=512, overlap=0.2)
"""

from __future__ import annotations

import numpy as np


def tile_grid(h: int, w: int, tile: int, overlap: float) -> list[tuple[int, int]]:
    """Top-left offsets of `tile`-sized crops covering (h, w) with `overlap`.

    The final row/column is right/bottom-aligned so the image edge is always
    covered exactly once (same policy as sahi's slice generator).
    """
    stride = max(1, int(tile * (1.0 - overlap)))

    def axis(extent):
        if extent <= tile:
            return [0]
        offs = list(range(0, extent - tile, stride))
        offs.append(extent - tile)
        return offs

    return [(y, x) for y in axis(h) for x in axis(w)]


def _greedy_nms_np(boxes: np.ndarray, scores: np.ndarray, iou_thres: float) -> list[int]:
    """Host greedy NMS over xyxy boxes; returns kept indices, score-descending."""
    order = np.argsort(-scores)
    keep: list[int] = []
    while len(order):
        i = order[0]
        keep.append(int(i))
        if len(order) == 1:
            break
        rest = order[1:]
        x1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        y1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        x2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        y2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        a_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        a_r = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(a_i + a_r - inter, 1e-9)
        order = rest[iou <= iou_thres]
    return keep


def merge_tile_detections(per_tile: list[np.ndarray], offsets: list[tuple[int, int]],
                          iou_thres: float = 0.5, max_det: int = 300) -> np.ndarray:
    """Shift per-tile (N_i, 6+) [x1 y1 x2 y2 conf cls ...] rows into global
    coordinates and merge duplicates from overlapping tiles (class-aware NMS)."""
    rows = []
    for det, (oy, ox) in zip(per_tile, offsets):
        det = np.asarray(det, np.float32)
        if det.size == 0:
            continue
        det = det.copy()
        det[:, [0, 2]] += ox
        det[:, [1, 3]] += oy
        rows.append(det)
    if not rows:
        return np.zeros((0, 6), np.float32)
    dets = np.concatenate(rows, 0)
    # class-aware: offset boxes by class id so NMS never crosses classes
    span = max(float(dets[:, 2].max()), float(dets[:, 3].max())) + 1.0
    shifted = dets[:, :4] + dets[:, 5:6] * span
    keep = _greedy_nms_np(shifted, dets[:, 4], iou_thres)[:max_det]
    return dets[keep]


def sliced_predict(model, img: np.ndarray, tile: int = 512, overlap: float = 0.2,
                   conf: float = 0.25, iou: float = 0.7, merge_iou: float = 0.5,
                   max_det: int = 300, **predict_kwargs) -> np.ndarray:
    """Detect on a large image by tile inference + global merge.

    Args:
        model: a YOLO facade instance (predict-capable).
        img: HWC uint8/float image of any size.
        tile: slice side in pixels (also the per-tile inference imgsz).
        overlap: fractional overlap between adjacent tiles.
        conf / iou: per-tile thresholds; merge_iou: cross-tile duplicate NMS.

    Returns (N, 6+) float32 [x1 y1 x2 y2 conf cls ...] in full-image pixels.
    """
    smax = int(max(getattr(model, "meta", {}).get("strides") or [32]))
    if tile % smax:  # imgsz must be stride-aligned (≙ reference check_imgsz)
        new_tile = int(np.ceil(tile / smax) * smax)
        from sar_yolo_tpu_torch.utils import LOGGER
        LOGGER.warning(f"sliced_predict: tile {tile} rounded up to {new_tile} "
                       f"(must be a multiple of the model's max stride {smax})")
        tile = new_tile
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (img.clip(0, 1) * 255).astype(np.uint8) if img.max() <= 1.0 \
            else img.clip(0, 255).astype(np.uint8)
    h, w = img.shape[:2]
    offsets = tile_grid(h, w, tile, overlap)
    # img follows model.predict's 3D-numpy convention (BGR); the stacked 4D
    # batch is read as a tensor source, which is RGB: flip once here so
    # both entry points mean the same thing by "frame"
    tiles = np.stack([_pad_crop(img, oy, ox, tile) for oy, ox in offsets])[..., ::-1]
    results = model.predict(tiles, imgsz=tile, conf=conf, iou=iou, max_det=max_det,
                            **predict_kwargs)
    per_tile = [np.asarray(r.boxes.data) if r.boxes is not None else
                np.zeros((0, 6), np.float32) for r in results]
    return merge_tile_detections(per_tile, offsets, merge_iou, max_det)


def _pad_crop(img: np.ndarray, oy: int, ox: int, tile: int) -> np.ndarray:
    """Crop a tile, zero-padding when the image is smaller than one tile."""
    crop = img[oy:oy + tile, ox:ox + tile]
    if crop.shape[0] == tile and crop.shape[1] == tile:
        return crop
    out = np.zeros((tile, tile) + img.shape[2:], img.dtype)
    out[:crop.shape[0], :crop.shape[1]] = crop
    return out
