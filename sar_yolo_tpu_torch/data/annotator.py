"""Auto-annotation (port of `sar_yolo_tpu/data/annotator.py`): detect with YOLO, prompt
SAM with each image's boxes, and write YOLO polygon labels."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from sar_yolo_tpu_torch.data.cv import contour_area, find_contours_external
from sar_yolo_tpu_torch.utils import LOGGER


def auto_annotate(data, det_model="yolov8n.yaml", sam_model="sam_b", conf=0.25, iou=0.45,
                  imgsz=640, max_det=300, classes=None, output_dir=None, det_weights=None,
                  sam_weights=None, device=None):
    """Detect objects in every image under `data`, prompt SAM with the boxes, and save one
    `{stem}.txt` a image with detections under output_dir (default
    `<data>_auto_annotate_labels` beside it): a line `cls x1 y1 x2 y2 ...` a mask, its
    largest outer contour normalized by the image's width and height, 6 decimals.

    det_model: a model name or path (det_weights, where given, instead), or a built YOLO.
    sam_model: a SAM name (sam_weights: its .pth state dict), or a built SAM. Models built
    here run on `device` (the card unless the CPU is asked for). Returns output_dir."""
    from sar_yolo_tpu_torch.engine.model import YOLO
    from sar_yolo_tpu_torch.models.sam import SAM

    det = det_model if isinstance(det_model, YOLO) else YOLO(det_weights or det_model,
                                                             device=device)
    sam = sam_model if isinstance(sam_model, SAM) else SAM(sam_model, weights=sam_weights,
                                                           device=device)
    data = Path(data)
    out = Path(output_dir or data.parent / f"{data.stem}_auto_annotate_labels")
    out.mkdir(parents=True, exist_ok=True)

    results = det.predict(str(data), stream=True, conf=conf, iou=iou, imgsz=imgsz,
                          max_det=max_det)
    n = 0
    for r in results:
        if r.boxes is None or len(r.boxes) == 0:
            continue
        cls = r.boxes.cls.astype(int)
        boxes = r.boxes.xyxy
        if classes is not None:
            keep = np.isin(cls, classes)
            cls, boxes = cls[keep], boxes[keep]
        if len(boxes) == 0:
            continue
        seg = sam(r.orig_img, bboxes=boxes)[0]
        h, w = r.orig_shape
        lines = []
        for c, m in zip(cls, seg.masks.data):
            contours = find_contours_external(m.astype(np.uint8))
            if not contours:
                continue
            poly = max(contours, key=contour_area).reshape(-1, 2).astype(np.float32)
            poly /= np.asarray([w, h], np.float32)
            coords = " ".join(f"{v:.6f}" for v in poly.reshape(-1))
            lines.append(f"{int(c)} {coords}")
        if lines:
            stem = Path(str(r.path)).stem
            (out / f"{stem}.txt").write_text("\n".join(lines) + "\n")
            n += 1
    LOGGER.info(f"auto_annotate: wrote {n} label files to {out}")
    return out
