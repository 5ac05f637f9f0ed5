"""Procedural detection data (port of the detect/JDE branches of
`sar_yolo_tpu/data/dataset.py::SyntheticDataset`)."""

from __future__ import annotations

import numpy as np

_COLORS = [(220, 40, 40), (40, 220, 40), (40, 40, 220), (220, 220, 40), (220, 40, 220)]


class SyntheticDataset:
    """Coloured rectangles on noise, deterministic per index; no files needed.

    Each item: 'img' (s, s, 3) uint8, 'cls' (M,), 'bboxes' (M, 4) normalized
    xywh, 'mask' (M,), and for JDE 'tags' (M,) person ids, all float32 and
    padded to M = max_labels rows; 1-5 rectangles with sides 0.1-0.3 of the
    image. Under JDE a rectangle's colour follows its identity tag, so the
    embedding and state heads have a signal.
    """

    def __init__(self, n=64, imgsz=640, nc=3, max_labels=128, seed=0, task="detect"):
        if task not in ("detect", "jde"):
            raise ValueError(f"SyntheticDataset: task '{task}' is not part of this port yet")
        self.n, self.imgsz, self.nc, self.max_labels = n, imgsz, nc, max_labels
        self.seed, self.task = seed, task

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(self.seed * 100003 + i)
        s, M = self.imgsz, self.max_labels
        img = rng.uniform(0, 60, (s, s, 3)).astype(np.uint8)
        n_obj = int(rng.integers(1, 6))
        cls = np.zeros(M, np.float32)
        boxes = np.zeros((M, 4), np.float32)
        mask = np.zeros(M, np.float32)
        tags = np.zeros(M, np.float32)
        for j in range(n_obj):
            c = int(rng.integers(0, self.nc))
            w = rng.uniform(0.1, 0.3) * s
            h = rng.uniform(0.1, 0.3) * s
            cx = rng.uniform(w / 2, s - w / 2)
            cy = rng.uniform(h / 2, s - h / 2)
            x1, y1, x2, y2 = int(cx - w / 2), int(cy - h / 2), int(cx + w / 2), int(cy + h / 2)
            tag = j % 4
            img[y1:y2, x1:x2] = _COLORS[(tag if self.task == "jde" else c) % len(_COLORS)]
            boxes[j] = [cx / s, cy / s, w / s, h / s]
            cls[j], mask[j], tags[j] = c, 1.0, tag
        out = {"img": img, "cls": cls, "bboxes": boxes, "mask": mask}
        if self.task == "jde":
            out["tags"] = tags
        return out
