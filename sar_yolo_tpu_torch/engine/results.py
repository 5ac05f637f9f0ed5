"""Inference results of the JDE slice: boxes, ReID embeddings and posture states
(the serving subset of `sar_yolo_tpu/engine/results.py`; numpy-backed)."""

from __future__ import annotations

import numpy as np


class Boxes:
    """Detection rows [x1, y1, x2, y2, conf, cls] of one image."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = data
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, 4]

    @property
    def cls(self):
        return self.data[:, 5]


class Results:
    """One image's detections, with `embeds` (n, E) and `person_states` (n,) for JDE."""

    def __init__(self, orig_img, path, names, boxes=None, embeds=None, person_states=None,
                 speed=None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.embeds = embeds
        self.person_states = person_states
        self.speed = speed or {}

    def __len__(self):
        return 0 if self.boxes is None else len(self.boxes)
