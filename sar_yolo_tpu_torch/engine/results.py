"""Inference results: boxes (with track ids), for JDE ReID embeddings and posture states,
pose keypoints, segment masks, classification probabilities and rotated boxes (port of
`sar_yolo_tpu/engine/results.py`; numpy-backed).

Drawing and file writers (`plot`, `save`, `save_crop`), the pandas tables (`to_df`,
`to_csv`, `to_xml`) and the mask contours (`Masks.xy`, `Masks.xyn`: cv2.findContours)
raise NotImplementedError: they need OpenCV, a JPEG encoder or pandas, which the card's
machine does not have.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def _not_ported(what: str):
    raise NotImplementedError(f"Results.{what} is not part of this port yet (it needs OpenCV's "
                              "drawing and image writers, or pandas)")


class Boxes:
    """Detection rows [x1, y1, x2, y2, conf, cls] of one image (+ the track id in column 6)."""

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

    @property
    def xywh(self):
        b = self.data[:, :4]
        return np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                         b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], 1)

    @property
    def xyxyn(self):
        h, w = self.orig_shape
        return self.xyxy / np.array([w, h, w, h])

    @property
    def xywhn(self):
        h, w = self.orig_shape
        return self.xywh / np.array([w, h, w, h])

    @property
    def id(self):
        """Track ids where a tracker assigned them (column 6), else None."""
        return self.data[:, 6] if self.data.shape[1] > 6 else None

    @property
    def is_track(self):
        return self.data.shape[1] > 6


class _Rows:
    """`data` of one image with its `orig_shape`; len, indexing, cpu() and numpy()."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = data
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return type(self)(self.data[i][None] if isinstance(i, (int, np.integer)) else self.data[i],
                          self.orig_shape)

    def cpu(self):
        return self

    def numpy(self):
        return self


class Masks(_Rows):
    """Instance masks (n, H, W), bool."""

    @property
    def xy(self):
        raise NotImplementedError("Masks.xy is not part of this port yet (it needs "
                                  "cv2.findContours)")

    @property
    def xyn(self):
        raise NotImplementedError("Masks.xyn is not part of this port yet (it needs "
                                  "cv2.findContours)")


class Keypoints(_Rows):
    """Pose keypoints (n, K, 2 or 3) in the frame's pixels."""

    @property
    def xy(self):
        return self.data[..., :2]

    @property
    def xyn(self):
        h, w = self.orig_shape
        return self.data[..., :2] / np.array([w, h])

    @property
    def conf(self):
        return self.data[..., 2] if self.data.shape[-1] == 3 else None


class Probs:
    """Classification probabilities (nc,) of one image."""

    def __init__(self, data, orig_shape=None):
        self.data = np.asarray(data).reshape(-1)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def top1(self) -> int:
        return int(self.data.argmax())

    @property
    def top5(self) -> list:
        return np.argsort(-self.data)[:5].tolist()

    @property
    def top1conf(self) -> float:
        return float(self.data.max())

    @property
    def top5conf(self):
        return self.data[self.top5]


class OBB(_Rows):
    """Rotated boxes of one image: rows [cx, cy, w, h, r, conf, cls]."""

    @property
    def xywhr(self):
        return self.data[:, :5]

    @property
    def conf(self):
        return self.data[:, 5]

    @property
    def cls(self):
        return self.data[:, 6]

    @property
    def xyxyxyxy(self):
        """The corners (n, 4, 2)."""
        cx, cy, w, h, r = (self.data[:, i] for i in range(5))
        cos, sin = np.cos(r), np.sin(r)
        dx = np.stack([w / 2, w / 2, -w / 2, -w / 2], 1)
        dy = np.stack([h / 2, -h / 2, -h / 2, h / 2], 1)
        x = cx[:, None] + dx * cos[:, None] - dy * sin[:, None]
        y = cy[:, None] + dx * sin[:, None] + dy * cos[:, None]
        return np.stack([x, y], -1)

    @property
    def xyxy(self):
        """The axis-aligned envelope (n, 4) of each rotated box."""
        c = self.xyxyxyxy
        return np.concatenate([c.min(1), c.max(1)], 1)


class Results:
    """One image's detections, with `embeds` (n, E) and `person_states` (n,) for JDE,
    `keypoints` for pose, `masks` for segment, `obb` for OBB; or `probs` for classify."""

    def __init__(self, orig_img, path, names, boxes=None, embeds=None, person_states=None,
                 speed=None, masks=None, keypoints=None, probs=None, obb=None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.masks = Masks(np.asarray(masks), self.orig_shape) if masks is not None else None
        self.keypoints = Keypoints(np.asarray(keypoints), self.orig_shape) \
            if keypoints is not None else None
        self.probs = Probs(probs) if probs is not None else None
        self.obb = OBB(np.asarray(obb), self.orig_shape) if obb is not None else None
        self.embeds = embeds
        self.person_states = person_states
        self.speed = speed or {}
        self.frame = None

    def __len__(self):
        for rows in (self.boxes, self.obb, self.masks, self.keypoints):
            if rows is not None:
                return len(rows)
        return 0

    def new(self) -> "Results":
        """Empty Results carrying the same image and names."""
        return Results(orig_img=self.orig_img, path=self.path, names=self.names)

    def update(self, boxes=None, masks=None, probs=None, obb=None):
        """Replace the boxes, masks, probabilities or rotated boxes in place."""
        if boxes is not None:
            self.boxes = Boxes(np.asarray(boxes), self.orig_shape)
        if masks is not None:
            self.masks = Masks(np.asarray(masks), self.orig_shape)
        if probs is not None:
            self.probs = Probs(probs)
        if obb is not None:
            self.obb = obb if isinstance(obb, OBB) else OBB(np.asarray(obb), self.orig_shape)
        return self

    def summary(self, normalize: bool = False) -> list:
        """One dict a detection (a classify result: one dict of its top-1 class)."""
        out = []
        if self.probs is not None:
            return [{"name": str(self.names.get(self.probs.top1, self.probs.top1)),
                     "class": self.probs.top1, "confidence": self.probs.top1conf}]
        if self.boxes is None:
            return out
        h, w = self.orig_shape
        ids = self.boxes.id
        for i, row in enumerate(self.boxes.data):
            box = row[:4] / np.array([w, h, w, h]) if normalize else row[:4]
            item = {"name": str(self.names.get(int(row[5]), int(row[5]))),
                    "class": int(row[5]), "confidence": float(row[4]),
                    "box": {k: float(v) for k, v in zip("x1 y1 x2 y2".split(), box)}}
            if ids is not None:
                item["track_id"] = int(ids[i])
            if self.person_states is not None:
                item["person_state"] = int(self.person_states[i])
            out.append(item)
        return out

    def to_json(self, normalize: bool = False) -> str:
        return json.dumps(self.summary(normalize=normalize))

    tojson = to_json

    def verbose(self) -> str:
        """One-line summary, e.g. '3 persons' (a classify result: its top-1 class and
        confidence)."""
        if self.probs is not None:
            return f"{self.names.get(self.probs.top1, self.probs.top1)} {self.probs.top1conf:.2f}"
        if self.boxes is None or len(self.boxes) == 0:
            return "(no detections)"
        cls, counts = np.unique(self.boxes.cls.astype(int), return_counts=True)
        return ", ".join(f"{n} {self.names.get(int(c), c)}{'s' * int(n > 1)}"
                         for c, n in zip(cls, counts))

    def save_txt(self, txt_file, save_conf: bool = True):
        """YOLO-format label rows: class, normalized xywh, the confidence, the track id; a
        classify result: one row 'top1conf top1'."""
        lines = []
        if self.probs is not None:
            lines.append(f"{self.probs.top1conf:.2f} {self.probs.top1}")
        elif self.boxes is not None:
            ids = self.boxes.id
            for i, row in enumerate(self.boxes.data):
                cx, cy, bw, bh = self.boxes.xywhn[i]
                line = f"{int(row[5])} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}"
                if save_conf:
                    line += f" {row[4]:.4f}"
                if ids is not None:
                    line += f" {int(ids[i])}"
                lines.append(line)
        p = Path(txt_file)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("\n".join(lines) + ("\n" if lines else ""))
        return p

    def cpu(self):
        return self

    def numpy(self):
        return self

    def plot(self, *args, **kwargs):
        _not_ported("plot")

    def save(self, *args, **kwargs):
        _not_ported("save")

    def save_crop(self, *args, **kwargs):
        _not_ported("save_crop")

    def to_df(self, *args, **kwargs):
        _not_ported("to_df")

    def to_csv(self, *args, **kwargs):
        _not_ported("to_csv")

    def to_xml(self, *args, **kwargs):
        _not_ported("to_xml")
