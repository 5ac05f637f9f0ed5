"""Inference results: boxes (with track ids), for JDE ReID embeddings and posture states,
pose keypoints, segment masks, classification probabilities and rotated boxes (port of
`sar_yolo_tpu/engine/results.py`; numpy-backed).

`plot` draws as the JAX package's does with OpenCV, through the port's copies of OpenCV's
drawing (`data/cv.py`: bit for bit, the label text in OpenCV 4.x's Hershey strokes);
`save` and `save_crop` write through `data/imageio.py::imwrite` (JPEG bytes equal to
OpenCV's); `Masks.xy` follows contours as cv2.findContours does. The pandas tables
(`to_df`, `to_csv`, `to_xml`) raise NotImplementedError: pandas is no dependency of the port.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from sar_yolo_tpu_torch.data import cv
from sar_yolo_tpu_torch.data.imageio import imwrite

# the JAX package's box colours (BGR), by track id or else by class
PALETTE = [(56, 56, 255), (31, 112, 255), (29, 178, 255), (49, 210, 207), (10, 249, 72),
           (23, 204, 146), (134, 219, 61), (52, 147, 26)]


def _not_ported(what: str):
    raise NotImplementedError(f"Results.{what} is not part of this port (it needs pandas, "
                              "which is no dependency of the port)")


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
        """Each mask's largest outer contour (by area, the first on ties) in the mask's
        pixels, (k, 2) float32; (0, 2) for an empty mask."""
        out = []
        for m in self.data:
            cs = cv.find_contours_external(m.astype(np.uint8))
            out.append(max(cs, key=cv.contour_area).reshape(-1, 2).astype(np.float32)
                       if cs else np.zeros((0, 2), np.float32))
        return out

    @property
    def xyn(self):
        h, w = self.orig_shape
        return [c / np.array([w, h], np.float32) for c in self.xy]


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

    def plot(self, line_width=None, font_scale=0.5):
        """A BGR copy of the image with the masks blended in (0.6 image, 0.4 colour), the
        rotated boxes, the boxes with their labels ("id:{k} " + "{name} {conf:.2f}" +
        " s{state}"), the keypoints and the top-1 class drawn, as the JAX package draws
        them. `lw` is line_width or max(2, round(min(h, w) / 320)); the text is 1 thinner."""
        img = self.orig_img.copy()
        lw = line_width or max(2, round(min(self.orig_shape) / 320))
        if self.masks is not None and len(self.masks):
            overlay = img.copy()
            for i, m in enumerate(self.masks.data):
                mm = m.astype(bool)
                if mm.shape != img.shape[:2]:
                    mm = cv.resize(m.astype(np.uint8), img.shape[:2][::-1]) > 0
                overlay[mm] = PALETTE[i % len(PALETTE)]
            img = cv.add_weighted(img, 0.6, overlay, 0.4, 0)
        if self.obb is not None and len(self.obb):
            for i, corners in enumerate(self.obb.xyxyxyxy):
                cv.polylines(img, [corners.astype(np.int32)], True, PALETTE[i % len(PALETTE)], lw)
        if self.boxes is not None:
            ids = self.boxes.id
            for i, row in enumerate(self.boxes.data):
                x1, y1, x2, y2, conf, cls = row[:6]
                c = int(cls)
                color = PALETTE[(int(ids[i]) if ids is not None else c) % len(PALETTE)]
                cv.rectangle(img, (int(x1), int(y1)), (int(x2), int(y2)), color, lw)
                label = f"{self.names.get(c, c)} {conf:.2f}"
                if ids is not None:
                    label = f"id:{int(ids[i])} " + label
                if self.person_states is not None:
                    label += f" s{int(self.person_states[i])}"
                cv.put_text(img, label, (int(x1), max(int(y1) - 3, 10)), font_scale, color,
                            max(lw - 1, 1))
        if self.keypoints is not None:
            for kp in self.keypoints.data:
                for k in kp:
                    if len(k) < 3 or k[2] > 0.5:
                        cv.circle(img, (int(k[0]), int(k[1])), max(lw, 2), (0, 255, 255), -1)
        if self.probs is not None:
            label = f"{self.names.get(self.probs.top1, self.probs.top1)} " \
                    f"{self.probs.top1conf:.2f}"
            cv.put_text(img, label, (8, 24), 0.8, (255, 255, 255), 2)
        return img

    def save(self, filename):
        """Write `plot()` to filename (.jpg / .jpeg at quality 95, or .png)."""
        Path(filename).parent.mkdir(parents=True, exist_ok=True)
        imwrite(filename, self.plot())
        return filename

    def save_crop(self, save_dir, file_name: str | None = None):
        """Each box's pixels of the image (clipped to it) as save_dir/<class name>/
        {stem}_{i}.jpg; boxes of no area are skipped."""
        if self.boxes is None:
            return
        stem = file_name or Path(str(self.path)).stem
        h, w = self.orig_shape
        for i, row in enumerate(self.boxes.data):
            x1, y1, x2, y2 = (int(np.clip(v, 0, lim)) for v, lim in zip(row[:4], (w, h, w, h)))
            if x2 <= x1 or y2 <= y1:
                continue
            d = Path(save_dir) / str(self.names.get(int(row[5]), str(int(row[5]))))
            d.mkdir(parents=True, exist_ok=True)
            imwrite(d / f"{stem}_{i}.jpg", self.orig_img[y1:y2, x1:x2])

    def to_df(self, *args, **kwargs):
        _not_ported("to_df")

    def to_csv(self, *args, **kwargs):
        _not_ported("to_csv")

    def to_xml(self, *args, **kwargs):
        _not_ported("to_xml")
