"""FastSAM: segment-everything over the segment task, with prompt filters applied to its
Results afterwards (port of `sar_yolo_tpu/models/fastsam/__init__.py`).

Everything mode is one-class segmentation of the whole image; box and point prompts keep the
masks they select. Text prompts need CLIP towers that are not bundled and raise, as in the
JAX package.
"""

from __future__ import annotations

import numpy as np

from sar_yolo_tpu_torch.engine.model import YOLO


class FastSAM(YOLO):
    """Everything-segmentation facade; the default model is FastSAM-s.yaml (nc 1, segment).

    Examples:
        >>> m = FastSAM("FastSAM-s.yaml")                         # on cuda
        >>> res = m.predict("frames/", imgsz=640, bboxes=[[100, 80, 400, 300]])
    """

    def __init__(self, model: str = "FastSAM-s.yaml", task: str | None = None, device=None):
        super().__init__(model, task="segment", device=device)

    def predict(self, source, stream: bool = False, bboxes=None, points=None, labels=None,
                texts=None, text_embeddings=None, **kwargs):
        """Segment everything, then keep what the prompts select: `bboxes` (n, 4) xyxy keep
        the mask whose box has the largest IoU with each; `points` (n, 2) with `labels`
        (1 foreground, 0 background) keep the masks holding a foreground point and drop those
        holding a background one."""
        results = super().predict(source, stream=False, **kwargs)
        out = [self._prompt(r, bboxes, points, labels, texts, text_embeddings) for r in results]
        return iter(out) if stream else out

    @staticmethod
    def _prompt(result, bboxes, points, labels, texts, text_embeddings):
        if result.masks is None or len(result.masks) == 0 or \
                (bboxes is None and points is None and texts is None):
            return result
        keep = np.zeros(len(result.masks), bool)
        masks = result.masks.data.astype(bool)
        if bboxes is not None:
            rb = result.boxes.data[:, :4]
            area_r = (rb[:, 2] - rb[:, 0]) * (rb[:, 3] - rb[:, 1])
            for b in np.atleast_2d(np.asarray(bboxes, np.float32)):
                iw = np.clip(np.minimum(b[2], rb[:, 2]) - np.maximum(b[0], rb[:, 0]), 0, None)
                ih = np.clip(np.minimum(b[3], rb[:, 3]) - np.maximum(b[1], rb[:, 1]), 0, None)
                inter = iw * ih
                union = area_r + (b[2] - b[0]) * (b[3] - b[1]) - inter
                keep[np.argmax(inter / np.maximum(union, 1e-9))] = True
        if points is not None:
            pts = np.atleast_2d(np.asarray(points, np.float32))
            lbl = np.asarray(labels if labels is not None else np.ones(len(pts)), int)
            h, w = result.orig_shape
            mh, mw = masks.shape[1:]
            for (x, y), label in zip(pts, lbl):
                hit = masks[:, int(np.clip(y * mh / h, 0, mh - 1)),
                            int(np.clip(x * mw / w, 0, mw - 1))]
                keep = keep | hit if label == 1 else keep & ~hit
        if texts is not None:
            if text_embeddings is None:
                raise ValueError("text prompts need a text encoder; none is bundled offline — "
                                 "pass text_embeddings=callable(prompt)->vector")
            raise NotImplementedError("text-prompt filtering requires CLIP image+text towers "
                                      "(unavailable in the offline build)")
        idx = np.nonzero(keep)[0]
        result.boxes.data = result.boxes.data[idx]
        result.masks.data = result.masks.data[idx]
        return result


__all__ = ["FastSAM"]
