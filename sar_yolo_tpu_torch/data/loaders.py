"""Inference sources of `YOLO.predict` and `YOLO.track` (port of the image, array and
tensor loaders of `sar_yolo_tpu/data/loaders.py`).

Every loader yields (path, frame_bgr_uint8, meta) triples; the predictor serves them one
frame at a time. Image files are read by `data/imageio.py` (PNG and JPEG as
`cv2.imread` reads them). Video files, streams and screenshots raise
NotImplementedError: they need `cv2.VideoCapture` or `mss`, which the card's machine
does not have.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from sar_yolo_tpu_torch.data.dataset import IMG_FORMATS
from sar_yolo_tpu_torch.data.imageio import imread

VID_FORMATS = {"asf", "avi", "gif", "m4v", "mkv", "mov", "mp4", "mpeg", "mpg", "ts",
               "wmv", "webm"}


@dataclass
class SourceTypes:
    """What kind of source the predictor was given."""
    stream: bool = False
    screenshot: bool = False
    from_img: bool = False
    tensor: bool = False


def is_stream_source(source) -> bool:
    s = str(source)
    return (s.isnumeric() or s.lower().startswith(("rtsp://", "rtmp://", "http://",
                                                   "https://", "tcp://"))
            or s.endswith(".streams"))


def _not_ported(what: str):
    raise NotImplementedError(f"{what} sources are not part of this port yet: they need a "
                              "video decoder (cv2.VideoCapture) or screen capture (mss)")


class LoadImagesAndVideos:
    """Image files: one file, a directory (searched recursively) or a glob (relative, or
    absolute, which the JAX package's `Path().glob` refuses), in sorted order."""

    def __init__(self, source):
        p = Path(source)
        if "*" in str(source):
            root = Path(p.anchor) if p.is_absolute() else Path()
            self.files = sorted(root.glob(str(p.relative_to(root)) if p.is_absolute() else str(p)))
        elif p.is_dir():
            self.files = sorted(f for f in p.rglob("*")
                                if f.suffix[1:].lower() in IMG_FORMATS | VID_FORMATS)
        elif p.is_file():
            self.files = [p]
        else:
            raise FileNotFoundError(f"source not found: {source}")

    def __iter__(self):
        for f in self.files:
            if f.suffix[1:].lower() in VID_FORMATS:
                _not_ported(f"video file ({f})")
            img = imread(f)
            if img is not None:
                yield str(f), img, {}


class LoadPilAndNumpy:
    """In-memory images: numpy arrays, or objects with PIL's `convert("RGB")` (this port
    imports no PIL)."""

    def __init__(self, source):
        self.items = source if isinstance(source, (list, tuple)) else [source]

    @staticmethod
    def _to_bgr(im):
        if im.__class__.__module__.startswith("PIL"):
            return np.ascontiguousarray(np.asarray(im.convert("RGB"))[..., ::-1])
        arr = np.asarray(im)
        if arr.dtype != np.uint8:
            arr = (arr.clip(0, 1) * 255).astype(np.uint8) if arr.max() <= 1.0 \
                else arr.clip(0, 255).astype(np.uint8)
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        elif arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, axis=-1)
        elif arr.shape[-1] == 4:
            arr = arr[..., :3]
        return np.ascontiguousarray(arr)

    def __iter__(self):
        for i, im in enumerate(self.items):
            yield f"image{i}.jpg", self._to_bgr(im), {"from_img": True}


class LoadTensor:
    """torch or numpy tensors, NHWC or NCHW, float in [0, 1] or uint8; RGB, served as BGR."""

    def __init__(self, source):
        arr = source.detach().cpu().numpy() if isinstance(source, torch.Tensor) \
            else np.asarray(source)
        if arr.ndim == 3:
            arr = arr[None]
        if arr.shape[1] in (1, 3) and arr.shape[-1] not in (1, 3):  # NCHW -> NHWC
            arr = arr.transpose(0, 2, 3, 1)
        if arr.dtype != np.uint8:
            if arr.max() > 1.0 + 1e-3:
                raise ValueError("float tensor source must be normalized to [0, 1]")
            arr = (arr * 255).astype(np.uint8)
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, -1)
        elif arr.shape[-1] == 4:
            arr = arr[..., :3]
        self.batch = arr[..., ::-1]

    def __iter__(self):
        for i, im in enumerate(self.batch):
            yield f"tensor{i}.jpg", np.ascontiguousarray(im), {"tensor": True}


class _Chain:
    """Image loaders over a list of paths, one after another."""

    def __init__(self, items):
        self.items = items

    def __iter__(self):
        for it in self.items:
            yield from LoadImagesAndVideos(it)


def load_inference_source(source):
    """The loader of a user's source, and its SourceTypes."""
    st = SourceTypes()
    if source is None:
        raise ValueError("source is required")
    if isinstance(source, torch.Tensor):
        st.tensor = True
        return LoadTensor(source), st
    if isinstance(source, np.ndarray):
        if source.ndim == 4 or source.dtype != np.uint8:
            st.tensor = True
            return LoadTensor(source), st
        st.from_img = True
        return LoadPilAndNumpy(source), st
    if source.__class__.__module__.startswith("PIL"):
        st.from_img = True
        return LoadPilAndNumpy(source), st
    if isinstance(source, (list, tuple)) and source and \
            not isinstance(source[0], (str, Path)):
        st.from_img = True
        return LoadPilAndNumpy(source), st
    s = str(source)
    if s.lower().startswith("screen"):
        _not_ported("screenshot")
    if is_stream_source(s):
        _not_ported("stream")
    if isinstance(source, (list, tuple)):
        return _Chain(source), st
    return LoadImagesAndVideos(source), st
