"""Inference sources of `YOLO.predict` and `YOLO.track` (port of
`sar_yolo_tpu/data/loaders.py`): image files, folders and globs, video files, `.streams`
lists of video files, arrays and tensors.

Every loader yields (path, frame_bgr_uint8, meta) triples; the predictor serves them one
frame at a time. Image files are read by `data/imageio.py` (PNG and JPEG as
`cv2.imread` reads them). Video files are Motion-JPEG AVI (`data/avi.py`), their frames
decoded as `cv2.VideoCapture` decodes them (`imageio.decode_mjpeg_frame`), each yielded
with {"video": True, "frame": i, "frames": total, "fps": fps}; every frame is served
(`vid_stride` is accepted and not read, as in the JAX package). `LoadStreams` reads the
video files listed in a `.streams` file, one reader thread each. Other video containers
and codecs, webcam indices, network URLs and screenshots raise NotImplementedError:
they need a capture device, the network, `mss` or a decoder this port does not have.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from sar_yolo_tpu_torch.data.avi import AviReader
from sar_yolo_tpu_torch.data.dataset import IMG_FORMATS
from sar_yolo_tpu_torch.data.imageio import decode_mjpeg_frame, imread

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


def _not_ported(what: str, needs: str):
    raise NotImplementedError(f"{what} sources are not part of this port yet (ROADMAP Queue A "
                              f"item 1): they need {needs}")


def open_video(path) -> AviReader:
    """The demuxer of a local video file: Motion-JPEG AVI; other containers raise."""
    s = str(path)
    if s.isnumeric() or s.lower().startswith(("rtsp://", "rtmp://", "http://", "https://",
                                              "tcp://")):
        _not_ported(f"live camera and network ({s})", "a capture device or the network")
    p = Path(s)
    if not p.is_file():
        raise FileNotFoundError(f"video not found: {s}")
    if p.suffix[1:].lower() != "avi":
        _not_ported(f"{p.suffix} video ({s})", "a decoder of its codec; Motion-JPEG AVI is read")
    return AviReader(p)


def video_frames(path):
    """(path, frame, meta) of each frame of a video file, decoded as cv2.VideoCapture
    decodes it."""
    reader = open_video(path)
    meta = {"video": True, "frames": reader.frame_count, "fps": reader.fps or 30}
    for i, packet in enumerate(reader.packets()):
        yield str(path), decode_mjpeg_frame(packet), {**meta, "frame": i}


class LoadStreams:
    """Video files read as live streams, one reader thread each: a `.streams` file lists
    them one a line (or `sources` is one file). The JAX package's reader over
    cv2.VideoCapture, for local files: webcam indices and URLs raise NotImplementedError.

    `buffer=False` (the JAX package's only mode): each reader keeps the latest frame and
    the consumer takes whatever is newest, so a slow consumer drops frames. `buffer=True`
    queues every frame: round k yields frame k of each source that still has one, in the
    order of the list, whatever the readers' pace (the JAX package ignores
    `stream_buffer`; its buffered reader skips each source's first frame). A reader's
    decode error is raised by the iteration."""

    def __init__(self, sources="0", buffer: bool = False):
        src = str(sources)
        if src.endswith(".streams") and Path(src).is_file():
            items = [s.strip() for s in Path(src).read_text().splitlines() if s.strip()]
        else:
            items = [src]
        self.sources = items
        self.buffer = buffer
        self.frames = [None] * len(items)           # latest frame per source
        self.queues = [deque() for _ in items]      # buffered mode
        self.errors = [None] * len(items)
        self.cond = threading.Condition()
        self.running = True
        self._packets = [open_video(s).packets() for s in items]
        if not buffer:  # the first frame before any reader starts, as the JAX package reads it
            for i, packets in enumerate(self._packets):
                first = next(packets, None)
                if first is None:
                    raise ValueError(f"no frame in stream {items[i]}")
                self.frames[i] = decode_mjpeg_frame(first)
        self.threads = [threading.Thread(target=self._reader, args=(i,), daemon=True)
                        for i in range(len(items))]
        for t in self.threads:
            t.start()

    def _reader(self, i):
        try:
            for packet in self._packets[i]:
                if not self.running:
                    break
                frame = decode_mjpeg_frame(packet)
                with self.cond:
                    if self.buffer:
                        self.queues[i].append(frame)
                    else:
                        self.frames[i] = frame
                    self.cond.notify_all()
        except Exception as e:  # handed to the consumer, which raises it
            self.errors[i] = e
        finally:
            with self.cond:
                self.cond.notify_all()

    def _take(self, i):
        """The next frame of source i, or None; buffered: waits while its reader runs."""
        with self.cond:
            while True:
                done = not self.threads[i].is_alive()
                if self.errors[i] is not None:
                    raise self.errors[i]
                if self.buffer:
                    if self.queues[i]:
                        return self.queues[i].popleft(), True
                    if done:
                        return None, False
                    self.cond.wait(0.05)
                else:
                    frame, self.frames[i] = self.frames[i], None
                    return frame, not done

    def __iter__(self):
        frame_idx = 0
        try:
            while self.running:
                alive = False
                for i, s in enumerate(self.sources):
                    frame, live = self._take(i)
                    alive |= live
                    if frame is None:
                        continue
                    alive = True
                    yield s, frame, {"stream": True, "frame": frame_idx, "source_i": i}
                frame_idx += 1
                if not alive:
                    break
                if not self.buffer:
                    time.sleep(0.002)  # let the readers refill the latest-frame slots
        finally:
            self.close()

    def close(self):
        self.running = False
        for t in self.threads:
            if t.is_alive() and t is not threading.current_thread():
                t.join(timeout=2)


class LoadImagesAndVideos:
    """Image and video files: one file, a directory (searched recursively) or a glob
    (relative, or absolute, which the JAX package's `Path().glob` refuses), in sorted
    order; a video yields its frames in turn."""

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
                yield from video_frames(f)
                continue
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


def load_inference_source(source, buffer: bool = False):
    """The loader of a user's source, and its SourceTypes. `buffer`: a stream source's
    `LoadStreams` queues every frame."""
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
        _not_ported("screenshot", "screen capture (mss)")
    if is_stream_source(s):
        st.stream = True
        return LoadStreams(s, buffer=buffer), st
    if isinstance(source, (list, tuple)):
        return _Chain(source), st
    return LoadImagesAndVideos(source), st
