"""A RIFF/AVI demuxer for Motion-JPEG video (the container that OpenCV's FFmpeg writer
makes for the MJPG fourcc): the packets `cv2.VideoCapture` returns with
`CAP_PROP_FORMAT = -1`, and its `CAP_PROP_FPS` and `CAP_PROP_FRAME_COUNT`.

The headers (`hdrl`): for each stream `strh` and `strf`; the first video
stream is the one read. fps is the stream's dwRate / dwScale, the frame count its
dwLength. The frames are that stream's `##dc` / `##db` chunks of the `movi` list (and of
its `rec ` lists), in order; zero-length chunks carry no frame and are skipped. The
`idx1` index is not read: the frames come from `movi` itself.

OpenDML files (a super index `indx`, `ix##` chunks, an `AVIX` continuation) and codecs
other than MJPG raise NotImplementedError (ROADMAP Queue A item 1).

`AviWriter` writes such a file: RIFF AVI 1.0 with one Motion-JPEG video stream (`hdrl`:
`avih`, then `strl` with `strh` 'vids'/'MJPG' and a BITMAPINFOHEADER `strf`), one `00dc`
chunk a frame in `movi` (each frame `encode_jpeg(frame, 95)`), then the `idx1` index.
"""

from __future__ import annotations

import struct
from fractions import Fraction
from pathlib import Path

import numpy as np

NOT_PORTED = "is not part of this port yet (ROADMAP Queue A item 1)"


class AviReader:
    """The video stream of an AVI file: `fps`, `frame_count`, `fourcc`, and `packets()`,
    its frames' bytes in order."""

    def __init__(self, path):
        self.path = Path(path)
        self.frames: list[tuple[int, int]] = []  # (offset, size) of each packet
        self.fps = self.frame_count = 0
        self.fourcc = ""
        with open(self.path, "rb") as f:
            head = f.read(12)
            if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
                raise ValueError(f"{self.path}: not a RIFF/AVI file")
            size = f.seek(0, 2)
            riff_end = min(8 + struct.unpack("<I", head[4:8])[0], size)
            self._stream = None
            self._walk(f, 12, riff_end)
            if riff_end + 12 <= size:
                f.seek(riff_end + (riff_end & 1))
                nxt = f.read(12)
                if nxt[:4] == b"RIFF" and nxt[8:12] == b"AVIX":
                    raise NotImplementedError(f"{self.path}: OpenDML (AVIX) AVI {NOT_PORTED}")
        if self._stream is None:
            raise ValueError(f"{self.path}: no video stream")
        if self.fourcc.upper() != "MJPG":
            raise NotImplementedError(f"{self.path}: video codec '{self.fourcc}' {NOT_PORTED}; "
                                      "only Motion-JPEG (MJPG) AVI is read")

    def _chunks(self, f, start: int, end: int):
        """(id, data offset, size) of each chunk in [start, end)."""
        off = start
        while off + 8 <= end:
            f.seek(off)
            cid, size = struct.unpack("<4sI", f.read(8))
            yield cid, off + 8, size
            off += 8 + size + (size & 1)

    def _walk(self, f, start: int, end: int):
        streams = 0
        for cid, off, size in self._chunks(f, start, end):
            if cid == b"LIST":
                f.seek(off)
                kind = f.read(4)
                if kind == b"hdrl":
                    self._walk(f, off + 4, off + size)
                elif kind == b"strl":
                    self._strl(f, off + 4, off + size, streams)
                    streams += 1
                elif kind == b"movi":
                    if self._stream is None:
                        raise ValueError(f"{self.path}: 'movi' before any video stream header")
                    self._movi(f, off + 4, off + size)

    def _strl(self, f, start: int, end: int, index: int):
        kind = fcc = None
        scale = rate = length = 0
        for cid, off, size in self._chunks(f, start, end):
            f.seek(off)
            body = f.read(min(size, 64))
            if cid == b"strh" and len(body) >= 36:
                kind, fcc = body[:4], body[4:8]
                scale, rate = struct.unpack("<II", body[20:28])
                length = struct.unpack("<I", body[32:36])[0]
            elif cid == b"strf" and kind == b"vids" and len(body) >= 20:
                fcc = body[16:20]  # biCompression decides the codec, as FFmpeg reads it
            elif cid == b"indx":
                raise NotImplementedError(f"{self.path}: OpenDML index (indx) {NOT_PORTED}")
        if kind == b"vids" and self._stream is None:
            self._stream = index
            self.fourcc = fcc.decode("latin-1")
            self.fps = rate / scale if scale else 0.0
            self.frame_count = length

    def _movi(self, f, start: int, end: int):
        ids = {b"%02ddc" % self._stream, b"%02ddb" % self._stream}
        for cid, off, size in self._chunks(f, start, end):
            if cid == b"LIST":
                f.seek(off)
                if f.read(4) == b"rec ":
                    self._movi(f, off + 4, off + size)
            elif cid[:2] == b"ix":
                raise NotImplementedError(f"{self.path}: OpenDML index (ix##) {NOT_PORTED}")
            elif cid in ids and size:
                self.frames.append((off, size))

    def __len__(self) -> int:
        return len(self.frames)

    def packets(self):
        """Each frame's bytes, in order."""
        with open(self.path, "rb") as f:
            for off, size in self.frames:
                f.seek(off)
                data = f.read(size)
                if len(data) != size:
                    raise ValueError(f"{self.path}: frame chunk cut short at byte {off}")
                yield data


class AviWriter:
    """A Motion-JPEG AVI file of uint8 BGR frames of one size (w, h) at `fps` (a rate of
    whole numbers: fps as a fraction of at most 1001 in the denominator), each frame a JPEG
    of quality 95; `close()` writes the index and the sizes. The port's `AviReader` and
    OpenCV's FFmpeg reader both read it."""

    def __init__(self, path, fps: float, size):
        self.path = Path(path)
        self.w, self.h = int(size[0]), int(size[1])
        rate = Fraction(float(fps)).limit_denominator(1001) if fps and fps > 0 else Fraction(30)
        self.rate, self.scale = rate.numerator, rate.denominator
        self.index: list[tuple[int, int]] = []  # (offset from 'movi', size) of each frame
        self.max_size = 0
        self._f = open(self.path, "wb")
        self._f.write(self._headers())
        self._movi = self._f.tell() - 4  # the 'movi' list's type, where idx1 offsets start

    def _headers(self) -> bytes:
        n, biggest = len(self.index), self.max_size
        usec = round(1e6 * self.scale / self.rate)
        avih = struct.pack("<10I4I", usec, 0, 0, 0x10, n, 0, 1, biggest, self.w, self.h,
                           0, 0, 0, 0)  # AVIF_HASINDEX
        strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"MJPG", 0, 0, 0, 0, self.scale,
                           self.rate, 0, n, biggest, 0xFFFFFFFF, 0, 0, 0, self.w, self.h)
        strf = struct.pack("<IiiHH4sIiiII", 40, self.w, self.h, 1, 24, b"MJPG",
                           self.w * self.h * 3, 0, 0, 0, 0)
        strl = b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf)
        hdrl = b"hdrl" + _chunk(b"avih", avih) + _chunk(b"LIST", strl)
        return b"RIFF" + b"\0" * 4 + b"AVI " + _chunk(b"LIST", hdrl) + b"LIST" + b"\0" * 4 + b"movi"

    def write(self, frame: np.ndarray):
        """Append one (h, w, 3) uint8 BGR frame of the writer's size."""
        from sar_yolo_tpu_torch.data.imageio import encode_jpeg
        if frame.shape[:2] != (self.h, self.w):
            raise ValueError(f"frame of {frame.shape[1]}x{frame.shape[0]} for a "
                             f"{self.w}x{self.h} video")
        data = encode_jpeg(frame, 95)
        self.index.append((self._f.tell() - self._movi, len(data)))
        self.max_size = max(self.max_size, len(data))
        self._f.write(_chunk(b"00dc", data))

    def close(self):
        """Write the index and the sizes, and close the file."""
        if self._f is None:
            return
        f = self._f
        movi_end = f.tell()
        f.write(_chunk(b"idx1", b"".join(struct.pack("<4sIII", b"00dc", 0x10, off, size)
                                          for off, size in self.index)))  # AVIIF_KEYFRAME
        end = f.tell()
        f.seek(0)
        f.write(self._headers())
        f.seek(4)
        f.write(struct.pack("<I", end - 8))
        f.seek(self._movi - 4)
        f.write(struct.pack("<I", movi_end - self._movi))
        f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _chunk(cid: bytes, body: bytes) -> bytes:
    """A RIFF chunk: id, size, body, and a pad byte after an odd size."""
    return cid + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")
