#!/usr/bin/env python3
"""Write the JPEG fixtures of the port's decoder tests and of `chip_smoke.py` phase 10.

    python3 tools/torch_port_jpeg_fixtures.py [--out tests/data/jpeg]

Needs OpenCV (the JPEG writer and the reference reader): it runs where the JAX package's
environment is, not on the card. It writes
  * one small file for each decoder variant (`variants/`): the five sampling factors,
    odd sizes, qualities 10 and 100 (optimized Huffman tables), restart intervals, gray,
    an Exif orientation, Adobe RGB, SOF1, a file cut short, and a progressive file,
    which the port refuses;
  * 12 frames of 720x1280 (`frames/`): a smooth synthetic UAV view of terrain with 6
    small persons walking across it, 3 of them crossing paths;
  * `digests.json`: for each file the SHA-256 and shape of `cv2.imread`'s pixels (or the
    refusal), and for each frame its person boxes (class, x1, y1, x2, y2, person id).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import struct
from pathlib import Path

import cv2
import numpy as np

FRAMES, H, W = 12, 720, 1280
# (x0, y0, dx, dy) per frame, in pixels: persons 0-2 cross near the frame centre
PERSONS = [(560, 300, 12, 6), (720, 300, -12, 6), (640, 420, 0, -10),
           (200, 150, 8, 2), (1000, 560, -6, -4), (300, 600, 10, -3)]


def _terrain(rng) -> np.ndarray:
    """Smooth fields and a river, in BGR."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    field = np.zeros((H, W), np.float32)
    for _ in range(6):
        fx, fy, ph = rng.uniform(0.002, 0.012), rng.uniform(0.002, 0.012), rng.uniform(0, 6.3)
        field += np.sin(fx * x + fy * y + ph)
    field = (field - field.min()) / (field.max() - field.min())
    green = np.array([60, 120, 70], np.float32)
    brown = np.array([70, 110, 140], np.float32)
    img = green * (1 - field[..., None]) + brown * field[..., None]
    river = np.abs(y - (360 + 120 * np.sin(x / 210.0))) < 28
    img[river] = (150, 110, 60)
    noise = cv2.GaussianBlur(rng.normal(0, 12, (H, W)).astype(np.float32), (0, 0), 3)
    return np.clip(img + noise[..., None], 0, 255).astype(np.uint8)


def _frame(base: np.ndarray, t: int):
    img = base.copy()
    rows = []
    for pid, (x0, y0, dx, dy) in enumerate(PERSONS):
        cx, cy = x0 + dx * t, y0 + dy * t
        w, h = 14, 30
        x1, y1, x2, y2 = cx - w // 2, cy - h // 2, cx + w // 2, cy + h // 2
        cv2.ellipse(img, (cx, cy + 4), (w // 2, h // 2 - 4), 0, 0, 360, (40, 40, 200 - 20 * pid), -1)
        cv2.circle(img, (cx, y1 + 4), 4, (120, 160, 210), -1)
        rows.append([0, x1, y1, x2, y2, pid])
    return cv2.GaussianBlur(img, (3, 3), 0), rows


def _exif(orientation: int) -> bytes:
    tiff = (b"MM" + struct.pack(">HI", 42, 8) + struct.pack(">H", 1)
            + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(">I", 0))
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def _variants(rng) -> dict:
    def smooth(h, w, gray=False):
        small = rng.integers(0, 256, (max(h // 6, 1), max(w // 6, 1), 3), dtype=np.uint8)
        img = cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)
        img = np.clip(img.astype(int) + rng.integers(-12, 13, img.shape), 0, 255).astype(np.uint8)
        return img[..., 1] if gray else img

    def enc(img, **kw):
        params = []
        for key, val in kw.items():
            params += [getattr(cv2, f"IMWRITE_JPEG_{key.upper()}"), val]
        return cv2.imencode(".jpg", img, params)[1].tobytes()

    img = smooth(37, 53)
    out = {f"sampling_{s}.jpg": enc(img, sampling_factor=getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{s}"))
           for s in ("444", "422", "420", "411", "440")}
    out["size_1x1.jpg"] = enc(smooth(1, 1))
    out["size_7x13_420.jpg"] = enc(smooth(7, 13))
    out["quality_10.jpg"] = enc(img, quality=10, optimize=1)
    out["quality_100.jpg"] = enc(img, quality=100, optimize=1)
    out["restart_2.jpg"] = enc(smooth(64, 96), rst_interval=2)
    out["gray.jpg"] = enc(smooth(37, 53, gray=True))
    base = enc(img)
    out["exif_orientation_6.jpg"] = base[:2] + _exif(6) + base[2:]
    n = struct.unpack(">H", base[4:6])[0]  # drop the JFIF APP0, mark the components RGB
    adobe = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0])
    out["adobe_rgb.jpg"] = base[:2] + adobe + base[4 + n:]
    sof1 = bytearray(base)
    sof1[sof1.index(b"\xff\xc0") + 1] = 0xC1
    out["sof1.jpg"] = bytes(sof1)
    long = enc(smooth(96, 128))
    out["cut_short.jpg"] = long[:len(long) * 3 // 5]
    out["progressive.jpg"] = enc(img, progressive=1)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="tests/data/jpeg")
    out = Path(ap.parse_args().out)
    rng = np.random.default_rng(0)
    digests = {"variants": {}, "frames": {}}
    (out / "variants").mkdir(parents=True, exist_ok=True)
    for name, data in _variants(rng).items():
        path = out / "variants" / name
        path.write_bytes(data)
        entry = {"raises": "NotImplementedError"} if name == "progressive.jpg" else {}
        if not entry:
            px = cv2.imread(str(path))
            entry = {"sha256": hashlib.sha256(px.tobytes()).hexdigest(), "shape": list(px.shape)}
        digests["variants"][name] = entry
    (out / "frames").mkdir(parents=True, exist_ok=True)
    base = _terrain(rng)
    for t in range(FRAMES):
        img, rows = _frame(base, t)
        path = out / "frames" / f"frame_{t:02d}.jpg"
        cv2.imwrite(str(path), img, [cv2.IMWRITE_JPEG_QUALITY, 80])
        px = cv2.imread(str(path))
        digests["frames"][path.name] = {"sha256": hashlib.sha256(px.tobytes()).hexdigest(),
                                        "shape": list(px.shape), "persons": rows}
    (out / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")
    total = sum(p.stat().st_size for p in out.rglob("*") if p.is_file())
    print(f"{out}: {total} bytes")


if __name__ == "__main__":
    main()
