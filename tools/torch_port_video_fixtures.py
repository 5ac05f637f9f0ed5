#!/usr/bin/env python3
"""Write the video fixture of the port's video and camera-motion tests and of
`chip_smoke.py` phase 24.

    python3 tools/torch_port_video_fixtures.py [--out tests/data/video] [--seed 0]

Needs OpenCV with its FFmpeg backend (the MJPG writer and the reference reader) and the
JAX package's `trackers/gmc.py` (OpenCV only, no JAX): it runs where the JAX package's
environment is, not on the card. It writes
  * `flight.avi`: a synthetic UAV flight, 24 frames of 720x1280 at 25 fps, Motion-JPEG
    through `cv2.VideoWriter`: the camera pans 4-8 pixels a frame and turns up to 0.3
    degrees a frame over textured terrain (fields, roads, roofs: corners for
    goodFeaturesToTrack), while 6 persons of about 14x30 pixels walk, 3 of them crossing;
  * `digests.json`: the file's `CAP_PROP_FPS` and `CAP_PROP_FRAME_COUNT`, and for each
    frame the SHA-256 of its raw packet (`CAP_PROP_FORMAT = -1`) and of
    `cv2.VideoCapture`'s BGR pixels, the JAX package's `GMC("sparseOptFlow").apply` warp
    (float64) and the persons' boxes (class, x1, y1, x2, y2, person id); with the OpenCV
    and FFmpeg versions that made them.
The output depends only on the seed and on those versions.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import sys
from pathlib import Path

import cv2
import numpy as np

FRAMES, H, W, FPS = 24, 720, 1280, 25
MAP_H, MAP_W = 1100, 1700
# (x0, y0, dx, dy) per frame on the ground, in pixels: persons 0-2 cross near x 800, y 520
PERSONS = [(740, 460, 5, 5), (860, 460, -5, 5), (800, 600, 0, -7),
           (500, 330, 4, 1), (1150, 700, -3, -2), (560, 760, 5, -1)]


def _terrain(rng) -> np.ndarray:
    """Fields of smooth colour with grain, two roads and scattered roofs, BGR."""
    y, x = np.mgrid[0:MAP_H, 0:MAP_W].astype(np.float32)
    field = np.zeros((MAP_H, MAP_W), np.float32)
    for _ in range(6):
        fx, fy, ph = rng.uniform(0.002, 0.01, 2).tolist() + [rng.uniform(0, 6.3)]
        field += np.sin(fx * x + fy * y + ph)
    field = (field - field.min()) / (field.max() - field.min())
    green = np.array([60, 120, 70], np.float32)
    brown = np.array([70, 110, 140], np.float32)
    img = green * (1 - field[..., None]) + brown * field[..., None]
    grain = cv2.GaussianBlur(rng.normal(0, 12, (MAP_H, MAP_W)).astype(np.float32), (0, 0), 2.0)
    img = np.clip(img + grain[..., None], 0, 255).astype(np.uint8)
    cv2.line(img, (0, 300), (MAP_W, 520), (150, 150, 150), 16)
    cv2.line(img, (980, 0), (760, MAP_H), (140, 140, 145), 12)
    for _ in range(60):
        cx, cy = int(rng.integers(40, MAP_W - 40)), int(rng.integers(40, MAP_H - 40))
        w, h = int(rng.integers(14, 40)), int(rng.integers(14, 40))
        colour = [int(c) for c in rng.integers(30, 230, 3)]
        cv2.rectangle(img, (cx - w // 2, cy - h // 2), (cx + w // 2, cy + h // 2), colour, -1)
    return img


def _camera(t: int, rng_path) -> np.ndarray:
    """The 2x3 map -> frame affine of frame t."""
    shift, angle = rng_path[:t].sum(0)[:2], rng_path[:t, 2].sum()
    M = cv2.getRotationMatrix2D((MAP_W / 2, MAP_H / 2), angle, 1.0)
    M[:, 2] += (W - MAP_W) / 2 - shift
    return M


def _frame(ground: np.ndarray, t: int, path) -> tuple[np.ndarray, list]:
    world = ground.copy()
    for pid, (x0, y0, dx, dy) in enumerate(PERSONS):
        cx, cy = x0 + dx * t, y0 + dy * t
        cv2.ellipse(world, (cx, cy + 4), (7, 11), 0, 0, 360, (40, 40, 200 - 20 * pid), -1)
        cv2.circle(world, (cx, cy - 11), 4, (120, 160, 210), -1)
    M = _camera(t, path)
    img = cv2.warpAffine(world, M, (W, H), flags=cv2.INTER_LINEAR)
    rows = []
    for pid, (x0, y0, dx, dy) in enumerate(PERSONS):
        cx, cy = M @ np.array([x0 + dx * t, y0 + dy * t, 1.0])
        rows.append([0, round(cx - 7, 2), round(cy - 15, 2), round(cx + 7, 2), round(cy + 15, 2),
                     pid])
    return cv2.GaussianBlur(img, (3, 3), 0), rows


def _read(path: Path, raw: bool) -> list[bytes]:
    cap = cv2.VideoCapture(str(path))
    if raw:
        cap.set(cv2.CAP_PROP_FORMAT, -1)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f.tobytes())
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="tests/data/video")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from sar_yolo_tpu.trackers.gmc import GMC

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    ground = _terrain(rng)
    # per frame: pan (x, y) of 4-8 pixels in all, rotation up to 0.3 degrees
    mag = rng.uniform(4, 8, FRAMES)
    ang = rng.uniform(0.35, 0.6, FRAMES)
    path = np.stack([mag * np.cos(ang), mag * np.sin(ang), rng.uniform(-0.3, 0.3, FRAMES)], 1)
    video = out / "flight.avi"
    writer = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"MJPG"), FPS, (W, H))
    if not writer.isOpened() or writer.getBackendName() != "FFMPEG":
        raise SystemExit("OpenCV's FFmpeg MJPG writer is not available")
    persons = []
    for t in range(FRAMES):
        img, rows = _frame(ground, t, path)
        writer.write(img)
        persons.append(rows)
    writer.release()

    cap = cv2.VideoCapture(str(video))
    fps, count = cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)
    cap.release()
    packets, pixels = _read(video, True), _read(video, False)
    gmc = GMC("sparseOptFlow")
    frames = []
    for t, (pkt, px) in enumerate(zip(packets, pixels)):
        warp = gmc.apply(np.frombuffer(px, np.uint8).reshape(H, W, 3))
        frames.append({"packet_sha256": hashlib.sha256(pkt).hexdigest(),
                       "bgr_sha256": hashlib.sha256(px).hexdigest(),
                       "gmc": np.asarray(warp, np.float64).tolist(), "persons": persons[t]})
    build = cv2.getBuildInformation()
    ffmpeg = {k: re.search(rf"{k}:\s+YES \(([^)]*)\)", build).group(1)
              for k in ("avcodec", "avformat", "swscale")}
    digests = {"opencv": cv2.__version__, "ffmpeg": ffmpeg, "seed": args.seed,
               "shape": [H, W, 3], "fps": fps, "frame_count": count, "frames": frames}
    (out / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")
    print(f"{video}: {video.stat().st_size} bytes, {len(packets)} frames, fps {fps}")


if __name__ == "__main__":
    main()
