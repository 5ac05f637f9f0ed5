#!/usr/bin/env python3
"""Write the port's Hershey simplex font (`sar_yolo_tpu_torch/data/hershey.py`) and the
label fixture of its `put_text` test from an installed OpenCV 4.x, whose `cv2.putText`
draws the Hershey strokes of `FONT_HERSHEY_SIMPLEX` (OpenCV 5 draws TrueType instead).

    python3 tools/torch_port_hershey.py [--font-out sar_yolo_tpu_torch/data/hershey.py]
        [--fixture-out tests/data/hershey]

The glyph strings come out of OpenCV's own shared library: every NUL-delimited run of
printable bytes that parses as a glyph (two bearing characters, then strokes of
coordinate pairs split by single spaces, each coordinate `ord(c) - ord('R')`) is a
candidate. `cv2.getTextSize` at scale 1 and thickness 0 gives the font's base and cap
lines and each character's advance. For each printable ASCII character, the candidates of
that advance are drawn with `cv2.polylines(..., shift=16)` at the fixed-point points that
putText computes, and the one whose drawing equals `cv2.putText`'s at two scales and
thicknesses is the character's glyph. Nothing is invented: a character without a match
stops the tool.

The fixture `labels_cv2_<major>_<minor>.npz` holds `cv2.putText` renderings of detection
labels, the digits, letters and punctuation at scales 0.5 and 0.8, thicknesses 1 to 3 and
origins near and over the canvas' edges, and at the validation mosaics' scale 0.35,
thickness 1, in the mosaics' colours.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

import cv2
import numpy as np

XY_SHIFT = 16
FONT = cv2.FONT_HERSHEY_SIMPLEX
REPO = Path(__file__).resolve().parents[1]
LABELS = ["person 0.87", "id:12 person 0.55 s3", "id:7 c0 0.91 s0", "0123456789",
          "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~", "ABCDEFGHIJKLMNOPQRSTUVWXYZ",
          "abcdefghijklmnopqrstuvwxyz", "c3 1.00 s2"]
CANVAS = (48, 400, 3)
ORIGINS = [(2, 20), (-5, 11), (330, 6), (40, 47)]
COLORS = [(56, 56, 255), (31, 112, 255), (29, 178, 255), (255, 255, 255)]
MOSAIC_SCALE = 0.35       # the validation mosaics' labels: thickness 1, the plots' PALETTE
SCALES = (MOSAIC_SCALE, 0.5, 0.8)
PALETTE = [(56, 56, 255), (31, 112, 255), (29, 178, 255), (49, 210, 207), (10, 249, 72),
           (23, 204, 146), (134, 219, 61), (52, 147, 26), (187, 212, 0), (168, 153, 44)]


def library_files() -> list[Path]:
    """The shared libraries that may hold imgproc's glyph table: cv2's extension module
    and any mapped OpenCV imgproc or world library."""
    files = {p.resolve() for p in Path(cv2.__file__).resolve().parent.rglob("cv2*.so*")}
    try:
        for line in Path("/proc/self/maps").read_text().splitlines():
            parts = line.split()
            name = Path(parts[5]).name if len(parts) >= 6 else ""
            if "opencv_imgproc" in name or "opencv_world" in name:
                files.add(Path(parts[5]).resolve())
    except OSError:
        pass
    return sorted(p for p in files if p.is_file())


def parse(glyph: str):
    """(left, right, strokes) of a glyph string, or None where it is no glyph."""
    if len(glyph) < 2:
        return None
    strokes = []
    body = glyph[2:]
    if body:
        for token in body.split(" "):
            if not token or len(token) % 2:
                return None
            strokes.append([(ord(token[k]) - 82, ord(token[k + 1]) - 82)
                            for k in range(0, len(token), 2)])
    coords = [v for s in strokes for p in s for v in p] + [ord(glyph[0]) - 82, ord(glyph[1]) - 82]
    if any(abs(v) > 40 for v in coords):
        return None
    return ord(glyph[0]) - 82, ord(glyph[1]) - 82, strokes


def candidates(files) -> dict:
    """Candidate glyph strings by advance (right - left)."""
    by_width: dict = {}
    for path in files:
        data = path.read_bytes()
        for m in re.finditer(rb"[\x20-\x7e]{2,}", data):
            s = m.group().decode("ascii")
            g = parse(s)
            if g is not None:
                by_width.setdefault(g[1] - g[0], set()).add(s)
    return by_width


def draw_glyphs(img, glyphs, org, scale, thickness, color, base_line):
    """putText's geometry with cv2.polylines at shift 16: the candidate's own drawing."""
    hscale = int(np.rint(scale * (1 << XY_SHIFT)))
    view_x = org[0] << XY_SHIFT
    view_y = (org[1] << XY_SHIFT) - base_line * hscale
    for glyph in glyphs:
        left, right, strokes = parse(glyph)
        view_x -= left * hscale
        for stroke in strokes:
            if len(stroke) > 1:
                pts = np.array([[x * hscale + view_x, y * hscale + view_y] for x, y in stroke],
                               np.int64)
                if np.abs(pts).max() >= 2 ** 31:
                    return None
                cv2.polylines(img, [pts.astype(np.int32)], False, color, thickness,
                              cv2.LINE_8, XY_SHIFT)
        view_x += right * hscale
    return img


def recover(by_width, base_line) -> dict:
    font = {}
    for code in range(32, 127):
        c = chr(code)
        (w, _), _ = cv2.getTextSize(c, FONT, 1.0, 0)
        found = None
        for scale, thick in ((3.0, 1), (1.7, 3)):
            shape = (int(60 * scale) + 20, int((w + 20) * scale) + 40)
            org = (20, int(40 * scale))
            want = cv2.putText(np.zeros(shape, np.uint8), c, org, FONT, scale, 255, thick)
            pool = sorted(by_width.get(w, ())) if found is None else found
            found = [g for g in pool
                     if (got := draw_glyphs(np.zeros(shape, np.uint8), [g], org, scale, thick,
                                            255, base_line)) is not None
                     and np.array_equal(got, want)]
            if not found:
                sys.exit(f"no glyph of advance {w} draws {c!r} as cv2.putText does "
                         f"(scale {scale}, thickness {thick})")
        font[c] = min(found, key=lambda g: (len(g), g))  # equal drawings: any of them
    return font


def write_font(path: Path, font: dict, base_line: int, cap_line: int):
    rows = "\n".join(f"    {c!r}: {g!r}," for c, g in font.items())
    path.write_text(f'''"""The Hershey simplex font of OpenCV 4.x's putText (FONT_HERSHEY_SIMPLEX), printable
ASCII only. Written by `tools/torch_port_hershey.py` from OpenCV {cv2.__version__}'s library;
do not edit.

Each glyph: two bearing characters (left, right), then strokes of coordinate pairs split by
single spaces; every coordinate is `ord(c) - ord("R")` font units, y down. putText's
origin is the baseline's left end: BASE_LINE units above the glyphs' bottom line.
"""

BASE_LINE = {base_line}
CAP_LINE = {cap_line}
GLYPHS = {{
{rows}
}}
''')


def write_fixture(out: Path, tag: str):
    out.mkdir(parents=True, exist_ok=True)
    images, texts, scales, thicks, origins, colors = [], [], [], [], [], []
    for i, text in enumerate(LABELS):
        for scale in SCALES:
            for thick in (1,) if scale == MOSAIC_SCALE else (1, 2, 3):
                for j, org in enumerate(ORIGINS):
                    if (i + j + thick) % 2 and text not in LABELS[:2]:
                        continue  # every case of the two labels, half of the others
                    color = PALETTE[(i + j) % len(PALETTE)] if scale == MOSAIC_SCALE else \
                        COLORS[(i + j + thick) % len(COLORS)]
                    img = np.zeros(CANVAS, np.uint8)
                    img[::7] = 17  # a background the strokes overwrite
                    images.append(cv2.putText(img, text, org, FONT, scale, color, thick))
                    texts.append(text)
                    scales.append(scale)
                    thicks.append(thick)
                    origins.append(org)
                    colors.append(color)
    path = out / f"labels_cv2_{tag}.npz"
    np.savez_compressed(path, images=np.stack(images), texts=np.array(texts),
                        scales=np.array(scales), thicknesses=np.array(thicks),
                        origins=np.array(origins), colors=np.array(colors),
                        version=np.array(cv2.__version__))
    print(f"wrote {len(images)} renderings to {path}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--font-out", type=Path, default=REPO / "sar_yolo_tpu_torch/data/hershey.py")
    ap.add_argument("--fixture-out", type=Path, default=REPO / "tests/data/hershey")
    args = ap.parse_args()
    major, minor = (int(v) for v in cv2.__version__.split(".")[:2])
    if major != 4:
        sys.exit(f"OpenCV {cv2.__version__} does not draw Hershey strokes in putText; "
                 "run this where OpenCV 4.x is installed")
    tag = f"{major}_{minor}"
    (_, height), base_line = cv2.getTextSize("A", FONT, 1.0, 0)
    cap_line = height - base_line
    files = library_files()
    print("OpenCV", cv2.__version__, "libraries:", [str(f) for f in files])
    by_width = candidates(files)
    print("candidate glyphs:", sum(len(v) for v in by_width.values()), "base", base_line,
          "cap", cap_line)
    font = recover(by_width, base_line)
    args.font_out.parent.mkdir(parents=True, exist_ok=True)
    write_font(args.font_out, font, base_line, cap_line)
    print(f"wrote {len(font)} glyphs to {args.font_out}")
    write_fixture(args.fixture_out, tag)


if __name__ == "__main__":
    main()
