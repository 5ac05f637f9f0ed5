"""numpy versions of the OpenCV calls of the host augmentation, equal to OpenCV's 8-bit
results bit for bit (the training machine has no OpenCV).

OpenCV computes these in fixed point, and a float version differs from it by a grey
level here and there; each function below repeats OpenCV's integer arithmetic:

* `resize` INTER_LINEAR on uint8: 11-bit weights rounded from float32 offsets, an
  exact horizontal pass, and the vertical pass of OpenCV's SIMD loop
  (((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) + 2) >> 2, whose last
  (width % 8 or 8) bytes of each row take the scalar rounding (S0 b0 + S1 b1 + 2^21)
  >> 22 instead; an exact 2x reduction is INTER_AREA's 2x2 mean, as in OpenCV.
* `warp_affine` INTER_LINEAR, constant border: the inverted matrix in 1/1024
  pixel steps per row and column, source coordinates quantized to 1/32 pixel, and
  15-bit bilinear weights.
* `bgr2hsv` / `hsv2bgr` on uint8: OpenCV's division tables one way, its float32
  sector formula (fused multiply-adds) the other.
* `copy_make_border`, constant border. (cv2.LUT is numpy indexing, at its caller.)
* `fill_poly` (cv2.fillPoly: 8-connected edges, then the fixed-point scan fill) and
  `resize_nearest_cv` (cv2.resize INTER_NEAREST), for the segment task's masks.

And the drawing of `Results.plot` (drawing.cpp, LINE_8): `line`, `rectangle`, `polylines`
and `circle` (thickness 1 lines between whole pixels are `cv::Line`; thicker ones a convex
quadrilateral in 1/65536 pixel with round joints, a segment in whole pixels first clipped
to the image grown by the thickness), `add_weighted` (float32 fused multiply-adds),
`put_text` (FONT_HERSHEY_SIMPLEX as OpenCV 4.x draws it: the Hershey strokes of
`data/hershey.py`; OpenCV 5 draws TrueType instead), and the mask contours
`find_contours_external` / `contour_area` (`csrc/contours.c`). Every one equals this
OpenCV 5.0's results bit for bit, put_text OpenCV 4.13's renderings.
"""

from __future__ import annotations

import ctypes

import numpy as np

from sar_yolo_tpu_torch.data.hershey import BASE_LINE, GLYPHS
from sar_yolo_tpu_torch.utils.hostc import CSRC, library

_RESIZE_BITS = 11          # INTER_RESIZE_COEF_BITS
_RESIZE_SCALE = 1 << _RESIZE_BITS
_WARP_LANES = 16           # warpAffine's SIMD columns per step (AVX2); the rest take its scalar loop
_CONTOURS_SOURCE = CSRC / "contours.c"


def _linear_taps(n_dst: int, n_src: int, clamp_weight: bool):
    """Source indices (i0, i1) and 11-bit weights (w0, w1) per destination index."""
    f = ((np.arange(n_dst, dtype=np.float64) + 0.5) * (1.0 / (n_dst / n_src)) - 0.5)
    f = f.astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp_weight:  # the horizontal taps: weight 0 past either edge
        f[s < 0] = 0
        s[s < 0] = 0
        last = s >= n_src - 1
        f[last] = 0
        s[last] = n_src - 1
    w0 = np.rint((np.float32(1) - f) * np.float32(_RESIZE_SCALE)).astype(np.int32)
    w1 = np.rint(f * np.float32(_RESIZE_SCALE)).astype(np.int32)
    return np.clip(s, 0, n_src - 1), np.clip(s + 1, 0, n_src - 1), w0, w1


def resize(img: np.ndarray, dsize) -> np.ndarray:
    """cv2.resize(img, dsize=(w, h), interpolation=cv2.INTER_LINEAR) of a uint8 image."""
    w, h = int(dsize[0]), int(dsize[1])
    h0, w0 = img.shape[:2]
    if (h, w) == (h0, w0):
        return img.copy()
    if w0 == 2 * w and h0 == 2 * h:  # OpenCV takes INTER_AREA's fast path here
        s = img.reshape(h, 2, w, 2, -1).astype(np.uint16)
        out = (s[:, 0, :, 0] + s[:, 0, :, 1] + s[:, 1, :, 0] + s[:, 1, :, 1] + 2) >> 2
        return out.astype(np.uint8).reshape((h, w) + img.shape[2:])
    x0, x1, a0, a1 = _linear_taps(w, w0, True)
    y0, y1, b0, b1 = _linear_taps(h, h0, False)
    src = img.reshape(h0, w0, -1).astype(np.int32)
    cn = src.shape[2]
    rows = np.unique(np.concatenate([y0, y1]))
    hz = np.zeros((h0, w, cn), np.int32)
    hz[rows] = src[rows][:, x0] * a0[:, None] + src[rows][:, x1] * a1[:, None]
    hz = hz.reshape(h0, w * cn)
    s0, s1 = hz[y0], hz[y1]
    b0, b1 = b0[:, None], b1[:, None]
    out = ((((s0 >> 4) * b0) >> 16) + (((s1 >> 4) * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape((h, w) + img.shape[2:])


def copy_make_border(img: np.ndarray, top: int, bottom: int, left: int, right: int,
                     value=(114, 114, 114)) -> np.ndarray:
    """cv2.copyMakeBorder(img, top, bottom, left, right, cv2.BORDER_CONSTANT, value=value)
    of an (h, w, 3) image."""
    h, w = img.shape[:2]
    out = np.full((h + top + bottom, w + left + right, img.shape[2]), value, img.dtype)
    out[top:top + h, left:left + w] = img
    return out


def _fma(a, b, c):
    """float32 a * b + c rounded once. In float64 the product of two float32 values is
    exact, and at the magnitudes here (pixel coordinates, 8-bit values) so is the sum."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def warp_affine(img: np.ndarray, M: np.ndarray, dsize, border_value: int = 114) -> np.ndarray:
    """cv2.warpAffine(img, M, dsize=(w, h), borderValue=(v, v, v)) of a uint8 (h, w, 3)
    image: INTER_LINEAR, BORDER_CONSTANT."""
    f32 = np.float32
    w, h = int(dsize[0]), int(dsize[1])
    m = np.asarray(M, np.float64).reshape(2, 3)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = m[0, 1] * -d, m[1, 0] * -d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    inv = [f32(v) for v in (a11, a12, b1, a21, a22, b2)]
    xs = np.arange(w, dtype=f32)[None, :]
    ys = np.arange(h, dtype=f32)[:, None]
    k = w // _WARP_LANES * _WARP_LANES
    sx, sy = np.empty((h, w), f32), np.empty((h, w), f32)
    sx[:, :k] = _fma(inv[0], xs[:, :k], ys * inv[1] + inv[2])
    sy[:, :k] = _fma(inv[3], xs[:, :k], ys * inv[4] + inv[5])
    sx[:, k:] = _fma(xs[:, k:], inv[0], ys * inv[1]) + inv[2]
    sy[:, k:] = _fma(xs[:, k:], inv[3], ys * inv[4]) + inv[5]
    ix, iy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - ix)[..., None], (sy - iy)[..., None]
    h0, w0, cn = img.shape
    # two border pixels each side: a tap past them reads the border value too
    pw = w0 + 4
    X = np.clip(ix.astype(np.int64) + 2, 0, w0 + 2)
    Y = np.clip(iy.astype(np.int64) + 2, 0, h0 + 2)
    src = np.full((h0 + 4, pw, cn), border_value, f32)
    src[2:-2, 2:-2] = img
    src = src.reshape(-1, cn)
    i00 = Y * pw + X
    p00, p01, p10, p11 = src[i00], src[i00 + 1], src[i00 + pw], src[i00 + pw + 1]
    v0 = _fma(ax, p01 - p00, p00)
    v1 = _fma(ax, p11 - p10, p10)
    return np.clip(np.rint(_fma(ay, v1 - v0, v0)), 0, 255).astype(np.uint8)


_HSV_SHIFT = 12
_SDIV = np.array([0] + [int(np.rint((255 << _HSV_SHIFT) / i)) for i in range(1, 256)], np.int32)
_HDIV = np.array([0] + [int(np.rint((180 << _HSV_SHIFT) / (6.0 * i))) for i in range(1, 256)],
                 np.int32)


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_BGR2HSV) of a uint8 image (H in [0, 180))."""
    b, g, r = (img[..., i].astype(np.int32) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
_HSV_LANES = 32  # hsv2bgr's SIMD pixels per step (AVX2); they truncate, the rest of a row rounds


def hsv2bgr(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_HSV2BGR) of a uint8 (h, w, 3) image (H in [0, 180))."""
    f32 = np.float32
    h = img[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = img[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = img[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(f32)
    tab = np.stack([v, v * (f32(1) - s), v * _fma(-s, h, f32(1)), v * _fma(-s, f32(1) - h, f32(1))])
    bgr = np.take_along_axis(tab, np.moveaxis(_SECTORS[sector], -1, 0), 0)
    bgr = np.where(s == 0, v, bgr) * f32(255)
    k = img.shape[1] // _HSV_LANES * _HSV_LANES
    bgr[:, :, :k] = np.trunc(bgr[:, :, :k])
    bgr[:, :, k:] = np.rint(bgr[:, :, k:])
    return np.clip(bgr, 0, 255).astype(np.uint8).transpose(1, 2, 0)


_XY_SHIFT = 16              # drawing.cpp's fixed point of the polygon edges
_XY_ONE = 1 << _XY_SHIFT


def _clip_line(w: int, h: int, p1, p2):
    """cv::clipLine on an image of w x h in int64 arithmetic (w and h in 1/65536 pixels for
    the fixed-point lines): (inside, p1, p2), the points as OpenCV leaves them (moved part
    of the way where the segment misses the image)."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:  # the products in double, as OpenCV's
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _lines8(img: np.ndarray, p1s, p2s, value):
    """cv::Line(img, p1, p2, color, 8) of each pair of points: the 8-connected Bresenham line
    of LineIterator (clipped to the image, drawn left to right), all pairs in one pass. The
    k-th step along the major axis moves (2 minor k + major - 1) // (2 major) along the
    minor one: the count of LineIterator's error-term carries, in closed form."""
    h, w = img.shape[:2]
    a = np.array(p1s, np.int64).reshape(-1, 2)
    b = np.array(p2s, np.int64).reshape(-1, 2)
    out = np.flatnonzero(~((a >= 0) & (a < (w, h)) & (b >= 0) & (b < (w, h))).all(1))
    if len(out):
        keep = np.ones(len(a), bool)
        for i in out:
            keep[i], a[i], b[i] = _clip_line(w, h, tuple(a[i].tolist()), tuple(b[i].tolist()))
        a, b = a[keep], b[keep]
    swap = (b[:, 0] < a[:, 0])[:, None]
    a, b = np.where(swap, b, a), np.where(swap, a, b)
    dx, dy = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
    vert = np.abs(dy) > dx
    major, minor = np.maximum(dx, np.abs(dy)), np.minimum(dx, np.abs(dy))
    n = major + 1
    seg = np.repeat(np.arange(len(n)), n)
    k = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    mj = major[seg]
    m = np.where(mj > 0, (2 * minor[seg] * k + mj - 1) // np.maximum(2 * mj, 1), 0)
    sy = np.where(dy < 0, -1, 1)[seg]
    v = vert[seg]
    img[a[seg, 1] + sy * np.where(v, k, m), a[seg, 0] + np.where(v, m, k)] = value


def fill_poly(img: np.ndarray, poly, value) -> np.ndarray:
    """cv2.fillPoly(img, [poly], value) in place with the defaults (8-connected edges, shift 0):
    `poly` is (n, 2) int32 vertices. OpenCV draws each edge with `cv::Line`, then fills the
    rows between the edges with its fixed-point scan (`FillEdgeCollection`: edges half open at
    their lower end, an edge that leaves the image starting from its clipped ends, spans from
    ceil(x_left) to floor(x_right), the active edges re-sorted by x on every row). Returns
    img."""
    pts = [(int(x), int(y)) for x, y in np.asarray(poly).reshape(-1, 2)]
    h, w = img.shape[:2]
    edges, ends = [], []  # edges: [y0, y1, x, dx] in 16.16 fixed point, as PolyEdge
    x0, y0 = pts[-1][0] << _XY_SHIFT, pts[-1][1]
    for px, py in pts:
        x1, y1 = px << _XY_SHIFT, py
        t0 = ((x0 + (_XY_ONE >> 1)) >> _XY_SHIFT, y0)
        t1 = ((x1 + (_XY_ONE >> 1)) >> _XY_SHIFT, y1)
        ends.append((t0, t1))
        c0, c1 = [x0, y0], [x1, y1]
        if not (0 <= t0[0] < w and 0 <= t1[0] < w and 0 <= t0[1] < h and 0 <= t1[1] < h):
            _, t0, t1 = _clip_line(w, h, t0, t1)
            if t0[1] != t1[1]:
                c0[1], c1[1] = t0[1], t1[1]
            c0[0], c1[0] = t0[0] << _XY_SHIFT, t1[0] << _XY_SHIFT
        if y0 != y1:
            dx = int((c1[0] - c0[0]) / (c1[1] - c0[1]))  # C++ division: toward zero
            if y0 < y1:
                edges.append([y0, y1, c0[0] + (y0 - c0[1]) * dx, dx])
            else:
                edges.append([y1, y0, c1[0] + (y1 - c1[1]) * dx, dx])
        x0, y0 = x1, y1
    if ends:
        _lines8(img, [e[0] for e in ends], [e[1] for e in ends], value)
    _fill_edges(img, edges, value)
    return img


def _fill_edges(img: np.ndarray, edges: list, value):
    """drawing.cpp's FillEdgeCollection for 8-connected (not anti-aliased) polygons."""
    h, w = img.shape[:2]
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << _XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e[0], e[2], e[3]))
    n, i, active = len(edges), 0, []
    for y in range(edges[0][0], min(y_max, h)):
        # one pass over the active list, as OpenCV's: edges ending at y leave it, edges
        # starting at y join before the first remaining edge whose x is not smaller
        merged, li = [], 0
        while li < len(active) or (i < n and edges[i][0] == y):
            last = active[li] if li < len(active) else None
            if last is not None and last[1] == y:
                li += 1
                continue
            if last is not None and (i >= n or edges[i][0] > y or last[2] < edges[i][2]):
                merged.append(last)
                li += 1
            elif i < n:
                merged.append(edges[i])
                i += 1
            else:
                break
        active = merged
        for k in range(0, len(active) - 1, 2):  # spans between pairs, then their x steps
            a, b = active[k], active[k + 1]
            if y >= 0:
                left, right = (b, a) if a[2] > b[2] else (a, b)
                x1, x2 = (left[2] + _XY_ONE - 1) >> _XY_SHIFT, right[2] >> _XY_SHIFT
                if x1 < w and x2 >= 0:
                    img[y, max(x1, 0):min(x2, w - 1) + 1] = value
            a[2] += a[3]
            b[2] += b[3]
        active.sort(key=lambda e: e[2])  # OpenCV's bubble sort by x: stable


def resize_nearest_cv(img: np.ndarray, dsize) -> np.ndarray:
    """cv2.resize(img, dsize=(w, h), interpolation=cv2.INTER_NEAREST): destination index i
    reads source floor(i * n_src / n_dst), in double, clamped to the last index (not
    `jax.image.resize`'s half-pixel rule)."""
    w, h = int(dsize[0]), int(dsize[1])
    h0, w0 = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / w0))).astype(np.int64), w0 - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / h0))).astype(np.int64), h0 - 1)
    return img[ys[:, None], xs[None, :]]


# ---- drawing: copies of drawing.cpp (LINE_8), for Results.plot --------------------------------

_MAX_THICKNESS = 32767


def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _put_points(img: np.ndarray, xs: np.ndarray, ys: np.ndarray, value):
    h, w = img.shape[:2]
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = value


def _line2(img: np.ndarray, p1, p2, value):
    """drawing.cpp's Line2, the outline of a fixed-point polygon: an 8-connected line
    between two points in 1/65536 pixels, clipped in that fixed point, stepped along its
    major axis from its first point plus half a pixel over (p2 - p1) >> 16 steps, after
    its end point is set."""
    h, w = img.shape[:2]
    inside, (x1, y1), (x2, y2) = _clip_line(w << _XY_SHIFT, h << _XY_SHIFT, p1, p2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    half = _XY_ONE >> 1
    if ax > ay:
        if dx < 0:
            dy, (x1, y1), (x2, y2) = -dy, (x2, y2), (x1, y1)
        y_step = _cdiv(dy << _XY_SHIFT, ax | 1)
        count = (x2 - x1) >> _XY_SHIFT
    else:
        if dy < 0:
            dx, (x1, y1), (x2, y2) = -dx, (x2, y2), (x1, y1)
        x_step = _cdiv(dx << _XY_SHIFT, ay | 1)
        count = (y2 - y1) >> _XY_SHIFT
    x1 += half
    y1 += half
    _put_points(img, np.array([(x2 + half) >> _XY_SHIFT]), np.array([(y2 + half) >> _XY_SHIFT]),
                value)
    k = np.arange(count + 1, dtype=np.int64)
    if ax > ay:
        xs, ys = (x1 >> _XY_SHIFT) + k, (y1 + k * y_step) >> _XY_SHIFT
    else:
        xs, ys = (x1 + k * x_step) >> _XY_SHIFT, (y1 >> _XY_SHIFT) + k
    _put_points(img, xs, ys, value)


def _spans(img: np.ndarray, y0: int, x_left: np.ndarray, x_right: np.ndarray, value):
    """Rows y0, y0 + 1, ... from x_left to x_right (inclusive, already clipped to the image's
    columns; a row with x_left > x_right is left as it is)."""
    if not len(x_left):
        return
    c0, c1 = int(x_left.min()), int(x_right.max())
    if c1 < c0:
        return
    cols = np.arange(c0, c1 + 1)
    mask = (cols >= x_left[:, None]) & (cols <= x_right[:, None])
    img[y0:y0 + len(x_left), c0:c1 + 1][mask] = value


def _fill_convex_poly(img: np.ndarray, v: list, value, shift: int):
    """drawing.cpp's FillConvexPoly for LINE_8: the outline (Line, or Line2 at a fraction
    shift), then the rows between the left and right chains from the topmost vertex, each
    edge stepped in 1/65536 pixels."""
    h, w = img.shape[:2]
    n = len(v)
    delta = (1 << shift) >> 1
    up = _XY_SHIFT - shift
    half = _XY_ONE >> 1
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    p0 = (v[-1][0] << up, v[-1][1] << up)
    for i, (px, py) in enumerate(v):
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        p = (px << up, py << up)
        if shift:
            _line2(img, p0, p, value)
        p0 = p
    if shift == 0:
        _lines8(img, v[-1:] + v[:-1], v, value)
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [[imin, 1, -_XY_ONE, 0, ymin], [imin, n - 1, -_XY_ONE, 0, ymin]]  # idx di x dx ye
    y, edges = ymin, n
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = idx0 + di - (n if idx0 + di >= n else 0)
                while True:
                    more = edges > 0
                    edges -= 1
                    if not more:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = v[idx0][0] << up, v[idx][0] << up
                        e[4], e[0], e[2] = ty, idx, xs
                        e[3] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        break
                    idx0, idx = idx, idx + di - (n if idx + di >= n else 0)
        if edges < 0:
            break
        # rows until the next edge change: each edge's x steps linearly
        stop = min(edge[0][4], edge[1][4], ymax + 1)
        k = np.arange(stop - y, dtype=np.int64)
        xa, xb = edge[0][2] + k * edge[0][3], edge[1][2] + k * edge[1][3]
        left, right = np.minimum(xa, xb), np.maximum(xa, xb)
        x1, x2 = (left + half) >> _XY_SHIFT, (right + half) >> _XY_SHIFT
        ys = y + k
        ok = (ys >= 0) & (x2 >= 0) & (x1 < w)
        x1, x2 = np.where(ok, np.maximum(x1, 0), 1), np.where(ok, np.minimum(x2, w - 1), 0)
        first = max(y, 0)
        _spans(img, first, x1[first - y:], x2[first - y:], value)
        edge[0][2] += len(k) * edge[0][3]
        edge[1][2] += len(k) * edge[1][3]
        y = stop
        if y > ymax:
            break


def _circle(img: np.ndarray, center, radius: int, value, fill: bool):
    """drawing.cpp's Circle: the integer midpoint circle, its rows filled or its 8 points
    a step set, clipped to the image."""
    h, w = img.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            for ya, xa, xb, inner in ((y11, x11, x12, False), (y12, x11, x12, False),
                                      (y21, x21, x22, True), (y22, x21, x22, True)):
                if inner and not (x21 < w and x22 >= 0):
                    continue
                if 0 <= ya < h:
                    if fill:
                        img[ya, max(xa, 0):min(xb, w - 1) + 1] = value
                    else:
                        if xa >= 0:
                            img[ya, xa] = value
                        if xb < w:
                            img[ya, xb] = value
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0  # (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_lines(img: np.ndarray, segments, value, thickness: int, shift: int):
    """drawing.cpp's ThickLine for LINE_8 of each (p0, p1, flags) in `segments`: 1-pixel
    lines (`cv::Line` between the ends rounded to whole pixels, all in one pass), or for
    each segment (in whole pixels first clipped to the image grown by the thickness on
    every side) a quadrilateral of the thickness (FillConvexPoly at 1/65536 pixel) with a
    filled Circle at each end named by flags (1: the start, 2: the end)."""
    up = _XY_SHIFT - shift
    half = _XY_ONE >> 1
    if thickness <= 1:  # rounded to whole pixels, at any shift
        ends = (np.array([(p0, p1) for p0, p1, _ in segments], np.int64).reshape(-1, 2, 2)
                << up) + half >> _XY_SHIFT
        _lines8(img, ends[:, 0], ends[:, 1], value)
        return
    h, w = img.shape[:2]
    t = thickness
    for p0, p1, flags in segments:
        if shift == 0:  # whole pixels: clipped to the image grown by the thickness
            inside, p0, p1 = _clip_line(w + 2 * t, h + 2 * t, (p0[0] + t, p0[1] + t),
                                        (p1[0] + t, p1[1] + t))
            if not inside:
                continue
            p0, p1 = (p0[0] - t, p0[1] - t), (p1[0] - t, p1[1] - t)
        p0 = (p0[0] << up, p0[1] << up)
        p1 = (p1[0] << up, p1[1] << up)
        dx, dy = (p0[0] - p1[0]) / _XY_ONE, (p1[1] - p0[1]) / _XY_ONE
        r = dx * dx + dy * dy
        odd = t & 1
        th = t << (_XY_SHIFT - 1)
        if abs(r) > np.finfo(np.float64).eps:
            r = (th + odd * _XY_ONE * 0.5) / np.sqrt(r)
            ddx, ddy = int(np.rint(dy * r)), int(np.rint(dx * r))
            _fill_convex_poly(img, [(p0[0] + ddx, p0[1] + ddy), (p0[0] - ddx, p0[1] - ddy),
                                    (p1[0] - ddx, p1[1] - ddy), (p1[0] + ddx, p1[1] + ddy)],
                              value, _XY_SHIFT)
        for i in range(2):
            if flags & (i + 1):
                _circle(img, ((p0[0] + half) >> _XY_SHIFT, (p0[1] + half) >> _XY_SHIFT),
                        (th + half) >> _XY_SHIFT, value, True)
            p0 = p1


def _color(img: np.ndarray, color):
    """A pixel of `color` as OpenCV's scalarToRawData makes it: the colour's first channels
    (a number is its first channel, the others 0), rounded and saturated to uint8."""
    c = np.zeros(4)
    v = np.atleast_1d(np.asarray(color, np.float64)).ravel()[:4]
    c[:len(v)] = v
    px = np.clip(np.rint(c[:img.shape[2] if img.ndim == 3 else 1]), 0, 255).astype(np.uint8)
    return px if img.ndim == 3 else px[0]


def _check(img: np.ndarray, thickness: int, shift: int = 0, fill_ok: bool = False):
    if img.dtype != np.uint8:
        raise ValueError(f"drawing takes uint8 images, not {img.dtype}")
    if not (fill_ok and thickness < 0) and not 0 < thickness <= _MAX_THICKNESS:
        raise ValueError(f"thickness {thickness} is outside 1..{_MAX_THICKNESS}")
    if not 0 <= shift <= _XY_SHIFT:
        raise ValueError(f"shift {shift} is outside 0..{_XY_SHIFT}")


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1, shift: int = 0) -> np.ndarray:
    """cv2.line(img, pt1, pt2, color, thickness, cv2.LINE_8, shift) in place; returns img."""
    _check(img, thickness, shift)
    _thick_lines(img, [((int(pt1[0]), int(pt1[1])), (int(pt2[0]), int(pt2[1])), 3)],
                 _color(img, color), thickness, shift)
    return img


def polylines(img: np.ndarray, pts, is_closed: bool, color, thickness: int = 1,
              shift: int = 0) -> np.ndarray:
    """cv2.polylines(img, pts, is_closed, color, thickness, cv2.LINE_8, shift) in place;
    `pts` is a list of (n, 2) integer arrays. Returns img."""
    _check(img, thickness, shift)
    segments = []
    for poly in pts:
        v = [(int(x), int(y)) for x, y in np.asarray(poly).reshape(-1, 2)]
        if not v:
            continue
        p0, flags = v[-1 if is_closed else 0], 2 + (not is_closed)
        for p in v[(not is_closed):]:
            segments.append((p0, p, flags))
            p0, flags = p, 2
    if segments:
        _thick_lines(img, segments, _color(img, color), thickness, shift)
    return img


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """cv2.rectangle(img, pt1, pt2, color, thickness, cv2.LINE_8) in place: the closed
    polyline of its four corners, or with thickness < 0 the filled convex polygon. Returns
    img."""
    _check(img, thickness, fill_ok=True)
    (x1, y1), (x2, y2) = (int(pt1[0]), int(pt1[1])), (int(pt2[0]), int(pt2[1]))
    corners = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    if thickness >= 0:
        return polylines(img, [np.array(corners)], True, color, thickness)
    _fill_convex_poly(img, corners, _color(img, color), 0)
    return img


def circle(img: np.ndarray, center, radius: int, color, thickness: int = 1) -> np.ndarray:
    """cv2.circle(img, center, radius, color, thickness, cv2.LINE_8) in place for thickness
    1 (the outline) or < 0 (filled): drawing.cpp's integer Circle. Returns img."""
    _check(img, thickness, fill_ok=True)
    if thickness > 1:
        raise NotImplementedError("circle outlines thicker than 1 pixel (OpenCV's EllipseEx) "
                                  "are not part of this port")
    if radius < 0:
        raise ValueError(f"negative radius {radius}")
    _circle(img, (int(center[0]), int(center[1])), int(radius), _color(img, color), thickness < 0)
    return img


def add_weighted(src1: np.ndarray, alpha: float, src2: np.ndarray, beta: float,
                 gamma: float) -> np.ndarray:
    """cv2.addWeighted of two uint8 images: saturate_cast<uchar>(fma(src1, alpha, fma(src2,
    beta, gamma))) with the factors in float32, each fused multiply-add rounded once and
    the result rounded half to even, as OpenCV's SIMD loop computes it."""
    if src1.shape != src2.shape or src1.dtype != np.uint8 or src2.dtype != np.uint8:
        raise ValueError("add_weighted takes two uint8 images of one shape")
    f = np.float32
    inner = _fma(src2, f(beta), f(gamma))
    return np.clip(np.rint(_fma(src1, f(alpha), inner)), 0, 255).astype(np.uint8)


def put_text(img: np.ndarray, text: str, org, font_scale: float, color,
             thickness: int = 1) -> np.ndarray:
    """cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, font_scale, color, thickness,
    cv2.LINE_8) in place, as OpenCV 4.x draws it: the Hershey simplex strokes of
    `data/hershey.py`, each an open polyline at 1/65536 pixel, the origin at the baseline's
    left end. Bytes outside printable ASCII draw '?', as OpenCV's readCheck maps them.
    Returns img."""
    _check(img, thickness)
    if not text:
        return img
    value = _color(img, color)
    scale = int(np.rint(font_scale * _XY_ONE))
    view_x = int(org[0]) << _XY_SHIFT
    view_y = (int(org[1]) << _XY_SHIFT) - BASE_LINE * scale
    segments = []
    for byte in text.encode("utf-8"):
        if byte == 127:
            raise NotImplementedError("put_text of the DEL character")
        glyph = GLYPHS[chr(byte) if 32 <= byte < 127 else "?"]
        view_x -= (ord(glyph[0]) - 82) * scale
        for stroke in glyph[2:].split(" ") if len(glyph) > 2 else ():
            pts = [((ord(stroke[k]) - 82) * scale + view_x, (ord(stroke[k + 1]) - 82) * scale
                    + view_y) for k in range(0, len(stroke), 2)]
            if len(pts) > 1:
                segments += [(p0, p, 3 if i == 0 else 2) for i, (p0, p) in
                             enumerate(zip(pts[:-1], pts[1:]))]
        view_x += (ord(glyph[1]) - 82) * scale
    if segments:
        _thick_lines(img, segments, value, thickness, _XY_SHIFT)
    return img


# ---- contours: cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE), for Masks.xy -------

def find_contours_external(mask: np.ndarray) -> list:
    """`cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]` of a 2-D mask
    (nonzero is inside): the outer border of each object not inside another's hole, as
    (k, 2) int32 (x, y) arrays with OpenCV's start points, orientation, compressed runs and
    order (`csrc/contours.c`, Suzuki-Abe border following as OpenCV's legacy scanner does
    it)."""
    src = np.ascontiguousarray(np.asarray(mask) != 0, np.uint8)
    if src.ndim != 2:
        raise ValueError(f"find_contours_external takes a 2-D mask, not {src.shape}")
    lib = library(_CONTOURS_SOURCE, {"find_contours_external": (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_long,
         ctypes.c_void_p, ctypes.c_long, ctypes.POINTER(ctypes.c_long)], ctypes.c_long)})
    h, w = src.shape
    cap, max_n = 4 * (h + w) + 64, 64
    while True:
        points, counts, total = np.empty((cap, 2), np.int32), np.empty(max_n, np.int32), \
            ctypes.c_long()
        n = lib.find_contours_external(src.ctypes.data, h, w, points.ctypes.data, cap,
                                       counts.ctypes.data, max_n, ctypes.byref(total))
        if n == -2:
            raise MemoryError("out of memory following mask contours")
        if n <= max_n and total.value <= cap:
            break
        cap, max_n = max(cap, total.value), max(max_n, n)
    ends = np.cumsum(counts[:n])
    return [points[e - c:e].copy() for c, e in zip(counts[:n], ends)][::-1]


def contour_area(contour: np.ndarray) -> float:
    """cv2.contourArea(contour): the shoelace area in double, its absolute value."""
    c = np.asarray(contour, np.float64).reshape(-1, 2)
    if len(c) < 3:
        return 0.0
    prev = np.roll(c, 1, axis=0)
    return abs(float(np.sum(prev[:, 0] * c[:, 1] - prev[:, 1] * c[:, 0])) * 0.5)
