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
"""

from __future__ import annotations

import numpy as np

_RESIZE_BITS = 11          # INTER_RESIZE_COEF_BITS
_RESIZE_SCALE = 1 << _RESIZE_BITS
_WARP_LANES = 16           # warpAffine's SIMD columns per step (AVX2); the rest take its scalar loop


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
    """cv::clipLine on an image of w x h in int64 arithmetic: (inside, p1, p2), the points as
    OpenCV leaves them (moved part of the way where the segment misses the image)."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line8(img: np.ndarray, p1, p2, value):
    """cv::Line(img, p1, p2, color, 8): the 8-connected Bresenham line of LineIterator
    (clipped to the image, drawn left to right)."""
    h, w = img.shape[:2]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        inside, p1, p2 = _clip_line(w, h, p1, p2)
        if not inside:
            return
    (x, y), (x2, y2) = p1, p2
    dx, dy = x2 - x, y2 - y
    if dx < 0:
        dx, dy, (x, y) = -dx, -dy, (x2, y2)
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
    for _ in range(dx + 1):
        img[y, x] = value
        step = err < 0
        err += minus + (plus if step else 0)
        if vert:
            y += sy
            x += 1 if step else 0
        else:
            x += 1
            y += sy if step else 0


def fill_poly(img: np.ndarray, poly, value) -> np.ndarray:
    """cv2.fillPoly(img, [poly], value) in place with the defaults (8-connected edges, shift 0):
    `poly` is (n, 2) int32 vertices. OpenCV draws each edge with `cv::Line`, then fills the
    rows between the edges with its fixed-point scan (`FillEdgeCollection`: edges half open at
    their lower end, an edge that leaves the image starting from its clipped ends, spans from
    ceil(x_left) to floor(x_right), the active edges re-sorted by x on every row). Returns
    img."""
    pts = [(int(x), int(y)) for x, y in np.asarray(poly).reshape(-1, 2)]
    h, w = img.shape[:2]
    edges = []  # [y0, y1, x, dx] in 16.16 fixed point, as PolyEdge
    x0, y0 = pts[-1][0] << _XY_SHIFT, pts[-1][1]
    for px, py in pts:
        x1, y1 = px << _XY_SHIFT, py
        t0 = ((x0 + (_XY_ONE >> 1)) >> _XY_SHIFT, y0)
        t1 = ((x1 + (_XY_ONE >> 1)) >> _XY_SHIFT, y1)
        _line8(img, t0, t1, value)
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
