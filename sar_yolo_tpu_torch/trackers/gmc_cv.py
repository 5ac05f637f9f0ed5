"""numpy copies of the OpenCV calls that BoT-SORT's camera-motion compensation makes
(`trackers/gmc.py`, method sparseOptFlow), equal to OpenCV 5.0's results (the card's
machine has no OpenCV). Host code: GMC runs on the CPU in the JAX package too.

* `bgr2gray`: cv2.cvtColor(BGR2GRAY) on uint8, (3735 B + 19235 G + 9798 R + 2^14) >> 15
  (OpenCV 5.0's 15-bit coefficients; the 14-bit set 1868/9617/4899 differs on 0.26% of
  the BGR triples).
* `good_features_to_track(maxCorners, qualityLevel, minDistance=1, blockSize=3)`: the
  3x3 Sobel in float32 as OpenCV's AVX2 filters round it (the x derivative's smoothing
  column pass one fused multiply-add; the y derivative's smoothing row pass two of them on
  the columns its 32-wide loop covers and plain products on the rest), products summed by the box filter
  in float64 with its running column sums, the smaller eigenvalue in float32, the
  threshold at quality * max, the 3x3 local maxima, then the sort by value (ties: the
  later pixel first) that RANSAC's draws by index depend on. minDistance 1 drops nothing.
  Bit for bit OpenCV's.
* `calc_optical_flow_pyr_lk` (winSize 21, maxLevel 3, COUNT|EPS 30 / 0.01,
  minEigThreshold 1e-4): the pyrDown pyramid with 21-pixel reflected borders, Scharr
  derivatives in int16 with zero borders, 14-bit bilinear weights (cvRound of float32
  products) and the integer descaling of the window, then the float32 Newton steps with
  OpenCV's stopping rules (the step's square under 1e-4, or a half step back where it
  oscillates), vectorised over the points. The window's sums are float32 in the order of
  OpenCV's SIMD loops (8 columns a step, the last 5 in its scalar loop; `_a_sums`,
  `_b_sums`), so the points are OpenCV's bit for bit. The status is OpenCV's: a window
  outside the bordered level, a minimum eigenvalue under the threshold, or a final point
  outside the image's border fails.
* `estimate_affine_partial_2d` (RANSAC, threshold 3, confidence 0.99, 2000 iterations,
  10 refinement iterations): cv::RNG's multiply-with-carry seeded with 2^64 - 1 as
  OpenCV's point-set registrator seeds it, two distinct indices a draw, the analytic
  two-point similarity, the float32 reprojection error, the adaptive iteration count,
  then the Levenberg-Marquardt refinement (OpenCV's LMSolver: Fletcher's lambda rule)
  on the inliers in float64.
"""

from __future__ import annotations

import math

import numpy as np

f32 = np.float32
WIN = 21            # calcOpticalFlowPyrLK's default winSize
MAX_LEVEL = 3
LK_ITERS, LK_EPS = 30, 0.01
MIN_EIG = 1e-4
RANSAC_THRESH, RANSAC_CONFIDENCE, RANSAC_ITERS, RANSAC_REFINE_ITERS = 3.0, 0.99, 2000, 10
W_BITS = 14
FLT_EPSILON = float(np.finfo(np.float32).eps)
_FLT_SCALE = f32(1.0 / (1 << 20))


def bgr2gray(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) of a uint8 (h, w, 3) image."""
    b, g, r = (img[..., i].astype(np.int32) for i in range(3))
    return ((3735 * b + 19235 * g + 9798 * r + (1 << 14)) >> 15).astype(np.uint8)


def _reflect101(img: np.ndarray, top: int, left: int = None) -> np.ndarray:
    """BORDER_REFLECT_101 of `top` rows above and below and `left` columns each side."""
    left = top if left is None else left
    return np.pad(img, ((top, top), (left, left)), mode="reflect")


def _fma(a, b, c):
    """float32 a * b + c rounded once (the product of float32 values is exact in float64,
    and so is the sum at these magnitudes)."""
    return (np.asarray(a, np.float64) * np.float64(b) + np.asarray(c, np.float64)).astype(np.float32)


def min_eigen_val(gray: np.ndarray) -> np.ndarray:
    """cv2.cornerMinEigenVal(gray, blockSize=3, ksize=3), float32."""
    scale = 1.0 / (4 * 3 * 255)
    k, k2 = f32(scale), f32(2 * scale)
    p = _reflect101(gray.astype(np.float32), 1)
    rx = p[:, 2:] - p[:, :-2]
    dx = _fma(rx[:-2] + rx[2:], k, k2 * rx[1:-1])
    left, centre, right = p[:, :-2], p[:, 1:-1], p[:, 2:]
    ry = (k * left + k2 * centre) + k * right       # the row filter's scalar tail
    simd = 32 * (gray.shape[1] // 32)                # its AVX2 loop: 32 columns a step
    ry[:, :simd] = _fma(right[:, :simd], k, _fma(centre[:, :simd], k2, k * left[:, :simd]))
    dy = ry[2:] - ry[:-2]
    cov = np.stack([dx * dx, dx * dy, dy * dy]).astype(np.float64)
    q = np.pad(cov, ((0, 0), (1, 1), (1, 1)), mode="reflect")
    r = (q[:, :, :-2] + q[:, :, 1:-1]) + q[:, :, 2:]
    # the column filter's running sums, in its order: s = r0 + r1, then for each row
    # s + r[y + 2] is the output and s + r[y + 2] - r[y] the next s
    H = gray.shape[0]
    rt = r.transpose(0, 2, 1)                         # each column's sums run along a row
    terms = np.empty(rt.shape[:2] + (2 * H + 1,))
    terms[:, :, 0] = rt[:, :, 0] + rt[:, :, 1]
    terms[:, :, 1::2] = rt[:, :, 2:]
    terms[:, :, 2::2] = -rt[:, :, :H]
    box = np.add.accumulate(terms, axis=2)[:, :, 1::2].astype(np.float32).transpose(0, 2, 1)
    a, b, c = box[0] * f32(0.5), box[1], box[2] * f32(0.5)
    return (a + c) - np.sqrt((a - c) * (a - c) + b * b)


def good_features_to_track(gray: np.ndarray, max_corners: int = 1000,
                           quality_level: float = 0.01) -> np.ndarray | None:
    """cv2.goodFeaturesToTrack(gray, max_corners, quality_level, minDistance=1,
    blockSize=3): (n, 1, 2) float32 corners, strongest first, or None where none."""
    eig = min_eigen_val(gray)
    thr = f32(float(eig.max()) * quality_level)
    eig = np.where(eig > thr, eig, f32(0))
    H, W = eig.shape
    if H < 3 or W < 3:
        return None
    dil = eig[:-2, :-2]
    for dy in range(3):
        for dx in range(3):
            dil = np.maximum(dil, eig[dy:dy + H - 2, dx:dx + W - 2])
    c = eig[1:-1, 1:-1]
    ys, xs = np.nonzero((c != 0) & (c == dil))
    if not len(ys):
        return None
    ys, xs = ys + 1, xs + 1
    order = np.lexsort((-(ys * W + xs), -eig[ys, xs]))[:max_corners]
    return np.stack([xs[order], ys[order]], 1).astype(np.float32)[:, None, :]


def pyr_down(img: np.ndarray) -> np.ndarray:
    """cv2.pyrDown of a uint8 image: [1 4 6 4 1]^2 / 256, reflected borders, size
    ((w + 1) / 2, (h + 1) / 2)."""
    h, w = img.shape
    p = _reflect101(img.astype(np.int32), 2)
    oh, ow = (h + 1) // 2, (w + 1) // 2
    cols = 2 * np.arange(ow)
    r = (p[:, cols] + p[:, cols + 4]) + 4 * (p[:, cols + 1] + p[:, cols + 3]) + 6 * p[:, cols + 2]
    rows = 2 * np.arange(oh)
    s = (r[rows] + r[rows + 4]) + 4 * (r[rows + 1] + r[rows + 3]) + 6 * r[rows + 2]
    return ((s + 128) >> 8).astype(np.uint8)


def scharr_deriv(img: np.ndarray) -> np.ndarray:
    """lkpyramid.cpp calcScharrDeriv: (h, w, 2) int16 [Ix, Iy], reflected borders."""
    p = _reflect101(img.astype(np.int32), 1)
    t0 = (p[:-2] + p[2:]) * 3 + p[1:-1] * 10
    t1 = p[2:] - p[:-2]
    ix = t0[:, 2:] - t0[:, :-2]
    iy = (t1[:, 2:] + t1[:, :-2]) * 3 + t1[:, 1:-1] * 10
    return np.stack([ix, iy], -1).astype(np.int16)


def build_pyramid(gray: np.ndarray, max_level: int = MAX_LEVEL):
    """buildOpticalFlowPyramid(withDerivatives=False): the levels, each with a WIN-pixel
    reflected border, as far as a level is still wider and taller than the window."""
    levels, img = [], gray
    for level in range(max_level + 1):
        if level:
            img = pyr_down(img)
        levels.append(img)
        h, w = (img.shape[0] + 1) // 2, (img.shape[1] + 1) // 2
        if w <= WIN or h <= WIN:
            break
    return levels


def _weights(frac_x, frac_y):
    """The 14-bit bilinear weights of lkpyramid.cpp: cvRound of float32 products."""
    one = f32(1)
    s = f32(1 << W_BITS)
    w00 = np.rint((one - frac_x) * (one - frac_y) * s).astype(np.int32)
    w01 = np.rint(frac_x * (one - frac_y) * s).astype(np.int32)
    w10 = np.rint((one - frac_x) * frac_y * s).astype(np.int32)
    return w00, w01, w10, (1 << W_BITS) - w00 - w01 - w10


def _window(img, ix, iy):
    """(n, WIN + 1, WIN + 1[, c]) patches of a bordered level from the corner (ix, iy) in
    the level's coordinates."""
    r = np.arange(WIN + 1)
    offsets = r[:, None] * img.shape[1] + r[None, :]
    start = (iy + WIN) * img.shape[1] + (ix + WIN)
    flat = img.reshape(img.shape[0] * img.shape[1], -1)
    out = np.take(flat, start[:, None, None] + offsets[None], axis=0)
    return out.reshape(out.shape[:3] + img.shape[2:])


def _interp(patch, w, shift):
    """CV_DESCALE of the bilinear sum of (n, WIN + 1, WIN + 1[, c]) patches."""
    w00, w01, w10, w11 = (x.reshape((-1, 1, 1) + (1,) * (patch.ndim - 3)) for x in w)
    s = (patch[:, :-1, :-1] * w00 + patch[:, :-1, 1:] * w01 + patch[:, 1:, :-1] * w10
         + patch[:, 1:, 1:] * w11)
    return (s + (1 << (shift - 1))) >> shift


def calc_optical_flow_pyr_lk(prev: np.ndarray, nxt: np.ndarray, pts: np.ndarray,
                             max_level: int = MAX_LEVEL, iters: int = LK_ITERS):
    """cv2.calcOpticalFlowPyrLK(prev, nxt, pts, None) at its defaults: (next points
    (n, 1, 2) float32, status (n, 1) uint8). Raises ValueError where the two frames differ
    in size, as OpenCV's assertion does."""
    if prev.shape != nxt.shape:
        raise ValueError(f"calcOpticalFlowPyrLK: frames of {prev.shape} and {nxt.shape}")
    p0 = pts.reshape(-1, 2).astype(np.float32)
    n = len(p0)
    pyr0, pyr1 = build_pyramid(prev, max_level), build_pyramid(nxt, max_level)
    max_level = len(pyr0) - 1
    status = np.ones(n, bool)
    nxt_pts = np.zeros((n, 2), np.float32)
    half = f32((WIN - 1) * 0.5)
    for level in range(max_level, -1, -1):
        I, J = pyr0[level], pyr1[level]
        rows, cols = I.shape
        Ib = _reflect101(I.astype(np.int32), WIN)
        Jb = _reflect101(J.astype(np.int32), WIN)
        dI = np.zeros((rows + 2 * WIN, cols + 2 * WIN, 2), np.int32)
        dI[WIN:-WIN, WIN:-WIN] = scharr_deriv(I)
        prev_pt = p0 * f32(1.0 / (1 << level))
        nxt_pts = prev_pt.copy() if level == max_level else nxt_pts * f32(2)
        prev_pt = prev_pt - half
        ip = np.floor(prev_pt).astype(np.int64)
        ok = (ip[:, 0] >= -WIN) & (ip[:, 0] < cols) & (ip[:, 1] >= -WIN) & (ip[:, 1] < rows)
        if level == 0:
            status &= ok
        idx = np.nonzero(ok)[0]
        if not len(idx):
            continue
        ipx, ipy = ip[idx, 0], ip[idx, 1]
        w = _weights(prev_pt[idx, 0] - ipx.astype(np.float32),
                     prev_pt[idx, 1] - ipy.astype(np.float32))
        Iwin = _interp(_window(Ib, ipx, ipy), w, W_BITS - 5)
        dwin = _interp(_window(dI, ipx, ipy), w, W_BITS)
        ix, iy = dwin[..., 0], dwin[..., 1]
        A11, A12, A22 = (v * _FLT_SCALE for v in _a_sums(ix, iy))
        D = A11 * A22 - A12 * A12
        min_eig = (A22 + A11 - np.sqrt((A11 - A22) * (A11 - A22) + f32(4) * A12 * A12)) \
            / f32(2 * WIN * WIN)
        good = ~((min_eig < f32(MIN_EIG)) | (D < f32(FLT_EPSILON)))
        if level == 0:
            status[idx[~good]] = False
        idx, Iwin, ix, iy = idx[good], Iwin[good], ix[good], iy[good]
        A11, A12, A22 = A11[good], A12[good], A22[good]
        D = f32(1) / D[good]
        pt = nxt_pts[idx] - half
        prev_delta = np.zeros_like(pt)
        live = np.ones(len(idx), bool)
        for j in range(iters):
            a = np.nonzero(live)[0]
            if not len(a):
                break
            inp = np.floor(pt[a]).astype(np.int64)
            out = (inp[:, 0] < -WIN) | (inp[:, 0] >= cols) | (inp[:, 1] < -WIN) | \
                (inp[:, 1] >= rows)
            if level == 0:
                status[idx[a[out]]] = False
            live[a[out]] = False
            a, inp = a[~out], inp[~out]
            if not len(a):
                break
            w = _weights(pt[a, 0] - inp[:, 0].astype(np.float32),
                         pt[a, 1] - inp[:, 1].astype(np.float32))
            diff = _interp(_window(Jb, inp[:, 0], inp[:, 1]), w, W_BITS - 5) - Iwin[a]
            b1, b2 = (v * _FLT_SCALE for v in _b_sums(diff, ix[a], iy[a]))
            delta = np.stack([(A12[a] * b2 - A22[a] * b1) * D[a],
                              (A12[a] * b1 - A11[a] * b2) * D[a]], 1)
            pt[a] = pt[a] + delta
            nxt_pts[idx[a]] = pt[a] + half
            d64 = delta.astype(np.float64)
            small = (d64 * d64).sum(1) <= LK_EPS * LK_EPS
            osc = ~small & (j > 0) & (np.abs((delta + prev_delta[a]).astype(np.float64))
                                      < LK_EPS).all(1)
            nxt_pts[idx[a[osc]]] -= delta[osc] * f32(0.5)
            live[a[small | osc]] = False
            prev_delta[a] = delta
    # the error's pass at level 0: a final point outside the bordered image fails
    rows, cols = pyr1[0].shape
    fin = np.floor(nxt_pts - half).astype(np.int64)
    status &= (fin[:, 0] >= -WIN) & (fin[:, 0] < cols) & (fin[:, 1] >= -WIN) & \
        (fin[:, 1] < rows)
    return nxt_pts.reshape(-1, 1, 2), status.astype(np.uint8).reshape(-1, 1)


def _lanes(t, picks):
    """Sequential float32 sums of (n, WIN, WIN) terms over `picks`: for each lane, the
    columns it takes in one row, in order; rows in order."""
    seq = np.stack([t[:, :, cols].reshape(len(t), -1) for cols in picks], 1)
    return np.add.accumulate(seq, axis=2, dtype=np.float32)[:, :, -1]


def _tail(t):
    """The scalar loop's float32 sum of columns 16..20, row after row."""
    return np.add.accumulate(t[:, :, 16:].reshape(len(t), -1), axis=1,
                             dtype=np.float32)[:, -1]


# The SIMD loops take 8 columns a step. Lane k of the 4-lane A sums takes columns k, k + 4,
# k + 8, k + 12 of each row. The b sums' lanes (x, y, x, y) take the products of pixel pairs
# (k, k + 4), added in int32 before their one rounding to float32 (a dot product of int16
# pairs): one accumulator for k = 0, 1 and one for k = 2, 3.
_A_PICKS = [[k, k + 4, k + 8, k + 12] for k in range(4)]


def _a_sums(ix, iy):
    """LKTrackerInvoker's A11, A12, A22: float32 lanes reduced as (l0 + l2) + (l1 + l3),
    added to the scalar tail's sum."""
    out = []
    for t in (ix * ix, ix * iy, iy * iy):
        t = t.astype(np.float32)
        q = _lanes(t, _A_PICKS)
        out.append(_tail(t) + ((q[:, 0] + q[:, 2]) + (q[:, 1] + q[:, 3])))
    return out


def _b_sums(diff, ix, iy):
    """LKTrackerInvoker's b1, b2: the two accumulators added, then lanes 0 + 2 (x) and
    1 + 3 (y), added to the scalar tails."""
    px, py = diff * ix, diff * iy
    n = len(px)
    s = 0
    for k0 in (0, 2):
        lanes = [(t[:, :, [g + k for g in (0, 8)]] + t[:, :, [g + k + 4 for g in (0, 8)]])
                 .reshape(n, -1) for k in (k0, k0 + 1) for t in (px, py)]
        s = s + np.add.accumulate(np.stack(lanes, 1).astype(np.float32), axis=2,
                                  dtype=np.float32)[:, :, -1]
    tx, ty = _tail(px.astype(np.float32)), _tail(py.astype(np.float32))
    return tx + (s[:, 0] + s[:, 2]), ty + (s[:, 1] + s[:, 3])


def calc_optical_flow_pyr_lk(prev: np.ndarray, nxt: np.ndarray, pts: np.ndarray,
                             max_level: int = MAX_LEVEL, iters: int = LK_ITERS):
    """cv2.calcOpticalFlowPyrLK(prev, nxt, pts, None) at its defaults: (next points
    (n, 1, 2) float32, status (n, 1) uint8). Raises ValueError where the two frames differ
    in size, as OpenCV's assertion does."""
    if prev.shape != nxt.shape:
        raise ValueError(f"calcOpticalFlowPyrLK: frames of {prev.shape} and {nxt.shape}")
    p0 = pts.reshape(-1, 2).astype(np.float32)
    n = len(p0)
    pyr0, pyr1 = build_pyramid(prev, max_level), build_pyramid(nxt, max_level)
    max_level = len(pyr0) - 1
    status = np.ones(n, bool)
    nxt_pts = np.zeros((n, 2), np.float32)
    half = f32((WIN - 1) * 0.5)
    for level in range(max_level, -1, -1):
        I, J = pyr0[level], pyr1[level]
        rows, cols = I.shape
        Ib = _reflect101(I.astype(np.int32), WIN)
        Jb = _reflect101(J.astype(np.int32), WIN)
        dI = np.zeros((rows + 2 * WIN, cols + 2 * WIN, 2), np.int32)
        dI[WIN:-WIN, WIN:-WIN] = scharr_deriv(I)
        prev_pt = p0 * f32(1.0 / (1 << level))
        nxt_pts = prev_pt.copy() if level == max_level else nxt_pts * f32(2)
        prev_pt = prev_pt - half
        ip = np.floor(prev_pt).astype(np.int64)
        ok = (ip[:, 0] >= -WIN) & (ip[:, 0] < cols) & (ip[:, 1] >= -WIN) & (ip[:, 1] < rows)
        if level == 0:
            status &= ok
        idx = np.nonzero(ok)[0]
        if not len(idx):
            continue
        ipx, ipy = ip[idx, 0], ip[idx, 1]
        w = _weights(prev_pt[idx, 0] - ipx.astype(np.float32),
                     prev_pt[idx, 1] - ipy.astype(np.float32))
        Iwin = _interp(_window(Ib, ipx, ipy), w, W_BITS - 5)
        dwin = _interp(_window(dI, ipx, ipy), w, W_BITS)
        ix, iy = dwin[..., 0], dwin[..., 1]
        A11, A12, A22 = (v * _FLT_SCALE for v in _a_sums(ix, iy))
        D = A11 * A22 - A12 * A12
        min_eig = (A22 + A11 - np.sqrt((A11 - A22) * (A11 - A22) + f32(4) * A12 * A12)) \
            / f32(2 * WIN * WIN)
        good = ~((min_eig < f32(MIN_EIG)) | (D < f32(FLT_EPSILON)))
        if level == 0:
            status[idx[~good]] = False
        idx, Iwin, ix, iy = idx[good], Iwin[good], ix[good], iy[good]
        A11, A12, A22 = A11[good], A12[good], A22[good]
        D = f32(1) / D[good]
        pt = nxt_pts[idx] - half
        prev_delta = np.zeros_like(pt)
        live = np.ones(len(idx), bool)
        for j in range(iters):
            a = np.nonzero(live)[0]
            if not len(a):
                break
            inp = np.floor(pt[a]).astype(np.int64)
            out = (inp[:, 0] < -WIN) | (inp[:, 0] >= cols) | (inp[:, 1] < -WIN) | \
                (inp[:, 1] >= rows)
            if level == 0:
                status[idx[a[out]]] = False
            live[a[out]] = False
            a, inp = a[~out], inp[~out]
            if not len(a):
                break
            w = _weights(pt[a, 0] - inp[:, 0].astype(np.float32),
                         pt[a, 1] - inp[:, 1].astype(np.float32))
            diff = _interp(_window(Jb, inp[:, 0], inp[:, 1]), w, W_BITS - 5) - Iwin[a]
            b1, b2 = (v * _FLT_SCALE for v in _b_sums(diff, ix[a], iy[a]))
            delta = np.stack([(A12[a] * b2 - A22[a] * b1) * D[a],
                              (A12[a] * b1 - A11[a] * b2) * D[a]], 1)
            pt[a] = pt[a] + delta
            nxt_pts[idx[a]] = pt[a] + half
            d64 = delta.astype(np.float64)
            small = (d64 * d64).sum(1) <= LK_EPS * LK_EPS
            osc = ~small & (j > 0) & (np.abs((delta + prev_delta[a]).astype(np.float64))
                                      < LK_EPS).all(1)
            nxt_pts[idx[a[osc]]] -= delta[osc] * f32(0.5)
            live[a[small | osc]] = False
            prev_delta[a] = delta
    # the error's pass at level 0: a final point outside the bordered image fails
    rows, cols = pyr1[0].shape
    fin = np.floor(nxt_pts - half).astype(np.int64)
    status &= (fin[:, 0] >= -WIN) & (fin[:, 0] < cols) & (fin[:, 1] >= -WIN) & \
        (fin[:, 1] < rows)
    return nxt_pts.reshape(-1, 1, 2), status.astype(np.uint8).reshape(-1, 1)


class RNG:
    """cv::RNG: multiply-with-carry, state = (uint32)state * 4164903690 + (state >> 32)."""

    def __init__(self, state: int = (1 << 64) - 1):
        self.state = state or 0xFFFFFFFF

    def next(self) -> int:
        s = self.state
        self.state = ((s & 0xFFFFFFFF) * 4164903690 + (s >> 32)) & ((1 << 64) - 1)
        return self.state & 0xFFFFFFFF

    def uniform(self, a: int, b: int) -> int:
        return a if a == b else self.next() % (b - a) + a


def _similarity(p, q) -> np.ndarray:
    """AffinePartial2DEstimatorCallback::runKernel: the similarity through two pairs."""
    x1, y1, x2, y2 = (float(v) for v in (p[0, 0], p[0, 1], p[1, 0], p[1, 1]))
    X1, Y1, X2, Y2 = (float(v) for v in (q[0, 0], q[0, 1], q[1, 0], q[1, 1]))
    d = 1. / ((x1 - x2) * (x1 - x2) + (y1 - y2) * (y1 - y2))
    S0 = d * ((X1 - X2) * (x1 - x2) + (Y1 - Y2) * (y1 - y2))
    S1 = d * ((Y1 - Y2) * (x1 - x2) - (X1 - X2) * (y1 - y2))
    S2 = d * ((Y1 - Y2) * (x1 * y2 - x2 * y1) - (X1 * y2 - X2 * y1) * (y1 - y2)
              - (X1 * x2 - X2 * x1) * (x1 - x2))
    S3 = d * (-(X1 - X2) * (x1 * y2 - x2 * y1) - (Y1 * x2 - Y2 * x1) * (x1 - x2)
              - (Y1 * y2 - Y2 * y1) * (y1 - y2))
    return np.array([[S0, -S1, S2], [S1, S0, S3]])


def _inliers(src, dst, M, thresh: float):
    """Affine2DEstimatorCallback::computeError in float32, then err <= thresh^2."""
    F = M.reshape(-1).astype(np.float32)
    a = F[0] * src[:, 0] + F[1] * src[:, 1] + F[2] - dst[:, 0]
    b = F[3] * src[:, 0] + F[4] * src[:, 1] + F[5] - dst[:, 1]
    return a * a + b * b <= f32(thresh * thresh)


def _update_iters(p: float, ep: float, model_points: int, max_iters: int) -> int:
    """RANSACUpdateNumIters."""
    p, ep = min(max(p, 0.), 1.), min(max(ep, 0.), 1.)
    num = max(1. - p, np.finfo(np.float64).tiny)
    denom = 1. - (1. - ep) ** model_points
    if denom < np.finfo(np.float64).tiny:
        return 0
    num, denom = math.log(num), math.log(denom)
    return max_iters if denom >= 0 or -num >= max_iters * (-denom) else \
        int(np.rint(num / denom))


def _refine(src, dst, h: np.ndarray, max_iters: int) -> np.ndarray:
    """LMSolver on AffinePartial2DRefineCallback: h = (a, b, tx, ty) of
    [[a, -b, tx], [b, a, ty]], residuals in float64."""
    M = src.astype(np.float64)
    m = dst.astype(np.float64)
    Jm = np.zeros((2 * len(M), 4))
    Jm[0::2, 0], Jm[0::2, 1], Jm[0::2, 2] = M[:, 0], -M[:, 1], 1
    Jm[1::2, 0], Jm[1::2, 1], Jm[1::2, 3] = M[:, 1], M[:, 0], 1

    def resid(p):
        r = np.empty(2 * len(M))
        r[0::2] = p[0] * M[:, 0] - p[1] * M[:, 1] + p[2] - m[:, 0]
        r[1::2] = p[1] * M[:, 0] + p[0] * M[:, 1] + p[3] - m[:, 1]
        return r

    x = h.astype(np.float64).copy()
    r = resid(x)
    S = float(r @ r)
    A = Jm.T @ Jm
    v = Jm.T @ r
    D = np.diag(A).copy()
    lam, lc = 1.0, 0.75
    eps = FLT_EPSILON
    for it in range(1, max_iters + 1):
        d = np.linalg.solve(A + np.diag(lam * D), v)
        xd = x - d
        rd = resid(xd)
        Sd = float(rd @ rd)
        dS = float(d @ (2 * v - A @ d))
        R = (S - Sd) / (dS if abs(dS) > np.finfo(np.float64).eps else 1)
        if R > 0.75:
            lam *= 0.5
            if lam < lc:
                lam = 0.0
        elif R < 0.25:
            t = float(d @ v)
            nu = (Sd - S) / (t if abs(t) > np.finfo(np.float64).eps else 1) + 2
            nu = min(max(nu, 2.), 10.)
            if lam == 0:
                inv = np.linalg.inv(A)
                lam = lc = 1. / max(np.finfo(np.float64).eps, np.abs(np.diag(inv)).max())
                nu *= 0.5
            lam *= nu
        if Sd < S:
            S, x, r = Sd, xd, rd
            v = Jm.T @ r
        if not (np.abs(d).max() >= eps and np.abs(r).max() >= eps):
            break
    return x


def estimate_affine_partial_2d(src: np.ndarray, dst: np.ndarray) -> np.ndarray | None:
    """cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC) at its defaults: the
    (2, 3) float64 similarity, or None where no draw found two inliers."""
    src = src.reshape(-1, 2).astype(np.float32)
    dst = dst.reshape(-1, 2).astype(np.float32)
    count = len(src)
    if count < 2:
        return None
    rng = RNG()
    best, best_mask, max_good = None, None, 0
    if count == 2:
        best, best_mask = _similarity(src, dst), np.ones(count, bool)
    else:
        niters, it = RANSAC_ITERS, 0
        while it < niters:
            i0 = rng.uniform(0, count)
            i1 = rng.uniform(0, count)
            while i1 == i0:
                i1 = rng.uniform(0, count)
            sel = [i0, i1]
            M = _similarity(src[sel], dst[sel])
            mask = _inliers(src, dst, M, RANSAC_THRESH)
            good = int(mask.sum())
            if good > max(max_good, 1):
                best, best_mask, max_good = M, mask, good
                niters = _update_iters(RANSAC_CONFIDENCE, (count - good) / count, 2, niters)
            it += 1
        if best is None:
            return None
    if count > 2 and best_mask.any():
        h = np.array([best[0, 0], best[1, 0], best[0, 2], best[1, 2]])
        a, b, tx, ty = _refine(src[best_mask], dst[best_mask], h, RANSAC_REFINE_ITERS)
        best = np.array([[a, -b, tx], [b, a, ty]])
    return best
