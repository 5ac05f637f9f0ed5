"""BoT-SORT's camera-motion compensation in the PyTorch port against OpenCV and the JAX
package, on the CPU.

(a) `trackers/gmc_cv.py`'s copies of the OpenCV calls that GMC makes, against this
environment's OpenCV: cvtColor(BGR2GRAY) on every BGR triple; goodFeaturesToTrack's corners
equal and in order (RANSAC draws them by index); the LK pyramid and its Scharr derivatives
equal; calcOpticalFlowPyrLK's status and points equal bit for bit (the window's float32
sums in the order of OpenCV's SIMD loops), at 1, 2 and 30 iterations on one level and on the
whole pyramid, with points on and past the border; estimateAffinePartial2D (RANSAC, then
the Levenberg-Marquardt refinement) on clean pairs and with 20% outliers.
(b) `GMC("sparseOptFlow").apply` against the JAX package's GMC (OpenCV) on the 24 frames of
`tests/data/video/flight.avi` and against the fixture's digests: the 2x2 block within 1e-5,
the translation within 1e-3 px; the identity on a first frame, on a change of frame size
and for `none`; orb, sift and ecc raise NotImplementedError naming ROADMAP.
(c) `STrack.multi_gmc` and BoT-SORT with sparseOptFlow over the fixture's frames and scripted
detections along its persons: the JAX package's track rows.
"""

import json
from pathlib import Path

import cv2
import numpy as np
import pytest

from sar_yolo_tpu.trackers.bot_sort import BOTSORT as JaxBOTSORT
from sar_yolo_tpu.trackers.byte_tracker import STrack as JaxSTrack
from sar_yolo_tpu.trackers.gmc import GMC as JaxGMC
from sar_yolo_tpu_torch.trackers import gmc_cv
from sar_yolo_tpu_torch.trackers.bot_sort import BOTSORT
from sar_yolo_tpu_torch.trackers.byte_tracker import STrack
from sar_yolo_tpu_torch.trackers.gmc import GMC

VIDEO = Path(__file__).parent / "data" / "video"
ROT_TOL, SHIFT_TOL = 1e-5, 1e-3


@pytest.fixture(scope="module")
def flight():
    """The fixture's frames as cv2.VideoCapture decodes them, and its digests."""
    cap = cv2.VideoCapture(str(VIDEO / "flight.avi"))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    return frames, json.loads((VIDEO / "digests.json").read_text())


def _half_gray(frame):
    g = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    return cv2.resize(g, (g.shape[1] // 2, g.shape[0] // 2))


def _textured_pan(seed: int, shape=(360, 640), shift=(5.0, 3.0), angle=0.3):
    """Two views of a blurred random terrain, the second panned and turned."""
    rng = np.random.default_rng(seed)
    h, w = shape
    small = rng.integers(0, 256, ((h + 80) // 8, (w + 80) // 8), dtype=np.uint8)
    ground = cv2.GaussianBlur(cv2.resize(small, (w + 80, h + 80), interpolation=cv2.INTER_CUBIC),
                              (0, 0), 1.2)
    M = cv2.getRotationMatrix2D(((w + 80) / 2, (h + 80) / 2), angle, 1.0)
    M[:, 2] += shift
    moved = cv2.warpAffine(ground, M, (w + 80, h + 80))
    return ground[40:40 + h, 40:40 + w].copy(), moved[40:40 + h, 40:40 + w].copy()


# ---- (a) the OpenCV copies ------------------------------------------------------------------

def test_bgr2gray_equals_cv2_on_every_triple():
    g, r = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8),
                       indexing="ij")
    for b in range(256):
        img = np.stack([np.full_like(g, b), g, r], -1)
        np.testing.assert_array_equal(gmc_cv.bgr2gray(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY),
                                      err_msg=f"B = {b}")


def _gftt_cases(flight):
    frames, _ = flight
    rng = np.random.default_rng(3)
    cases = {f"flight_{t}": _half_gray(frames[t]) for t in (0, 11, 23)}
    cases["pan_360x640"] = _textured_pan(1)[0]
    cases["noise_97x131"] = rng.integers(0, 256, (97, 131), dtype=np.uint8)
    cases["blobs_23x31"] = cv2.GaussianBlur(rng.integers(0, 256, (23, 31), dtype=np.uint8),
                                            (0, 0), 1.0)
    cases["flat_40x40"] = np.full((40, 40), 77, np.uint8)
    return cases


def test_good_features_to_track_equals_cv2(flight):
    for name, img in _gftt_cases(flight).items():
        want = cv2.goodFeaturesToTrack(img, maxCorners=1000, qualityLevel=0.01, minDistance=1,
                                       blockSize=3)
        np.testing.assert_array_equal(gmc_cv.min_eigen_val(img), cv2.cornerMinEigenVal(img, 3, 3),
                                      err_msg=name)
        got = gmc_cv.good_features_to_track(img)
        if want is None:
            assert got is None, name
            continue
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    many = _textured_pan(2)[0]
    assert len(gmc_cv.good_features_to_track(many)) == 1000  # maxCorners cuts the sorted list


@pytest.mark.parametrize("shape", [(360, 640), (97, 131), (45, 80)])
def test_lk_pyramid_and_derivatives_equal_cv2(shape):
    img = np.random.default_rng(shape[0]).integers(0, 256, shape, dtype=np.uint8)
    levels, want = cv2.buildOpticalFlowPyramid(img, (21, 21), 3, withDerivatives=True)
    got = gmc_cv.build_pyramid(img)
    assert len(got) == levels + 1
    for i, level in enumerate(got):
        np.testing.assert_array_equal(level, want[2 * i])
        np.testing.assert_array_equal(gmc_cv.scharr_deriv(level), want[2 * i + 1])


def _lk_pairs(flight):
    frames, _ = flight
    pairs = {f"flight_{t}": (_half_gray(frames[t - 1]), _half_gray(frames[t]))
             for t in range(1, len(frames), 4)}
    pairs["pan_rot"] = _textured_pan(5)
    pairs["pan_far"] = _textured_pan(6, shift=(14.0, -9.0), angle=-1.0)
    return pairs


@pytest.mark.parametrize("levels,iters", [(0, 1), (0, 2), (3, 30)])
def test_optical_flow_equals_cv2(flight, levels, iters):
    criteria = (cv2.TERM_CRITERIA_COUNT | cv2.TERM_CRITERIA_EPS, iters, 0.01)
    for name, (a, b) in _lk_pairs(flight).items():
        p0 = cv2.goodFeaturesToTrack(a, maxCorners=1000, qualityLevel=0.01, minDistance=1,
                                     blockSize=3)
        # points on and past the border: their status is OpenCV's too
        p0 = np.concatenate([p0, np.float32([[[0, 0]], [[-15, 3]], [[a.shape[1] + 30, 5]],
                                             [[a.shape[1] - 1, a.shape[0] - 1]]])])
        want, want_st, _ = cv2.calcOpticalFlowPyrLK(a, b, p0, None, maxLevel=levels,
                                                    criteria=criteria)
        got, st = gmc_cv.calc_optical_flow_pyr_lk(a, b, p0, levels, iters)
        np.testing.assert_array_equal(st, want_st, err_msg=name)
        ok = want_st.ravel() == 1
        assert ok.sum() > 100, name
        np.testing.assert_array_equal(got[ok], want[ok], err_msg=name)
    with pytest.raises(ValueError, match="frames of"):
        gmc_cv.calc_optical_flow_pyr_lk(a, b[:-2], p0)


@pytest.mark.parametrize("outliers", [0.0, 0.2])
def test_estimate_affine_partial_2d_equals_cv2(outliers):
    rng = np.random.default_rng(int(outliers * 10) + 1)
    for trial in range(4):
        n = int(rng.integers(6, 400))
        src = rng.uniform(0, 640, (n, 1, 2)).astype(np.float32)
        ang, s = rng.uniform(-0.01, 0.01), rng.uniform(0.98, 1.02)
        R = s * np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
        dst = (src @ R.T + rng.uniform(-8, 8, 2) + rng.normal(0, 0.3, src.shape))
        k = int(outliers * n)
        dst[rng.choice(n, k, replace=False)] += rng.uniform(-40, 40, (k, 1, 2))
        dst = dst.astype(np.float32)
        want, _ = cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)
        got = gmc_cv.estimate_affine_partial_2d(src, dst)
        np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0, atol=ROT_TOL)
        np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0, atol=SHIFT_TOL)
    two = np.float32([[[0, 0]], [[10, 0]]])
    np.testing.assert_allclose(gmc_cv.estimate_affine_partial_2d(two, two + 3),
                               cv2.estimateAffinePartial2D(two, two + 3)[0], atol=1e-12)


def test_rng_is_opencvs_multiply_with_carry():
    rng = gmc_cv.RNG()
    assert rng.state == (1 << 64) - 1
    draws = [rng.uniform(0, 1000) for _ in range(3)]
    state = (1 << 64) - 1
    for d in draws:
        state = ((state & 0xFFFFFFFF) * 4164903690 + (state >> 32)) & ((1 << 64) - 1)
        assert d == (state & 0xFFFFFFFF) % 1000


# ---- (b) GMC ----------------------------------------------------------------------------------

def _assert_warp(got, want, label):
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0, atol=ROT_TOL, err_msg=label)
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0, atol=SHIFT_TOL, err_msg=label)


def test_gmc_matches_jax_on_the_flight(flight):
    frames, digests = flight
    got_gmc, want_gmc = GMC("sparseOptFlow"), JaxGMC("sparseOptFlow")
    moved = 0.0
    for t, frame in enumerate(frames):
        got, want = got_gmc.apply(frame), want_gmc.apply(frame)
        assert got.shape == (2, 3) and got.dtype == np.float64
        _assert_warp(got, np.asarray(want), f"frame {t}")
        _assert_warp(got, np.array(digests["frames"][t]["gmc"]), f"digest {t}")
        moved += float(np.abs(got[:, 2]).sum())
    assert moved > 4 * (len(frames) - 1)  # the camera pans 4-8 px a frame


def test_gmc_identity_cases_and_refusals(flight):
    frames, _ = flight
    for method in ("sparseOptFlow", "none"):
        got, want = GMC(method), JaxGMC(method)
        for frame in (frames[0], frames[1], frames[2][:600, :1000], frames[3][:600, :1000]):
            _assert_warp(got.apply(frame), np.asarray(want.apply(frame)), method)
    assert np.array_equal(GMC("sparseOptFlow").apply(frames[0]), np.eye(2, 3))
    flat = GMC()  # no corners: the identity, as the JAX package gives it
    for _ in range(2):
        _assert_warp(flat.apply(np.full((64, 96, 3), 90, np.uint8)), np.eye(2, 3), "flat")
    for method in ("orb", "sift", "ecc"):
        with pytest.raises(NotImplementedError, match=f"GMC method '{method}'.*ROADMAP"):
            GMC(method)
        with pytest.raises(NotImplementedError, match=f"GMC method '{method}'"):
            BOTSORT(gmc_method=method)


# ---- (c) the tracks ---------------------------------------------------------------------------

def test_multi_gmc_equals_jax():
    rng = np.random.default_rng(7)
    H = np.array([[0.999, -0.02, 5.0], [0.02, 0.999, -3.0]])
    tracks = []
    for cls in (STrack, JaxSTrack):
        rng = np.random.default_rng(7)
        ts = [cls([10, 20, 40, 80], 0.9, 0) for _ in range(3)]
        for t in ts[:2]:
            t.mean = rng.normal(size=8) * 50
            t.covariance = np.cov(rng.normal(size=(8, 20)))
        cls.multi_gmc(ts, H)
        cls.multi_gmc([], H)
        tracks.append(ts)
    for got, want in zip(*tracks):
        assert (got.mean is None) == (want.mean is None)
        if got.mean is not None:
            np.testing.assert_array_equal(got.mean, want.mean)
            np.testing.assert_array_equal(got.covariance, want.covariance)


def test_botsort_with_sparse_optical_flow_matches_jax(flight):
    frames, digests = flight
    rng = np.random.default_rng(11)
    JaxSTrack._count = STrack._count = 0
    got_trk, want_trk = BOTSORT(), JaxBOTSORT()
    assert got_trk.gmc is not None and want_trk.gmc is not None
    emb = rng.normal(size=(6, 16))
    for t, frame in enumerate(frames[:12]):
        rows = np.array(digests["frames"][t]["persons"], np.float64)
        keep = rows[:, 2] > 0
        n = int(keep.sum())
        dets = np.concatenate([rows[keep, 1:5] + rng.normal(0, 0.7, (n, 4)),
                               rng.uniform(0.55, 0.95, (n, 1)), np.zeros((n, 1))], 1)
        feats = emb[rows[keep, 5].astype(int)] + rng.normal(0, 0.1, (n, 16))
        got = got_trk.update(dets.astype(np.float32), feats.astype(np.float32), img=frame)
        want = want_trk.update(dets.astype(np.float32), feats.astype(np.float32), img=frame)
        assert got.shape == want.shape, f"frame {t}"
        np.testing.assert_array_equal(got[:, 6], want[:, 6], err_msg=f"frame {t}")
        np.testing.assert_allclose(got[:, :6], want[:, :6], rtol=0, atol=1e-4,
                                   err_msg=f"frame {t}")
    assert STrack._count == JaxSTrack._count >= 6
