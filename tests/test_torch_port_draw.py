"""The port's image writers, drawing primitives and mask contours against OpenCV, on the CPU.

(a) `encode_jpeg` equals `cv2.imencode(".jpg")` byte for byte (libjpeg-turbo 3.1.2 under
    OpenCV 5.0, quality 95 and others) on 1x1 to 1080x1920 frames of noise, flat colour,
    the repository's JPEG frames decoded, and gray images.
(b) `encode_png` reads back pixel for pixel through the port's decoder and `cv2.imdecode`;
    `imwrite` picks the format by extension and refuses others.
(c) `AviWriter`: the port's `AviReader` and `cv2.VideoCapture` read the same frame count,
    fps and size; the packets are `encode_jpeg` of the frames, and VideoCapture's frames are
    the port's FFmpeg-exact decode of them.
(d) `line`, `rectangle`, `polylines`, `circle`, `add_weighted` equal cv2's bit for bit under
    hypothesis, coordinates outside the image and negative ones included, thickness 1-4,
    filled shapes, zero-area boxes, fixed-point polylines at shifts 0-16.
(e) `put_text` equals OpenCV 4.13's Hershey renderings in `tests/data/hershey/` (written
    by `tools/torch_port_hershey.py` on a machine with OpenCV 4.13): OpenCV 5.0 here draws
    TrueType text, so it is no reference for the text.
(f) `find_contours_external` and `contour_area` equal `cv2.findContours(RETR_EXTERNAL,
    CHAIN_APPROX_SIMPLE)` and `cv2.contourArea`: order, start points, orientation, runs.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sar_yolo_tpu_torch.data import cv
from sar_yolo_tpu_torch.data.avi import AviReader, AviWriter
from sar_yolo_tpu_torch.data.imageio import (decode_jpeg, decode_mjpeg_frame, decode_png,
                                             encode_jpeg, encode_png, imwrite)

DATA = Path(__file__).parent / "data"
FRAMES = sorted((DATA / "jpeg" / "frames").glob("*.jpg"))
SIZES = [(1, 1), (7, 9), (17, 33), (720, 1280), (1080, 1920)]
HYP = settings(max_examples=300, deadline=None, derandomize=True)


def _image(kind: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "flat":
        return np.full((h, w, 3), (10, 200, 77), np.uint8)
    if kind == "natural":  # the fixture frames decoded, tiled or cropped to size
        src = cv2.imread(str(FRAMES[seed % len(FRAMES)]))
        reps = (-(-h // src.shape[0]), -(-w // src.shape[1]), 1)
        return np.ascontiguousarray(np.tile(src, reps)[:h, :w])
    return rng.integers(0, 256, (h, w), dtype=np.uint8)  # gray


# ---- (a) JPEG ---------------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["noise", "flat", "natural", "gray"])
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_encode_jpeg_is_cv2_imencode(kind, size):
    img = _image(kind, *size)
    assert encode_jpeg(img) == cv2.imencode(".jpg", img)[1].tobytes()


@pytest.mark.parametrize("quality", [1, 10, 50, 75, 90, 100])
def test_encode_jpeg_quality_and_odd_sizes(quality):
    for i, (h, w) in enumerate([(15, 17), (16, 16), (9, 7), (33, 1), (1, 40), (31, 49)]):
        for kind in ("noise", "natural", "gray"):
            img = _image(kind, h, w, seed=i)
            want = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
            assert encode_jpeg(img, quality) == want, (h, w, kind)


def test_encode_jpeg_header_and_refusals():
    data = encode_jpeg(_image("noise", 8, 8))
    assert data[:20] == bytes.fromhex("ffd8ffe000104a46494600010100000100010000")
    np.testing.assert_array_equal(decode_jpeg(data), cv2.imdecode(np.frombuffer(data, np.uint8),
                                                                  cv2.IMREAD_COLOR))
    strided = _image("noise", 20, 30)[::2, ::3]  # a view: encoded as its contiguous copy
    assert encode_jpeg(strided) == cv2.imencode(".jpg", np.ascontiguousarray(strided))[1].tobytes()
    for bad in (np.zeros((4, 4, 3), np.float32), np.zeros((4, 4, 4), np.uint8)):
        with pytest.raises(ValueError):
            encode_jpeg(bad)


# ---- (b) PNG and imwrite ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["noise", "natural", "gray"])
def test_encode_png_round_trips(kind):
    img = _image(kind, 37, 53)
    data = encode_png(img)
    want = img if img.ndim == 3 else np.repeat(img[..., None], 3, 2)
    np.testing.assert_array_equal(decode_png(data), want)
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED),
                                  img)


def test_imwrite_by_extension(tmp_path):
    img = _image("natural", 48, 64)
    for name in ("a.jpg", "b.JPEG", "c.png"):
        assert imwrite(tmp_path / name, img)
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / name)),
                                      cv2.imdecode(np.frombuffer(
                                          cv2.imencode(Path(name).suffix, img)[1], np.uint8), 1))
    assert (tmp_path / "a.jpg").read_bytes() == cv2.imencode(".jpg", img)[1].tobytes()
    for name in ("d.bmp", "e.webp", "f"):
        with pytest.raises(NotImplementedError, match=Path(name).suffix or "extensionless"):
            imwrite(tmp_path / name, img)


# ---- (c) AVI ----------------------------------------------------------------------------------

@pytest.mark.parametrize("fps,size", [(25, (64, 48)), (29.97, (96, 64)), (7.5, (16, 16))])
def test_avi_writer_reads_back(tmp_path, fps, size):
    w, h = size
    frames = [_image("natural", h, w, seed=i) for i in range(5)]
    path = tmp_path / "clip.avi"
    with AviWriter(path, fps, size) as writer:
        for f in frames:
            writer.write(f)
    reader = AviReader(path)
    packets = list(reader.packets())
    assert (reader.frame_count, len(packets), reader.fourcc) == (5, 5, "MJPG")
    assert reader.fps == pytest.approx(fps, rel=1e-9)
    assert packets == [encode_jpeg(f) for f in frames]
    cap = cv2.VideoCapture(str(path))
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 5
    assert cap.get(cv2.CAP_PROP_FPS) == pytest.approx(fps, rel=1e-6)
    assert (cap.get(cv2.CAP_PROP_FRAME_WIDTH), cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == size
    for packet in packets:
        ok, frame = cap.read()
        assert ok
        np.testing.assert_array_equal(frame, decode_mjpeg_frame(packet))
    assert not cap.read()[0]
    with pytest.raises(ValueError, match="for a"):
        with AviWriter(tmp_path / "bad.avi", fps, size) as writer:
            writer.write(np.zeros((h + 2, w, 3), np.uint8))


# ---- (d) drawing ------------------------------------------------------------------------------

coord = st.integers(-40, 90)
point = st.tuples(coord, coord)
shape = st.tuples(st.integers(1, 48), st.integers(1, 48))
color = st.tuples(st.integers(0, 255), st.integers(0, 255), st.integers(0, 255))


def _canvas(hw, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), dtype=np.uint8)


@HYP
@given(shape, point, point, color, st.integers(1, 4))
def test_line_matches_cv2(hw, p1, p2, c, thickness):
    img = _canvas(hw)
    np.testing.assert_array_equal(cv.line(img.copy(), p1, p2, c, thickness),
                                  cv2.line(img.copy(), p1, p2, c, thickness))


@HYP
@given(shape, point, point, color, st.sampled_from([-1, 1, 2, 3, 4]))
def test_rectangle_matches_cv2(hw, p1, p2, c, thickness):
    img = _canvas(hw)
    np.testing.assert_array_equal(cv.rectangle(img.copy(), p1, p2, c, thickness),
                                  cv2.rectangle(img.copy(), p1, p2, c, thickness))


@pytest.mark.parametrize("thickness", [1, 2, 3, 4, -1])
def test_rectangle_edges_and_zero_area(thickness):
    """Boxes over the image's edges and of zero width or height, as JAX's plot draws them
    (coordinates truncated by int())."""
    for p1, p2 in [((0, 0), (0, 0)), ((5, 5), (5, 20)), ((3, 9), (30, 9)), ((-1, -1), (64, 48)),
                   ((60, 40), (70, 60)), ((int(-0.5), int(-0.5)), (10, 10)), ((-20, 5), (-3, 9))]:
        img = _canvas((48, 64))
        np.testing.assert_array_equal(cv.rectangle(img.copy(), p1, p2, (56, 56, 255), thickness),
                                      cv2.rectangle(img.copy(), p1, p2, (56, 56, 255), thickness))


@HYP
@given(shape, st.lists(point, min_size=1, max_size=6), st.booleans(), color, st.integers(1, 4),
       st.integers(0, 16), st.integers(0, 2 ** 16 - 1))
def test_polylines_matches_cv2(hw, pts, closed, c, thickness, shift, frac):
    p = np.array(pts, np.int64) << shift
    p += (np.arange(p.size).reshape(p.shape) * frac) % (1 << shift)  # fractional parts
    p = p.astype(np.int32)
    img = _canvas(hw)
    np.testing.assert_array_equal(cv.polylines(img.copy(), [p], closed, c, thickness, shift),
                                  cv2.polylines(img.copy(), [p], closed, c, thickness,
                                                cv2.LINE_8, shift))


@HYP
@given(shape, point, st.integers(0, 30), color, st.sampled_from([-1, 1]))
def test_circle_matches_cv2(hw, center, radius, c, thickness):
    img = _canvas(hw)
    np.testing.assert_array_equal(cv.circle(img.copy(), center, radius, c, thickness),
                                  cv2.circle(img.copy(), center, radius, c, thickness))


@HYP
@given(shape, st.floats(-2, 2), st.floats(-2, 2), st.floats(-50, 50), st.integers(1, 3))
def test_add_weighted_matches_cv2(hw, alpha, beta, gamma, channels):
    rng = np.random.default_rng(channels)
    a = rng.integers(0, 256, (*hw, channels), dtype=np.uint8).squeeze(-1 if channels == 1 else ())
    b = rng.integers(0, 256, a.shape, dtype=np.uint8)
    np.testing.assert_array_equal(cv.add_weighted(a, alpha, b, beta, gamma),
                                  cv2.addWeighted(a, alpha, b, beta, gamma))


def test_add_weighted_plot_blend_exhaustive():
    """Every (image, overlay) byte pair of plot's mask blend, 0.6 and 0.4."""
    a, b = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8))
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    np.testing.assert_array_equal(cv.add_weighted(a, 0.6, b, 0.4, 0),
                                  cv2.addWeighted(a, 0.6, b, 0.4, 0))


def test_drawing_refusals():
    img = _canvas((8, 8))
    with pytest.raises(ValueError):
        cv.line(img, (0, 0), (4, 4), (1, 2, 3), 0)
    with pytest.raises(NotImplementedError, match="thicker"):
        cv.circle(img, (4, 4), 3, (1, 2, 3), 2)
    with pytest.raises(ValueError):
        cv.add_weighted(img, 0.5, img[:4], 0.5, 0)


# ---- (e) text ---------------------------------------------------------------------------------

LABELS = np.load(DATA / "hershey" / "labels_cv2_4_13.npz")


@pytest.mark.parametrize("text", sorted(set(LABELS["texts"].tolist())))
def test_put_text_matches_opencv_4_hershey(text):
    rows = np.flatnonzero(LABELS["texts"] == text)
    assert len(rows) >= 12
    for i in rows:
        img = np.zeros(LABELS["images"].shape[1:], np.uint8)
        img[::7] = 17  # the tool's background
        got = cv.put_text(img, text, tuple(LABELS["origins"][i]), float(LABELS["scales"][i]),
                          tuple(int(v) for v in LABELS["colors"][i]), int(LABELS["thicknesses"][i]))
        np.testing.assert_array_equal(got, LABELS["images"][i], err_msg=f"case {i}")


def test_put_text_maps_other_bytes_to_question_marks():
    a = cv.put_text(np.zeros((30, 120, 3), np.uint8), "é\tx", (2, 20), 0.5, (255, 0, 0))
    b = cv.put_text(np.zeros((30, 120, 3), np.uint8), "???x", (2, 20), 0.5, (255, 0, 0))
    np.testing.assert_array_equal(a, b)
    assert a.any()


# ---- (f) contours -----------------------------------------------------------------------------

def _same_contours(mask):
    want = cv2.findContours(mask.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]
    got = cv.find_contours_external(mask)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w.reshape(-1, 2))
        assert cv.contour_area(g) == cv2.contourArea(w)


def _blank(h=20, w=24):
    return np.zeros((h, w), np.uint8)


def _cases():
    out = {"empty": _blank(), "full": np.ones((9, 7), np.uint8), "one_pixel": _blank(),
           "one_row": _blank(), "one_column": _blank(), "corner_pixel": _blank(),
           "border_rect": _blank(), "hole": _blank(), "inside_hole": _blank(),
           "equal_areas": _blank(), "diagonal": _blank(), "value_255": _blank()}
    out["one_pixel"][5, 6] = 1
    out["one_row"][7, 2:19] = 1
    out["one_column"][1:18, 3] = 1
    out["corner_pixel"][0, 0] = out["corner_pixel"][19, 23] = 1
    out["border_rect"][:, 10:24] = 1
    out["hole"][2:15, 3:20] = 1
    out["hole"][5:9, 6:12] = 0
    out["inside_hole"][:] = out["hole"]
    out["inside_hole"][6:8, 8:10] = 1
    out["equal_areas"][2:6, 2:6] = out["equal_areas"][10:14, 12:16] = 1
    out["equal_areas"][2:6, 15:19] = 1
    np.fill_diagonal(out["diagonal"], 1)
    out["value_255"][3:9, 4:11] = 255
    return out


@pytest.mark.parametrize("name", sorted(_cases()))
def test_contours_named_cases(name):
    _same_contours(_cases()[name])


@HYP
@given(st.integers(1, 40), st.integers(1, 40), st.floats(0.05, 0.95), st.integers(0, 2 ** 31))
def test_contours_random_masks(h, w, density, seed):
    rng = np.random.default_rng(seed)
    _same_contours((rng.random((h, w)) < density).astype(np.uint8))


@HYP
@given(st.lists(st.tuples(st.integers(-5, 60), st.integers(-5, 60), st.integers(0, 25)),
                max_size=6))
def test_contours_of_disks(disks):
    mask = np.zeros((64, 64), np.uint8)
    for x, y, r in disks:
        cv2.circle(mask, (x, y), r, 1, -1)
        cv2.circle(mask, (x, y), r // 3, 0, -1)  # a hole, ignored by RETR_EXTERNAL
    _same_contours(mask)


def test_contours_of_a_sam_sized_mask():
    mask = np.zeros((1024, 1024), np.uint8)
    cv2.ellipse(mask, (500, 520), (300, 180), 30, 0, 360, 1, -1)
    cv2.circle(mask, (900, 100), 60, 1, -1)
    mask[600:700, 100:300] = 1
    _same_contours(mask)
