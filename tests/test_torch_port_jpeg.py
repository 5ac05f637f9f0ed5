"""The port's JPEG decoder (`csrc/jpeg_decode.c` behind `data/imageio.py`) against
`cv2.imread` (OpenCV 5.0 on libjpeg-turbo 3.1) and the JAX package's dataset.

Tolerance: none. Every decoded file equals `cv2.imread`'s pixels exactly (largest
difference 0): files that `cv2.imencode` wrote with each of the five sampling factors
(4:4:4, 4:2:2, 4:2:0, 4:1:1, 4:4:0) at 1x1, 7x13, 37x53 and 720x1280, qualities 10, 75
and 100 (optimized Huffman tables at 10 and 100), restart intervals, gray; an Exif
APP1 spliced in for each orientation 1-8 in both byte orders; Adobe RGB and
component-id RGB files; SOF1; a file without DHT segments; files cut short (libjpeg
pads the missing data, and the rest of the image is grey); corrupt files (None exactly
where OpenCV gives None, also on 200 randomly corrupted files); the committed fixtures under `tests/data/jpeg/`, whose
pixel digests `tools/torch_port_jpeg_fixtures.py` took with cv2. Progressive,
arithmetic-coded, 12-bit, lossless and CMYK files raise NotImplementedError; files
OpenCV cannot read give None. `YOLODataset` items of a JPEG folder (train with mosaic,
rect val) equal the JAX package's bit for bit, and threads decode in parallel to the
same pixels.
"""

import hashlib
import json
import struct
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from sar_yolo_tpu.cfg import get_cfg as jax_get_cfg
from sar_yolo_tpu.data import dataset as jax_dataset
from sar_yolo_tpu_torch.cfg.default import get_cfg
from sar_yolo_tpu_torch.data.dataset import YOLODataset
from sar_yolo_tpu_torch.data.imageio import decode_jpeg, imread
from torch_port_common import one_torch_thread  # noqa: F401 (autouse fixture)

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
SAMPLING = {s: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{s}")
            for s in ("444", "422", "420", "411", "440")}
SIZES = [(1, 1), (7, 13), (37, 53), (720, 1280)]
QUALITY = [(10, 1), (75, 0), (100, 1)]  # (quality, optimized Huffman tables)


def _smooth(seed: int, h: int, w: int) -> np.ndarray:
    """Coarse colour cells, resized smooth, with some noise: real AC content."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (max(h // 8, 1), max(w // 8, 1), 3), dtype=np.uint8)
    img = cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)
    return np.clip(img.astype(int) + rng.integers(-20, 21, img.shape), 0, 255).astype(np.uint8)


def _encode(img, **params) -> bytes:
    flat = []
    for key, val in params.items():
        flat += [getattr(cv2, f"IMWRITE_JPEG_{key.upper()}"), val]
    return cv2.imencode(".jpg", img, flat)[1].tobytes()


def _assert_same_as_cv2(tmp_path, data: bytes, name: str = "x.jpg"):
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path))
    got = imread(path)
    if want is None:
        assert got is None
        return
    assert got is not None and got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quality,optimize", QUALITY, ids=lambda v: str(v))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_decoder_matches_cv2_imread(sampling, size, quality, optimize, tmp_path):
    data = _encode(_smooth(sum(size) + quality, *size), quality=quality, optimize=optimize,
                   sampling_factor=SAMPLING[sampling])
    _assert_same_as_cv2(tmp_path, data)


@pytest.mark.parametrize("interval", [1, 3])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_restart_intervals_match_cv2(sampling, interval, tmp_path):
    data = _encode(_smooth(interval, 45, 70), sampling_factor=SAMPLING[sampling],
                   rst_interval=interval)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    _assert_same_as_cv2(tmp_path, data)


@pytest.mark.parametrize("size", SIZES[:3], ids=lambda s: f"{s[0]}x{s[1]}")
def test_gray_matches_cv2(size, tmp_path):
    img = _smooth(3, *size)[..., 1]
    for quality in (10, 90):
        _assert_same_as_cv2(tmp_path, _encode(img, quality=quality, rst_interval=2))


def _exif_app1(orientation: int, order: bytes) -> bytes:
    e = "<" if order == b"II" else ">"
    tiff = (order + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 2)
            + struct.pack(e + "HHII", 0x010F, 2, 4, 0)  # Make: an entry before the tag
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("order", [b"II", b"MM"], ids=["little", "big"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_cv2(orientation, order, tmp_path):
    base = _encode(_smooth(orientation, 21, 34), sampling_factor=SAMPLING["420"])
    _assert_same_as_cv2(tmp_path, base[:2] + _exif_app1(orientation, order) + base[2:])


def _without_jfif(data: bytes) -> bytes:
    assert data[2:4] == b"\xff\xe0"
    return data[:2] + data[4 + struct.unpack(">H", data[4:6])[0]:]


def _adobe(transform: int) -> bytes:
    return b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + bytes([0, 100, 0, 0, 0, 0, transform])


def _rgb_ids(data: bytes) -> bytes:
    b = bytearray(data)
    sof, sos = b.index(b"\xff\xc0"), b.index(b"\xff\xda")
    for k in range(3):
        b[sof + 10 + 3 * k] = b[sos + 5 + 2 * k] = b"RGB"[k]
    return bytes(b)


def _without_dht(data: bytes) -> bytes:
    out, p = data[:2], 2
    while data[p + 1] != 0xDA:
        n = struct.unpack(">H", data[p + 2:p + 4])[0]
        if data[p + 1] != 0xC4:
            out += data[p:p + 2 + n]
        p += 2 + n
    return out + data[p:]


@pytest.mark.parametrize("kind", ["adobe_rgb", "adobe_ycc", "jfif_and_adobe_rgb", "no_marker",
                                  "rgb_ids", "sof1", "no_dht"])
def test_markers_match_cv2(kind, tmp_path):
    """libjpeg's choice of colour space: JFIF means YCbCr, else the Adobe transform, else
    component ids 'R', 'G', 'B' mean RGB; SOF1 decodes as SOF0; a file without DHT (a
    Motion-JPEG frame) decodes with the standard's tables."""
    base = _encode(_smooth(5, 37, 53), sampling_factor=SAMPLING["422"])
    bare = _without_jfif(base)
    data = {"adobe_rgb": bare[:2] + _adobe(0) + bare[2:], "adobe_ycc": bare[:2] + _adobe(1) + bare[2:],
            "jfif_and_adobe_rgb": base[:2] + _adobe(0) + base[2:], "no_marker": bare,
            "rgb_ids": _rgb_ids(bare),
            "sof1": base.replace(b"\xff\xc0", b"\xff\xc1", 1), "no_dht": _without_dht(base)}[kind]
    assert (b"\xff\xc4" in data) == (kind != "no_dht")
    _assert_same_as_cv2(tmp_path, data)


@pytest.mark.parametrize("fraction", [0.2, 0.5, 0.9])
@pytest.mark.parametrize("sampling,interval", [("420", 0), ("444", 0), ("420", 2), ("422", 5)])
def test_file_cut_short_matches_cv2(sampling, interval, fraction, tmp_path):
    """libjpeg's source manager ends a short file with a fake EOI; the Huffman decoder
    pads zero bits, the MCUs after the one that ran out stay zero (grey)."""
    data = _encode(_smooth(7, 96, 160), sampling_factor=SAMPLING[sampling], rst_interval=interval)
    _assert_same_as_cv2(tmp_path, data[:int(len(data) * fraction)])


def test_corrupt_files_match_cv2(tmp_path):
    """Files OpenCV cannot read give None (cut inside the headers, no frame, no data, no
    quantisation table); a DHT marker broken into FF 00 is skipped as garbage, and the
    scan decodes with the standard's tables, as libjpeg-turbo does."""
    data = _encode(_smooth(8, 30, 40))
    sos = data.index(b"\xff\xda")
    dqt = data.index(b"\xff\xdb")
    no_dqt = data[:dqt] + data[dqt + 2 + struct.unpack(">H", data[dqt + 2:dqt + 4])[0]:]
    for i, (bad, none) in enumerate([(data[:sos - 20], True), (b"\xff\xd8\xff\xd9", True),
                                     (data[:2] + bytes(100), True), (no_dqt, True),
                                     (data.replace(b"\xff\xc4", b"\xff\x00", 1), False)]):
        _assert_same_as_cv2(tmp_path, bad, f"bad{i}.jpg")
        assert (imread(tmp_path / f"bad{i}.jpg") is None) == none, i


def test_randomly_corrupted_files_give_none_where_cv2_does(tmp_path):
    """Bytes set, cut and inserted at random in 200 files: `imread` gives None exactly
    where `cv2.imread` does. (Their pixels, where both decode, are not held: on corrupt
    coefficients libjpeg-turbo's SIMD IDCT wraps its 16-bit products where its C
    reference, which the decoder follows, does not.)"""
    rng = np.random.default_rng(12)
    agree = 0
    for i in range(200):
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        sampling = list(SAMPLING.values())[i % 5]
        data = bytearray(_encode(_smooth(i, h, w), sampling_factor=sampling, rst_interval=i % 3))
        for _ in range(int(rng.integers(1, 4))):
            kind, at = int(rng.integers(0, 3)), int(rng.integers(2, max(len(data), 3)))
            if kind == 0:
                data[at % len(data)] = int(rng.integers(0, 256))
            elif kind == 1:
                data = data[:at]
            else:
                data[at:at] = rng.integers(0, 256, int(rng.integers(1, 20)), np.uint8).tobytes()
        path = tmp_path / f"c{i}.jpg"
        path.write_bytes(bytes(data))
        want = cv2.imread(str(path))
        try:
            got = imread(path)
        except NotImplementedError:  # a corrupted SOF byte can name a kind the port refuses
            continue
        assert (got is None) == (want is None), f"file {i}"
        agree += got is None
    assert agree > 20


def test_unsupported_kinds_raise(tmp_path):
    img = _smooth(9, 30, 40)
    base = _encode(img)
    kinds = {
        "progressive": _encode(img, progressive=1),
        "arithmetic-coded": base.replace(b"\xff\xc0", b"\xff\xc9", 1),
        "lossless": base.replace(b"\xff\xc0", b"\xff\xc3", 1),
        "12-bit": base.replace(b"\xff\xc0\x00\x11\x08", b"\xff\xc0\x00\x11\x0c", 1),
    }
    Image.fromarray(img).convert("CMYK").save(tmp_path / "cmyk.jpg")
    kinds["four-component"] = (tmp_path / "cmyk.jpg").read_bytes()
    for what, data in kinds.items():
        (tmp_path / "u.jpg").write_bytes(data)
        with pytest.raises(NotImplementedError, match=what):
            imread(tmp_path / "u.jpg")


def _fixtures():
    digests = json.loads((FIXTURES / "digests.json").read_text())
    return [(group, name, entry) for group in ("variants", "frames")
            for name, entry in digests[group].items()]


@pytest.mark.parametrize("group,name,entry", _fixtures(), ids=lambda v: v if isinstance(v, str) else "")
def test_committed_fixtures_match_their_digests(group, name, entry):
    path = FIXTURES / group / name
    if "raises" in entry:
        with pytest.raises(NotImplementedError):
            imread(path)
        return
    got = imread(path)
    assert list(got.shape) == entry["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    np.testing.assert_array_equal(got, cv2.imread(str(path)))


def test_threads_decode_the_same_pixels():
    paths = sorted((FIXTURES / "frames").glob("*.jpg"))
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(imread, paths))
    for path, img in zip(paths, got):
        np.testing.assert_array_equal(img, decode_jpeg(path.read_bytes()))


@pytest.fixture(scope="module")
def jpeg_dataset(tmp_path_factory):
    """A JDE dataset of JPEG frames of three shapes and both chroma subsamplings."""
    root = tmp_path_factory.mktemp("jpeg_data")
    rng = np.random.default_rng(11)
    shapes = [(90, 160), (160, 90), (72, 128)]
    for split, n in (("train", 9), ("val", 6)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            sampling = SAMPLING["420" if i % 2 else "444"]
            data = _encode(_smooth(100 * n + i, *shapes[i % 3]), quality=85, sampling_factor=sampling)
            (root / "images" / split / f"{i:03d}.jpg").write_bytes(data)
            rows = [f"0 {rng.uniform(.15, .85):.6f} {rng.uniform(.15, .85):.6f} "
                    f"{rng.uniform(.05, .3):.6f} {rng.uniform(.05, .3):.6f} {rng.integers(0, 9)}"
                    for _ in range(int(rng.integers(1, 6)))]
            (root / "labels" / split / f"{i:03d}.txt").write_text("\n".join(rows) + "\n")
    return root


@pytest.mark.parametrize("split", ["train", "val"])
def test_yolo_dataset_of_jpeg_frames_matches_jax(jpeg_dataset, split):
    kw = dict(imgsz=64, use_tags=True, max_labels=16, task="jde", augment=split == "train")
    path = str(jpeg_dataset / "images" / split)
    got = YOLODataset(path, hyp=get_cfg({"seed": 3}), **kw)
    want = jax_dataset.YOLODataset(path, hyp=jax_get_cfg(overrides={"seed": 3}), **kw)
    if split == "val":
        got.init_rect(4)
        want.init_rect(4)
        assert got.batch_shapes == want.batch_shapes
    assert got.im_files == want.im_files and len(got) == len(want) > 0
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"item {i} {k}")
