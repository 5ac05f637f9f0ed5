"""The data path of the PyTorch port against the JAX package and OpenCV.

(a) images: the PNG decoder equals `cv2.imread` exactly on files that OpenCV and
PIL wrote (gray, gray + alpha, palette with 1-8 bits, RGB, RGBA, 16-bit, each of the
five row filters); header shapes equal those of the JAX package's PIL reader for
PNG, JPEG (baseline and progressive) and BMP, corrupt files included; other formats
and progressive JPEG pixels raise (the JPEG decoder is held in `test_torch_port_jpeg.py`);
(b) the dataset YAML reader equals PyYAML on every file of
`sar_yolo_tpu/cfg/datasets/`;
(c) `data/cv.py` equals OpenCV 8-bit results bit for bit: resize (upscale,
downscale, exactly 2x), warpAffine, BGR <-> HSV and copyMakeBorder (the HSV
jitter's LUTs are held in (d));
(d) each augmentation against the JAX package's on the same numpy generator:
images equal, boxes within 1e-4 px, tags and classes equal;
(e) `YOLODataset` item by item (val, train with mosaic at two (seed, epoch) pairs,
train after close_mosaic, rect batches, a JPEG dataset decoded and from `.npy` sidecars): every
array equal; the label cache drops the same files and each package reads the
cache the other wrote; `set_epoch` reaches the dataset;
(f) refusals: perspective and mosaic9; the route: the hyperparameters the device
augmentation can express take it, others asked for with device_augment=True warn and
take the host augmentation;
(g) tinyjde trained 2 epochs (close_mosaic=1) on a dataset folder, from the same
weights in both packages: the same batches bit for bit and loss items within the
tolerance of `test_torch_port_train.py`.
"""

import glob
import shutil

import cv2
import numpy as np
import pytest
import yaml
from PIL import Image

from sar_yolo_tpu.cfg import get_cfg as jax_get_cfg
from sar_yolo_tpu.data import augment as jax_augment
from sar_yolo_tpu.data import dataset as jax_dataset
from sar_yolo_tpu.data.build import DataLoader as JaxDataLoader
from sar_yolo_tpu.utils import ROOT as JAX_ROOT
from sar_yolo_tpu_torch.cfg.default import get_cfg
from sar_yolo_tpu_torch.data import augment, cv, imageio
from sar_yolo_tpu_torch.data import dataset as port_dataset
from sar_yolo_tpu_torch.data.build import DataLoader
from sar_yolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset
from sar_yolo_tpu_torch.engine.trainer import JDETrainer
from sar_yolo_tpu_torch.utils.dataset_yaml import load_yaml
from torch_port_common import jax_jde_trainer, one_torch_thread, port_trainer_like  # noqa: F401

BOX_ATOL = 1e-4  # px


def _smooth(rng, h, w, c=3):
    """A smooth image with noise (so that PNG encoders pick varied row filters)."""
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, c)).astype(np.uint8)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC).reshape(h, w, c)
    return np.clip(img.astype(int) + rng.integers(-9, 9, (h, w, c)), 0, 255).astype(np.uint8)


def _png_filters(path) -> set:
    import zlib
    data = open(path, "rb").read()
    chunks = list(imageio._png_chunks(data))
    w, h, depth, ctype, _ = imageio._png_header(chunks)
    raw = zlib.decompress(b"".join(b for t, b in chunks if t == b"IDAT"))
    row = (w * depth * imageio._PNG_CHANNELS[ctype] + 7) // 8
    return {raw[i * (row + 1)] for i in range(h)}


# ---- (a) images ------------------------------------------------------------------------------

_H, _W = 37, 53
PNG_WRITERS = {
    "cv2 bgr": lambda p, r: cv2.imwrite(p, _smooth(r, _H, _W)),
    "cv2 bgra": lambda p, r: cv2.imwrite(p, _smooth(r, _H, _W, 4)),
    "cv2 gray": lambda p, r: cv2.imwrite(p, _smooth(r, _H, _W, 1)[..., 0]),
    "cv2 bgr 16-bit": lambda p, r: cv2.imwrite(p, r.integers(0, 65536, (_H, _W, 3)).astype(np.uint16)),
    "cv2 bgra 16-bit": lambda p, r: cv2.imwrite(p, r.integers(0, 65536, (_H, _W, 4)).astype(np.uint16)),
    "cv2 gray 16-bit": lambda p, r: cv2.imwrite(p, r.integers(0, 65536, (_H, _W)).astype(np.uint16)),
    "cv2 bilevel": lambda p, r: cv2.imwrite(p, (_smooth(r, _H, _W, 1)[..., 0] > 128).astype(np.uint8)
                                            * 255, [cv2.IMWRITE_PNG_BILEVEL, 1]),
    "PIL RGB": lambda p, r: Image.fromarray(_smooth(r, _H, _W)).save(p),
    "PIL RGBA": lambda p, r: Image.fromarray(_smooth(r, _H, _W, 4)).save(p),
    "PIL L": lambda p, r: Image.fromarray(_smooth(r, _H, _W, 1)[..., 0]).save(p),
    "PIL LA": lambda p, r: Image.fromarray(_smooth(r, _H, _W, 2)).save(p),
    "PIL 1-bit": lambda p, r: Image.fromarray(_smooth(r, _H, _W, 1)[..., 0] > 128).save(p),
    "PIL I;16": lambda p, r: Image.fromarray(r.integers(0, 65536, (_H, _W)).astype(np.uint16)).save(p),
    "PIL palette 8-bit": lambda p, r: Image.fromarray(_smooth(r, _H, _W)).quantize(200).save(p),
    "PIL palette 4-bit": lambda p, r: Image.fromarray(_smooth(r, _H, _W)).quantize(16).save(p, bits=4),
    "PIL palette 2-bit": lambda p, r: Image.fromarray(_smooth(r, _H, _W)).quantize(4).save(p, bits=2),
    "PIL palette + tRNS": lambda p, r: Image.fromarray(_smooth(r, _H, _W, 4)).quantize(100).save(
        p, transparency=3),
}


@pytest.mark.parametrize("writer", list(PNG_WRITERS))
def test_png_decoder_matches_cv2_imread(writer, tmp_path):
    path = str(tmp_path / "a.png")
    PNG_WRITERS[writer](path, np.random.default_rng(len(writer)))
    want = cv2.imread(path)
    got = imageio.imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert imageio.image_shape(path) == jax_dataset._image_shape(path) == want.shape[:2]


def test_png_decoder_meets_every_row_filter(tmp_path):
    rng = np.random.default_rng(0)
    seen = set()
    for name in ("NONE", "SUB", "UP", "AVG", "PAETH"):
        path = str(tmp_path / f"{name}.png")
        img = _smooth(rng, 61, 97)
        cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, getattr(cv2, f"IMWRITE_PNG_FILTER_{name}")])
        seen |= _png_filters(path)
        np.testing.assert_array_equal(imageio.imread(path), img)
    assert seen == {0, 1, 2, 3, 4}


def test_image_shapes_and_corrupt_files_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    img = _smooth(rng, 45, 70)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    cv2.imwrite(str(tmp_path / "b.jpg"), img)
    Image.fromarray(img).save(tmp_path / "c.jpg", progressive=True, quality=80)
    cv2.imwrite(str(tmp_path / "d.bmp"), img)
    Image.fromarray(img[..., 0]).save(tmp_path / "e.bmp")
    png = (tmp_path / "a.png").read_bytes()
    (tmp_path / "f_truncated.png").write_bytes(png[:len(png) // 2])
    bad_crc = bytearray(png)
    bad_crc[40] ^= 0xFF
    (tmp_path / "g_crc.png").write_bytes(bytes(bad_crc))
    (tmp_path / "h_garbage.jpg").write_bytes(rng.integers(0, 256, 500, np.uint8).tobytes())
    (tmp_path / "i_header_only.jpg").write_bytes(b"\xff\xd8\xff\xd9")
    shapes = {}
    for path in sorted(tmp_path.iterdir()):
        shapes[path.name] = imageio.image_shape(path)
        assert shapes[path.name] == jax_dataset._image_shape(path), path.name
    assert [shapes[n] for n in ("a.png", "b.jpg", "c.jpg", "d.bmp", "e.bmp")] == [(45, 70)] * 5
    assert [shapes[n] for n in ("f_truncated.png", "g_crc.png", "h_garbage.jpg",
                                "i_header_only.jpg")] == [None] * 4
    assert imageio.imread(tmp_path / "f_truncated.png") is None


def test_formats_not_decoded_raise(tmp_path):
    img = _smooth(np.random.default_rng(2), 20, 30)
    for name in ("a.tif", "a.webp"):
        cv2.imwrite(str(tmp_path / name), img)
        with pytest.raises(NotImplementedError, match="TIFF|WebP"):
            imageio.image_shape(tmp_path / name)
    cv2.imwrite(str(tmp_path / "a.jpg"), img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match="progressive JPEG"):
        imageio.imread(tmp_path / "a.jpg")


# ---- (b) dataset YAML files ------------------------------------------------------------------

@pytest.mark.parametrize("path", sorted(glob.glob(str(JAX_ROOT / "cfg" / "datasets" / "*.yaml"))),
                         ids=lambda p: p.rsplit("/", 1)[-1])
def test_dataset_yaml_reader_matches_pyyaml(path):
    assert load_yaml(path) == yaml.safe_load(open(path))


def test_dataset_yaml_reader_skips_block_scalars(tmp_path):
    path = tmp_path / "d.yaml"
    path.write_text("path: ../d  # root\ntrain: [a,\n  'b c']\nval:\n  - v\ndownload: |\n"
                    "  import os\n  x = {'a': 1}\nnames:\n  0: person # id\n  1: 'it''s'\n")
    want = yaml.safe_load(path.read_text())
    del want["download"]
    assert load_yaml(path) == want


# ---- (c) the OpenCV operations ---------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((720, 1280), (360, 640)), ((100, 150), (222, 333)),
                                     ((97, 131), (43, 64)), ((35, 61), (9, 17)),
                                     ((360, 640), (216, 384)), ((48, 80), (96, 160)),
                                     ((5, 3), (11, 7))],
                         ids=["2x 1280x720->640x360", "up", "down", "down-odd", "down-0.6",
                              "up-2x", "tiny"])
def test_resize_matches_cv2(src, dst):
    img = _smooth(np.random.default_rng(sum(src)), *src)
    np.testing.assert_array_equal(cv.resize(img, dst[::-1]),
                                  cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("seed", range(4))
def test_warp_affine_matches_cv2(seed):
    rng = np.random.default_rng(seed)
    h0, w0 = (int(v) for v in rng.integers(40, 200, 2))
    w, h = int(rng.integers(20, 150)), int(rng.integers(20, 150))  # odd widths: the scalar tail
    img = _smooth(rng, h0, w0)
    M = cv2.getRotationMatrix2D((rng.uniform(0, w0), rng.uniform(0, h0)), rng.uniform(-30, 30),
                                rng.uniform(0.4, 1.8))
    M[0, 1] += rng.uniform(-0.2, 0.2)
    M[:, 2] += rng.uniform(-40, 40, 2)
    np.testing.assert_array_equal(cv.warp_affine(img, M, (w, h)),
                                  cv2.warpAffine(img, M, dsize=(w, h), borderValue=(114, 114, 114)))


def test_hsv_conversions_match_cv2():
    every = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij"),
                     -1).astype(np.uint8)
    for hsv in (every.reshape(180 * 256, 256, 3), every.reshape(-1, 1, 3),
                every[:7, :9].reshape(63, 256, 3)[:, :77]):  # SIMD blocks and the scalar tail
        np.testing.assert_array_equal(cv.hsv2bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))
    bgr = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij"),
                   -1).astype(np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(cv.bgr2hsv(bgr), cv2.cvtColor(bgr, cv2.COLOR_BGR2HSV))


def test_border_matches_cv2():
    img = _smooth(np.random.default_rng(3), 20, 31)
    np.testing.assert_array_equal(cv.copy_make_border(img, 1, 2, 3, 4),
                                  cv2.copyMakeBorder(img, 1, 2, 3, 4, cv2.BORDER_CONSTANT,
                                                     value=(114, 114, 114)))


# ---- (d) the augmentations -------------------------------------------------------------------

def _labels(rng, h, w, n=6):
    x1, y1 = rng.uniform(0, w * 0.8, n), rng.uniform(0, h * 0.8, n)
    bw, bh = rng.uniform(3, w * 0.3, n), rng.uniform(3, h * 0.3, n)
    return {"img": _smooth(rng, h, w), "cls": rng.integers(0, 3, n).astype(np.float32),
            "bboxes": np.stack([x1, y1, np.minimum(x1 + bw, w), np.minimum(y1 + bh, h)],
                               1).astype(np.float32),
            "tags": rng.integers(0, 9, n).astype(np.float32)}


def _assert_same_labels(got: dict, want: dict):
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["img"], want["img"])
    np.testing.assert_allclose(got["bboxes"], want["bboxes"], rtol=0, atol=BOX_ATOL)
    for k in ("cls", "tags"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("shape,new,scaleup", [((45, 70), 64, True), ((70, 45), (96, 64), False),
                                               ((100, 100), 64, False), ((30, 50), 64, False)])
def test_letterbox_matches_jax(shape, new, scaleup):
    img = _smooth(np.random.default_rng(0), *shape)
    g, w = augment.letterbox(img, new, scaleup=scaleup), jax_augment.letterbox(img, new,
                                                                                scaleup=scaleup)
    np.testing.assert_array_equal(g[0], w[0])
    assert g[1:] == w[1:]


@pytest.mark.parametrize("params", [dict(), dict(degrees=10.0, shear=5.0, translate=0.2),
                                    dict(border=(-32, -32), scale=0.9)],
                         ids=["defaults", "rotate-shear", "mosaic-border"])
def test_random_perspective_matches_jax(params):
    rng = np.random.default_rng(4)
    item = _labels(rng, 128, 128, n=12)
    got = augment.random_perspective({k: v.copy() for k, v in item.items()},
                                     rng=np.random.default_rng(9), **params)
    want = jax_augment.random_perspective({k: v.copy() for k, v in item.items()},
                                          rng=np.random.default_rng(9), **params)
    _assert_same_labels(got, want)
    assert 0 < len(got["bboxes"])


def test_mosaic_copy_paste_mixup_hsv_flip_match_jax():
    rng = np.random.default_rng(5)
    items = [_labels(rng, int(rng.integers(30, 64)), 64, n=int(rng.integers(1, 6)))
             for _ in range(4)]
    out = {}
    for name, mod in (("port", augment), ("jax", jax_augment)):
        r = np.random.default_rng(11)
        it = mod.mosaic4([{k: v.copy() for k, v in x.items()} for x in items], 64, rng=r)
        it.pop("mosaic_border")
        it = mod.copy_paste(it, p=0.9, rng=r)
        it = mod.mixup(it, {k: v.copy() for k, v in items[0].items() if k != "img"} |
                       {"img": np.full_like(it["img"], 7)}, rng=r)
        img = it["img"]
        if name == "port":
            it["img"] = mod.augment_hsv(img, rng=r)
        else:
            mod.augment_hsv(img, rng=r)
        it = mod.random_flip(it, fliplr=0.5, flipud=0.5, rng=r)
        out[name] = it
    _assert_same_labels(out["port"], out["jax"])
    assert len(out["port"]["bboxes"]) > sum(len(x["bboxes"]) for x in items)  # pasted copies


def test_perspective_and_mosaic9_raise(tmp_path, dataset_dir):
    item = _labels(np.random.default_rng(6), 64, 64)
    with pytest.raises(NotImplementedError, match="perspective"):
        augment.random_perspective(item, perspective=1e-4, rng=np.random.default_rng(0))
    for key in ("perspective", "mosaic9"):
        with pytest.raises(NotImplementedError, match=key):
            YOLODataset(dataset_dir / "images" / "train", imgsz=64, augment=True,
                        hyp=get_cfg({key: 0.5}), task="jde")


# ---- (e) YOLODataset -------------------------------------------------------------------------

SHAPES = [(90, 160), (160, 90), (100, 100), (72, 128), (110, 60)]


def _write_split(root, split, n, rng):
    (root / "images" / split).mkdir(parents=True)
    (root / "labels" / split).mkdir(parents=True)
    for i in range(n):
        h, w = SHAPES[i % len(SHAPES)]
        cv2.imwrite(str(root / "images" / split / f"{i:03d}.png"), _smooth(rng, h, w))
        rows = [f"0 {rng.uniform(.15, .85):.6f} {rng.uniform(.15, .85):.6f} "
                f"{rng.uniform(.05, .3):.6f} {rng.uniform(.05, .3):.6f} {rng.integers(0, 9)}"
                for _ in range(int(rng.integers(1, 8)))]
        (root / "labels" / split / f"{i:03d}.txt").write_text("\n".join(rows) + "\n")


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """A JDE dataset folder: 16 train and 6 val PNG images of five shapes, 6-column labels,
    and a dataset YAML; its train split also holds a corrupt image, an 8 px image and an
    image whose label file does not parse."""
    root = tmp_path_factory.mktemp("jde_data")
    rng = np.random.default_rng(0)
    _write_split(root, "train", 16, rng)
    _write_split(root, "val", 6, rng)
    (root / "images" / "train" / "x_corrupt.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 40)
    cv2.imwrite(str(root / "images" / "train" / "y_tiny.png"), _smooth(rng, 8, 8))
    cv2.imwrite(str(root / "images" / "train" / "z_badlabel.png"), _smooth(rng, 40, 40))
    (root / "labels" / "train" / "z_badlabel.txt").write_text("0 0.5 0.5 zero 0.1 1\n")
    (root / "data.yaml").write_text("path: .\ntrain: images/train\nval: images/val\nnc: 1\n"
                                    "names:\n  0: person\nperson_states:\n  0: stands\n  1: seated\n")
    return root


def _kw():
    return dict(imgsz=64, use_tags=True, max_labels=16, task="jde")


def _assert_same_items(got_ds, want_ds, idx=None):
    for i in (range(len(want_ds)) if idx is None else idx):
        g, w = got_ds[i], want_ds[i]
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"item {i} {k}")


def test_check_det_dataset_matches_jax(dataset_dir):
    for data in (dataset_dir / "data.yaml", {"path": str(dataset_dir), "train": "images/train",
                                             "val": "images/val", "names": ["person"]}):
        assert check_det_dataset(data) == jax_dataset.check_det_dataset(data)


def test_label_cache_matches_jax_and_is_shared(dataset_dir, monkeypatch):
    img_dir = dataset_dir / "images" / "train"
    cache = dataset_dir / "labels" / "train.cache.npz"
    cache.unlink(missing_ok=True)
    want = jax_dataset.YOLODataset(str(img_dir), **_kw())  # writes the cache
    monkeypatch.setattr(port_dataset, "image_shape", None)  # reading the cache must not verify
    got = YOLODataset(str(img_dir), **_kw())
    kept = [p.rsplit("/", 1)[-1] for p in got.im_files]
    assert got.im_files == want.im_files and len(kept) == 16
    assert not any(n.startswith(("x_", "y_", "z_")) for n in kept)
    np.testing.assert_array_equal(got.shapes, want.shapes)
    monkeypatch.undo()
    cache.unlink()
    got = YOLODataset(str(img_dir), **_kw())  # the port writes the cache
    monkeypatch.setattr(jax_dataset, "_image_shape", None)
    want = jax_dataset.YOLODataset(str(img_dir), **_kw())
    assert got.im_files == want.im_files
    for g, w in zip(got.labels, want.labels):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def _pair(dataset_dir, split, augment, seed=0):
    jhyp = jax_get_cfg(overrides={"seed": seed})
    phyp = get_cfg({"seed": seed})
    path = str(dataset_dir / "images" / split)
    return (YOLODataset(path, augment=augment, hyp=phyp, **_kw()),
            jax_dataset.YOLODataset(path, augment=augment, hyp=jhyp, **_kw()))


@pytest.mark.parametrize("seed,epoch,mosaic", [(0, 0, True), (5, 1, True), (0, 1, False)],
                         ids=["seed0-epoch0-mosaic", "seed5-epoch1-mosaic", "close_mosaic"])
def test_train_items_match_jax(dataset_dir, seed, epoch, mosaic):
    got, want = _pair(dataset_dir, "train", True, seed)
    assert got.mosaic_enabled and want.mosaic_enabled
    got.epoch = want.epoch = epoch
    got.mosaic_enabled = want.mosaic_enabled = mosaic
    _assert_same_items(got, want)


def test_val_items_and_rect_batches_match_jax(dataset_dir):
    got, want = _pair(dataset_dir, "val", False)
    _assert_same_items(got, want)
    got.init_rect(4)
    want.init_rect(4)
    assert got.im_files == want.im_files and got.batch_shapes == want.batch_shapes
    assert len(set(got.batch_shapes)) == 2 and got.batch_shapes[0] != got.batch_shapes[1]
    np.testing.assert_array_equal(got.batch_index, want.batch_index)
    _assert_same_items(got, want)
    assert {got[i]["img"].shape[:2] for i in range(len(got))} == set(got.batch_shapes)


def test_set_epoch_reaches_the_dataset(dataset_dir):
    got, want = _pair(dataset_dir, "train", True, seed=2)
    gl = DataLoader(got, batch_size=4, workers=2, seed=3)
    wl = JaxDataLoader(want, batch_size=4, shuffle=True, workers=2, seed=3)
    first = next(iter(gl))["img"]
    gl.set_epoch(1)
    wl.set_epoch(1)
    assert got.epoch == want.epoch == 1
    for g, w in zip(gl, wl):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    assert not np.array_equal(next(iter(gl))["img"], first)


def test_npy_sidecars_of_a_jpeg_dataset(tmp_path):
    rng = np.random.default_rng(7)
    for split in ("images", "labels"):
        (tmp_path / split).mkdir()
    for i in range(4):
        cv2.imwrite(str(tmp_path / "images" / f"{i}.jpg"), _smooth(rng, *SHAPES[i]))
        (tmp_path / "labels" / f"{i}.txt").write_text(f"0 0.5 0.5 0.2 0.3 {i}\n")
    kw = dict(augment=False, **_kw())
    decoded = YOLODataset(str(tmp_path / "images"), **kw)  # the port's own JPEG decoder
    want = jax_dataset.YOLODataset(str(tmp_path / "images"), cache="disk", **kw)
    [want[i] for i in range(len(want))]  # the JAX package decodes and writes the sidecars
    assert len(list((tmp_path / "images").glob("*.npy"))) == 4
    got = YOLODataset(str(tmp_path / "images"), cache="disk", **kw)
    _assert_same_items(got, want)
    _assert_same_items(decoded, want)


def test_device_augmentation_hyperparameters_raise(dataset_dir, tmp_path, monkeypatch):
    """Nothing raises now: copy_paste=0 on a folder, and device_augment=True with
    copy_paste=0 on synthetic data, take the device route; device_augment=True where
    the hyperparameters need the host (degrees > 0) warns and takes the host route, as
    do device_augment=False and the default copy_paste."""
    from sar_yolo_tpu_torch.engine import trainer as trainer_module
    warned = []
    monkeypatch.setattr(trainer_module.LOGGER, "warning", warned.append)
    data = str(dataset_dir / "data.yaml")
    common = dict(model="tinyjde.yaml", data=data, imgsz=64, batch=4, project=str(tmp_path))
    for over, device, warns in (({"copy_paste": 0.0}, True, 0),
                                ({"data": "synthetic", "device_augment": True, "copy_paste": 0.0},
                                 True, 0),
                                ({"data": "synthetic", "copy_paste": 0.0}, False, 0),
                                ({"copy_paste": 0.0, "degrees": 5.0, "device_augment": True},
                                 False, 1),
                                ({"copy_paste": 0.0, "device_augment": False}, False, 0),
                                ({}, False, 0)):
        warned.clear()
        train, val, info = JDETrainer({**common, **over}, device="cpu").get_dataset()
        route_warnings = [w for w in warned if "device_augment" in w]
        assert train.device_augment == device and len(route_warnings) == warns, over
        assert all("host augmentation" in w for w in route_warnings)
        if "data" not in over:  # the folder: its val set, and train items of either route
            assert train.augment == (not device) and not val.augment and info["nc"] == 1
            assert info["person_states"] == {0: "stands", 1: "seated"}
            item = train[0]
            assert "ratio_pad" not in item and item["img"].shape == (64, 64, 3)


# ---- (g) training on the folder --------------------------------------------------------------

def _first_step_items_float64(ptr, batch) -> np.ndarray:
    """Loss items of the port's first step with the forward run in float64."""
    import copy

    import torch
    model = copy.deepcopy(ptr.model).double()
    b = ptr.to_device(batch)
    with torch.no_grad():
        feats = [f.float() for f in model(b["img"].double())]
    return ptr.loss(feats, b)[1].numpy()


def test_train_on_dataset_folder_matches_jax(dataset_dir, tmp_path, monkeypatch):
    """Both trainers from the same weights; each step's batch bit for bit and its loss
    items as `test_torch_port_train.py` holds tinyjde's free-running steps: 1e-2
    relative after the first step. At the first step (same weights, same batch) that
    file asks for 1e-5, but here JAX's float32 forward itself lies ~1e-3 from a
    float64 forward (the gray mosaic borders make the train-mode BN statistics
    ill-conditioned; the port's forward lies ~2e-5 from it), which moves its loss
    items by ~1e-4. So the port's first-step items must lie within 1e-5 (relative)
    of the float64 forward's, and within twice JAX's own distance from them (plus
    1e-5) of JAX's."""
    common = dict(model="tinyjde.yaml", data=str(dataset_dir / "data.yaml"), imgsz=64, batch=4,
                  nbs=4, workers=2, max_labels=16, seed=0, optimizer="SGD", warmup_epochs=0.0,
                  lr0=1e-3, epochs=2, close_mosaic=1)
    jtr = jax_jde_trainer({**common, "mesh_shape": [1], "plots": False, "save": False,
                           "project": str(tmp_path / "jax")}, seed=11, monkeypatch=monkeypatch)
    ptr = port_trainer_like(jtr, {**common, "project": str(tmp_path / "port")})
    monkeypatch.setattr(jtr, "_setup_train", lambda: None)  # set up by jax_jde_trainer
    import jax
    runs = {"jax": [], "port": []}
    jstep, pstep = jtr._train_step, ptr.train_step

    def jax_step(state, batch, mosaic_on):
        state, total, items = jstep(state, batch, mosaic_on)
        runs["jax"].append((jax.device_get(batch), np.asarray(items),
                            jtr.train_set.mosaic_enabled))
        return state, total, items

    def port_step(batch, i=0):
        total, items = pstep(batch, i)
        runs["port"].append((batch, items.numpy(), ptr.train_set.mosaic_enabled))
        return total, items
    jtr._train_step, ptr.train_step = jax_step, port_step
    ptr.train_loader.set_epoch(0)
    exact = _first_step_items_float64(ptr, next(iter(ptr.train_loader)))
    jtr.train()
    ptr.train()
    assert len(runs["port"]) == len(runs["jax"]) == 8  # 2 epochs of 16 images at batch 4
    assert [m for *_, m in runs["port"]] == [m for *_, m in runs["jax"]] == [True] * 4 + [False] * 4
    for i, ((gb, gi, _), (wb, wi, _)) in enumerate(zip(runs["port"], runs["jax"])):
        assert gb.keys() == wb.keys()
        for k in wb:
            np.testing.assert_array_equal(gb[k], wb[k], err_msg=f"step {i + 1} batch {k}")
        if i == 0:
            scale = np.abs(exact)
            scale[3] = max(scale[3], ptr.args.clr)  # the triplet item: per unit of its gain
            np.testing.assert_allclose(gi, exact, rtol=0, atol=1e-5 * scale.max(),
                                       err_msg="step 1 against the float64 forward")
            assert (np.abs(gi - wi) <= 2 * np.abs(wi - exact) + 1e-5 * scale).all(), \
                (gi, wi, exact)
        else:
            np.testing.assert_allclose(gi, wi, rtol=1e-2, err_msg=f"loss items, step {i + 1}")
    assert ptr.metrics.keys() == jtr.metrics.keys()
    shutil.rmtree(tmp_path, ignore_errors=True)
