"""The port's `plots` (`utils/plotting.py`, the validators' and trainer's hooks) against the
JAX package's, on the CPU.

While the mosaics are compared, the label text is recorded instead of drawn on both sides
(`cv2.putText` for JAX, `data/cv.py::put_text` for the port), as in
`test_torch_port_annotate.py`: OpenCV 5.0 draws putText as TrueType, the port OpenCV 4.x's
Hershey strokes (held to OpenCV 4.13 in `test_torch_port_draw.py`, scale 0.35 included).

(a) `ConfusionMatrix.process_batch`: the matrix equals JAX's exactly, over seeded batches
    with images without ground truth, without detections and with detections under conf.
(b) `plot_images` and `plot_predictions`: the written files equal JAX's byte for byte (the
    port's JPEG encoder writes libjpeg-turbo's bytes; PNGs are compared decoded), and the
    text calls (string, origin, scale, colour, thickness) are equal: boxes, rotated boxes,
    masks at the prototypes' and the image's resolution, 17-keypoint skeletons and 5-keypoint
    sets, float images, more images than the mosaic holds.
(c) Segment masks: the port's validator draws `process_mask` in torch, JAX in jnp; the
    masks differ only in pixels whose float64 probability lies within MASK_MARGIN of 0.5.
(d) A rectangular batch: JAX's square tiles raise and its validator warns and writes no
    mosaic; the port tiles in h x w, each tile its image's own drawing.
(e) `YOLO.val` and `YOLO.train` write JAX's file names (detect, JDE, pose, segment, OBB,
    RT-DETR validators; JDE and detect training on a dataset folder, so labels.jpg too), and
    the ground-truth mosaic of the same data byte for byte; `plots=False` writes no figure,
    nor does a classify validation; `get_cfg` and the command line take `plots`.
"""

from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

import sar_yolo_tpu.engine.validator as jax_validator
import sar_yolo_tpu.utils.plotting as jax_plotting
from sar_yolo_tpu.engine.model import YOLO as JaxYOLO
from sar_yolo_tpu.ops.masks import process_mask as jax_process_mask
from sar_yolo_tpu_torch import YOLO
from sar_yolo_tpu_torch import cfg as port_cfg
from sar_yolo_tpu_torch.cfg.default import get_cfg
from sar_yolo_tpu_torch.data import cv as port_cv
from sar_yolo_tpu_torch.engine import validator as port_validator
from sar_yolo_tpu_torch.utils import plotting
from torch_port_common import one_torch_thread, write_jde_dataset  # noqa: F401

JAX_MODELS = Path(jax_validator.__file__).parents[1] / "cfg" / "models"
MASK_MARGIN = 1e-5    # float64 mask probability this near 0.5 may threshold either way
FIGURES = {"confusion_matrix.png", "val_batch0_labels.jpg", "val_batch0_pred.jpg",
           "train_batch0.png", "labels.jpg", "labels_correlogram.jpg", "results.png"}


@pytest.fixture
def text_calls(monkeypatch):
    """Each package's label calls, recorded and not drawn."""
    calls = {"jax": [], "port": []}

    def jax_put(img, text, org, font, scale, color, thickness=1, *args):
        assert font == cv2.FONT_HERSHEY_SIMPLEX and not args
        calls["jax"].append((text, tuple(org), scale, tuple(color), thickness))
        return img

    def port_put(img, text, org, font_scale, color, thickness=1):
        calls["port"].append((text, tuple(org), font_scale, tuple(color), thickness))
        return img
    monkeypatch.setattr(cv2, "putText", jax_put)
    monkeypatch.setattr(port_cv, "put_text", port_put)
    return calls


# ---- (a) the confusion matrix --------------------------------------------------------------

def _gt_and_dets(rng, nc: int):
    g = int(rng.integers(0, 6))
    xy = rng.uniform(0, 50, (g, 2))
    gt = np.concatenate([xy, xy + rng.uniform(4, 30, (g, 2))], 1).astype(np.float32)
    gt_cls = rng.integers(0, nc, g).astype(np.float32)
    n = int(rng.integers(0, 9))
    src = gt[rng.integers(0, max(g, 1), n)] if g else rng.uniform(0, 60, (n, 4))
    boxes = (src + rng.normal(0, 3, (n, 4))).astype(np.float32)
    dets = np.concatenate([boxes, rng.uniform(0, 1, (n, 1)), rng.integers(0, nc, (n, 1)),
                           rng.standard_normal((n, 3))], 1).astype(np.float32)
    return gt, gt_cls, (None if n == 0 and rng.random() < 0.5 else dets)


@pytest.mark.parametrize("nc", [1, 3])
def test_confusion_matrix_matches_jax(nc):
    rng = np.random.default_rng(nc)
    j, p = jax_plotting.ConfusionMatrix(nc), plotting.ConfusionMatrix(nc)
    kinds = set()
    for _ in range(300):
        gt, gt_cls, dets = _gt_and_dets(rng, nc)
        kinds.add((len(gt_cls) > 0, dets is not None and len(dets) > 0))
        j.process_batch(None if dets is None else dets.copy(), gt, gt_cls)
        p.process_batch(None if dets is None else dets.copy(), gt, gt_cls)
    assert kinds == {(True, True), (True, False), (False, True), (False, False)}
    np.testing.assert_array_equal(p.matrix, j.matrix)
    assert p.matrix.dtype == np.int64 and p.matrix[:nc, :nc].trace() > 0 and \
        p.matrix[nc].sum() > 0 and p.matrix[:, nc].sum() > 0


# ---- (b) the mosaics -----------------------------------------------------------------------

def _images(n, h, w, seed, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 256, (n, max(h // 8, 1), max(w // 8, 1), 3), dtype=np.uint8)
    imgs = np.stack([cv2.resize(c, (w, h), interpolation=cv2.INTER_NEAREST) for c in cells])
    return imgs if dtype == np.uint8 else (imgs / 255.0).astype(dtype)


def _gt_batch(case: str, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    B = 18 if case == "many" else 5
    h = w = 64
    M = 6
    batch = {"img": _images(B, h, w, seed, np.float32 if case == "float" else np.uint8),
             "mask": (rng.random((B, M)) < 0.7).astype(np.float32),
             "cls": rng.integers(0, 12, (B, M)).astype(np.float32)}
    xy = rng.uniform(0.1, 0.9, (B, M, 2))
    wh = rng.uniform(0.05, 0.6, (B, M, 2))
    batch["bboxes"] = np.concatenate([xy, wh], -1).astype(np.float32)
    if case == "rotated":
        batch["bboxes"] = np.concatenate([batch["bboxes"], rng.uniform(-1.5, 1.5, (B, M, 1))],
                                         -1).astype(np.float32)
    if case == "masks":
        batch["masks"] = rng.integers(0, M + 1, (B, h // 4, w // 4)).astype(np.float32)
    if case in ("keypoints17", "keypoints5"):
        K = 17 if case == "keypoints17" else 5
        kp = np.concatenate([rng.uniform(-0.05, 1, (B, M, K, 2)), rng.random((B, M, K, 1))], -1)
        batch["keypoints"] = (kp if K == 17 else kp[..., :2]).astype(np.float32)
    return batch


@pytest.mark.parametrize("case", ["boxes", "float", "rotated", "masks", "keypoints17",
                                  "keypoints5", "many"])
@pytest.mark.parametrize("suffix", [".jpg", ".png"])
def test_plot_images_matches_jax(case, suffix, tmp_path, text_calls):
    batch = _gt_batch(case, seed=len(case))
    jax_plotting.plot_images({k: v.copy() for k, v in batch.items()}, tmp_path / f"j{suffix}")
    plotting.plot_images(batch, tmp_path / f"p{suffix}")
    _same_file(tmp_path / f"p{suffix}", tmp_path / f"j{suffix}")
    assert text_calls["jax"] == text_calls["port"] == []


def _same_file(got: Path, want: Path):
    if got.suffix == ".jpg":
        assert got.read_bytes() == want.read_bytes()
    else:
        np.testing.assert_array_equal(cv2.imread(str(got)), cv2.imread(str(want)))


def _pred_rows(case: str, n_img: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    rows = []
    for b in range(n_img):
        n = int(rng.integers(0, 9)) if b else 0  # the first image without rows
        conf = np.where(rng.random(n) < 0.2, 0.25, rng.uniform(0.05, 1, n))
        if case == "rotated":
            r = np.concatenate([rng.uniform(0, 64, (n, 2)), rng.uniform(2, 40, (n, 2)),
                                rng.uniform(-1.6, 1.6, (n, 1)), conf[:, None],
                                rng.integers(0, 12, (n, 1))], 1)
        else:
            xy = rng.uniform(-8, 60, (n, 2))
            r = np.concatenate([xy, xy + rng.uniform(0, 40, (n, 2)), conf[:, None],
                                rng.integers(0, 12, (n, 1))], 1)
            if case == "keypoints17":
                r = np.concatenate([r, np.concatenate(
                    [rng.uniform(-4, 64, (n, 17, 2)), rng.random((n, 17, 1))],
                    -1).reshape(n, 51)], 1)
        if n:  # one named, confident row
            r[0, 5 if case == "rotated" else 4], r[0, 6 if case == "rotated" else 5] = 0.9, 0
        rows.append(np.concatenate([r, np.zeros((3, r.shape[1]))]).astype(np.float32))
    return rows


@pytest.mark.parametrize("case", ["boxes", "float", "rotated", "masks_low", "masks_full",
                                  "keypoints17", "many"])
def test_plot_predictions_matches_jax(case, tmp_path, text_calls):
    n_img = 18 if case == "many" else 5
    imgs = _images(n_img, 64, 64, len(case), np.float64 if case == "float" else np.uint8)
    dets = _pred_rows(case, n_img - 1, seed=len(case))  # the last image without its list
    kw = {"names": {0: "person", 3: "boat"}, "conf": 0.25}
    rng = np.random.default_rng(0)
    if case.startswith("masks"):
        side = 16 if case == "masks_low" else 64
        kw["masks"] = [rng.random((len(d), side, side)) < 0.4 for d in dets]
        kw["masks"][2] = None
    if case == "keypoints17":
        kw["kpts"] = [d[:, 6:].reshape(-1, 17, 3) for d in dets]
    if case == "rotated":
        kw["rotated"] = True
    jax_plotting.plot_predictions(imgs.copy(), dets, tmp_path / "j.jpg", **kw)
    plotting.plot_predictions(imgs, dets, tmp_path / "p.jpg", **kw)
    _same_file(tmp_path / "p.jpg", tmp_path / "j.jpg")
    assert text_calls["port"] == text_calls["jax"] and len(text_calls["port"]) > 3
    assert any(t[2] == 0.35 and t[0].startswith("person ") for t in text_calls["port"])


def test_mosaics_leave_the_batch_alone(tmp_path):
    batch = _gt_batch("masks", 3)
    keep = {k: v.copy() for k, v in batch.items()}
    plotting.plot_images(batch, tmp_path / "a.jpg")
    plotting.plot_predictions(batch["img"], _pred_rows("boxes", 5, 3), tmp_path / "b.jpg")
    for k in batch:
        np.testing.assert_array_equal(batch[k], keep[k])


# ---- (c) segment masks ---------------------------------------------------------------------

def test_segment_plot_masks_match_jax_within_the_threshold_margin():
    rng = np.random.default_rng(3)
    nm, B, n = 32, 2, 40
    protos = rng.standard_normal((B, nm, 16, 16)).astype(np.float32)
    dets = np.zeros((B, n, 6 + nm), np.float32)
    xy = rng.uniform(0, 50, (B, n, 2))
    dets[..., :2], dets[..., 2:4] = xy, xy + rng.uniform(4, 30, (B, n, 2))
    dets[..., 4] = rng.uniform(0, 1, (B, n))
    dets[..., 6:] = rng.standard_normal((B, n, nm)) * 0.3
    v = port_validator.SegmentValidator()
    v.args, v.meta, v.conf, v._protos = get_cfg({"conf": 0.001}), {"nm": nm}, 0.001, protos
    batch = {"img": np.zeros((B, 64, 64, 3), np.uint8)}
    got = v._plot_pred_extras(batch, dets, B)["masks"]
    flips = pixels = 0
    for bi in range(B):
        want = np.asarray(jax_process_mask(jnp.asarray(protos[bi].transpose(1, 2, 0)),
                                           jnp.asarray(dets[bi, :, 6:]),
                                           jnp.asarray(dets[bi, :, :4]), (64, 64)))
        prob = 1 / (1 + np.exp(-np.einsum("nc,chw->nhw", dets[bi, :, 6:].astype(np.float64),
                                           protos[bi].astype(np.float64))))
        for ri in range(n):
            if dets[bi, ri, 4] < 0.25:
                assert got[bi][ri] is None
                continue
            diff = got[bi][ri] != want[ri]
            flips += int(diff.sum())
            pixels += diff.size
            assert (np.abs(prob[ri][diff] - 0.5) < MASK_MARGIN).all(), (bi, ri)
    assert pixels > 0 and flips <= pixels * 1e-3


# ---- (d) rectangular batches ---------------------------------------------------------------

class _Args:
    def __init__(self, save_dir):
        self.save_dir = str(save_dir)


def test_rect_batch_mosaics(tmp_path, monkeypatch, text_calls):
    """JAX's square tiles cannot hold a 32 x 56 image: its validator warns and writes no
    mosaic. The port tiles in h x w, and each tile is its image's own drawing."""
    batch = _gt_batch("boxes", 5)
    batch["img"] = _images(5, 32, 56, 5)
    dets = np.stack(_pred_rows("boxes", 5, 5)[:1] * 5)
    warnings = []
    monkeypatch.setattr(jax_validator.LOGGER, "warning", warnings.append)
    jv = jax_validator.DetectionValidator()
    jv.args, jv.data, jv.meta = _Args(tmp_path / "jax"), {"names": {}}, {}
    jv._plot_first_batch(batch, dets, 5, 0.001)
    assert len(warnings) == 1 and "could not broadcast" in warnings[0]
    assert not list((tmp_path / "jax").glob("*.jpg"))

    pv = port_validator.DetectionValidator()
    pv.args, pv.data, pv.meta, pv.conf = _Args(tmp_path / "port"), {"names": {}}, {}, 0.001
    pv._plot_first_batch(batch, dets, 5)
    labels = cv2.imread(str(tmp_path / "port" / "val_batch0_labels.jpg"))
    pred = cv2.imread(str(tmp_path / "port" / "val_batch0_pred.jpg"))
    assert labels.shape == pred.shape == (2 * 32, 3 * 56, 3)
    # PNG copies of the two mosaics (JPEG blocks straddle the tiles), tile by tile
    plotting.plot_images(batch, tmp_path / "all.png")
    plotting.plot_predictions(batch["img"], list(dets), tmp_path / "pall.png")
    for b in range(5):
        plotting.plot_images({k: v[b:b + 1] for k, v in batch.items()}, tmp_path / "one.png")
        plotting.plot_predictions(batch["img"][b:b + 1], dets[b:b + 1], tmp_path / "pone.png")
        r, c = divmod(b, 3)
        tile = np.s_[r * 32:(r + 1) * 32, c * 56:(c + 1) * 56]
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "all.png"))[tile],
                                      cv2.imread(str(tmp_path / "one.png")))
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "pall.png"))[tile],
                                      cv2.imread(str(tmp_path / "pone.png")))
    assert (cv2.imread(str(tmp_path / "all.png"))[64:, 112:] == 255).all()  # the empty cell


# ---- (e) the entry points ------------------------------------------------------------------

def _figures(d: Path) -> set:
    return {p.name for p in d.rglob("*") if p.name in FIGURES}


VAL_MODELS = [("tinydet.yaml", "detect"), ("tinyjde.yaml", "jde"), ("tinypose.yaml", "pose"),
              ("tinyseg.yaml", "segment"), ("tinyobb.yaml", "obb"),
              ("tinyrtdetr.yaml", "detect")]


@pytest.mark.parametrize("cfg,task", VAL_MODELS)
def test_val_writes_jax_figures(cfg, task, tmp_path):
    kw = dict(data="synthetic", imgsz=32, batch=6, name="val", exist_ok=True)
    model = cfg
    if cfg == "tinyrtdetr.yaml":  # the decoder trimmed (hd 32, 20 queries, 2 layers)
        model = str(tmp_path / "tinyrtdetr-trim.yaml")
        text = (JAX_MODELS / "test" / cfg).read_text()
        Path(model).write_text(text.replace("RTDETRDecoder, [nc]]",
                                            "RTDETRDecoder, [nc, 32, 20, 2]]"))
    JaxYOLO(model).val(project=str(tmp_path / "jax"), **kw)
    YOLO(model, device="cpu").val(project=str(tmp_path / "port"), **kw)
    jdir, pdir = tmp_path / "jax" / task / "val", tmp_path / "port" / task / "val"
    want = _figures(jdir)
    assert _figures(pdir) == want and "val_batch0_labels.jpg" in want
    assert ("confusion_matrix.png" in want) == (cfg not in ("tinyobb.yaml", "tinyrtdetr.yaml"))
    # the same synthetic batch: the ground-truth mosaic byte for byte
    assert (pdir / "val_batch0_labels.jpg").read_bytes() == \
        (jdir / "val_batch0_labels.jpg").read_bytes()


@pytest.fixture(scope="module")
def jde_folder(tmp_path_factory):
    return write_jde_dataset(tmp_path_factory.mktemp("jde_data"), n_train=8, n_val=4)


def test_train_writes_jax_figures(jde_folder, tmp_path):
    """JDE training on a dataset folder writes JAX's seven figures; detect training the
    same seven."""
    kw = dict(data=jde_folder, imgsz=32, batch=8, epochs=1, workers=0, name="train",
              exist_ok=True, mosaic=0.0, max_labels=16)
    JaxYOLO("tinyjde.yaml").train(project=str(tmp_path / "jax"), **kw)
    YOLO("tinyjde.yaml", device="cpu").train(project=str(tmp_path / "port"), **kw)
    YOLO("tinydet.yaml", device="cpu").train(project=str(tmp_path / "port"), **kw)
    assert _figures(tmp_path / "port" / "detect" / "train") == FIGURES
    jdir, pdir = tmp_path / "jax" / "jde" / "train", tmp_path / "port" / "jde" / "train"
    assert _figures(pdir) == _figures(jdir) == FIGURES
    for name in ("labels.jpg", "labels_correlogram.jpg", "results.png", "train_batch0.png"):
        assert cv2.imread(str(pdir / name)).shape == cv2.imread(str(jdir / name)).shape, name
    # the validation's ground truth of the same files
    assert (pdir / "val_batch0_labels.jpg").read_bytes() == \
        (jdir / "val_batch0_labels.jpg").read_bytes()


def test_train_batch0_is_the_host_batch(tmp_path, monkeypatch):
    """train_batch0.png draws the loader's first batch, before multi_scale resizes it."""
    from sar_yolo_tpu_torch.engine import trainer as port_trainer
    seen = []
    orig = port_trainer.BaseTrainer.train_step

    def train_step(self, batch, i=0):
        seen.append({k: np.array(v) for k, v in batch.items()})
        return orig(self, batch, i)
    firsts = []
    orig_plot = port_trainer.BaseTrainer._plot_first_batch
    monkeypatch.setattr(port_trainer.BaseTrainer, "train_step", train_step)
    monkeypatch.setattr(port_trainer.BaseTrainer, "_plot_first_batch",
                        lambda self, b: (firsts.append({k: np.array(v) for k, v in b.items()}),
                                         orig_plot(self, b)))
    YOLO("tinydet.yaml", device="cpu").train(data="synthetic", imgsz=64, batch=4, epochs=1,
                                            workers=0, multi_scale=True, val=False,
                                            project=str(tmp_path), name="ms")
    assert len(firsts) == 1 and firsts[0]["img"].shape[1:3] == (64, 64)
    plotting.plot_images(firsts[0], tmp_path / "want.png")
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "detect" / "ms" / "train_batch0.png")),
                                  cv2.imread(str(tmp_path / "want.png")))
    assert _figures(tmp_path / "detect" / "ms") == {"train_batch0.png", "results.png"}


def test_plots_false_writes_no_figure(tmp_path):
    y = YOLO("tinyjde.yaml", device="cpu")
    y.val(data="synthetic", imgsz=32, batch=8, plots=False, project=str(tmp_path), name="v")
    y.train(data="synthetic", imgsz=32, batch=4, epochs=1, workers=0, plots=False,
            project=str(tmp_path), name="t")
    YOLO("tinycls.yaml", device="cpu").val(data="synthetic", imgsz=32, batch=8,
                                           project=str(tmp_path), name="c")
    assert _figures(tmp_path) == set()
    assert (tmp_path / "jde" / "t" / "results.csv").exists()


def test_plots_key_in_cfg_and_command_line(tmp_path):
    assert get_cfg({"plots": False}).plots is False
    assert get_cfg({"plots": True}).plots is True and get_cfg().plots is True
    common = ["detect", "val", "model=tinydet.yaml", "data=synthetic", "imgsz=32", "batch=8",
              "device=cpu", f"project={tmp_path}", "exist_ok=True"]
    port_cfg.entrypoint(common + ["name=off", "plots=False"])
    port_cfg.entrypoint(common + ["name=on"])
    assert _figures(tmp_path / "detect" / "off") == set()
    assert _figures(tmp_path / "detect" / "on") == {"confusion_matrix.png",
                                                    "val_batch0_labels.jpg",
                                                    "val_batch0_pred.jpg"}
