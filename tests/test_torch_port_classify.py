"""The classify task of the PyTorch port against the JAX package (the head and every classify
graph: `test_torch_port_obb_cls_graphs.py`).

(a) `test_logits_match_jax`: the eval logits of tinycls, yolov8n-cls, yolo11n-cls and
yolo11n-cls-resnet18 at 64 px from `fill_variables` weights through the strict bridge (the
Linear's Flax (in, out) kernel transposed), within 1e-4 absolute;
`test_resnet18_body_parameter_count`: yolo11n-cls-resnet18's body (all but the head) has
torchvision resnet18's 11,176,512 parameters, as the JAX package's.
(b) `test_classification_loss_matches_jax`: the loss within 1e-6 relative and its gradient
within 1e-5 relative L2; `test_three_steps_match_jax`: tinycls on the synthetic set, 3 SGD
steps as `assert_trajectories_match` holds them (the Dropout is the identity in both).
(c) `test_classification_items_match_jax`: `ClassificationDataset` train items (random
resized crop, resize, flip, HSV) and val items (shorter side, centre crop) bit for bit with
JAX's, on a folder of PNG frames and two JPEG files (a 720x1280 frame and one with Exif
orientation 6).
(d) `test_classification_validator_matches_jax`: both validators on the same logits: top-1
and top-5 within 1e-6, with tied logits and a padded tail batch;
`test_folder_train_and_val_match_jax`: `YOLO.train` (1 epoch, dropout 0) and `YOLO.val` on
the class folder, the port's trainer from JAX's weights: loss items within 1e-5 relative
and equal accuracies.
(e) `test_predict_batched_matches_jax`: served probabilities within 1e-5, Results.probs
(top1, top5, their confidences), summary and verbose; `test_classify_checkpoint`.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.cfg import get_cfg as jax_get_cfg
from sar_yolo_tpu.data import dataset as jax_dataset
from sar_yolo_tpu.engine import validator as jax_validator
from sar_yolo_tpu.nn.tasks import build_model as jax_build_model
from sar_yolo_tpu.utils import loss as jax_loss
from sar_yolo_tpu_torch import YOLO
from sar_yolo_tpu_torch.cfg.default import get_cfg
from sar_yolo_tpu_torch.data.dataset import ClassificationDataset
from sar_yolo_tpu_torch.engine import validator as port_validator
from sar_yolo_tpu_torch.engine.predictor import ClassificationPredictor
from sar_yolo_tpu_torch.engine.trainer import ClassificationTrainer
from sar_yolo_tpu_torch.nn.tasks import build_model
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from sar_yolo_tpu_torch.utils.loss import classification_loss
from test_torch_port_pose import _jax_trainer, _nchw
from torch_port_common import (assert_trajectories_match, fill_variables,  # noqa: F401
                               jax_and_port_yolo, one_torch_thread, port_trainer_like)

LOGIT_TOL = 1e-4


# ---- (a) logits ------------------------------------------------------------------------------

def _jax_variables(jmodel, seed=0, imgsz=64):
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, imgsz, imgsz, 3)), train=False))
    return fill_variables(shapes, np.random.default_rng(seed))


@pytest.mark.parametrize("name", ["tinycls.yaml", "yolov8n-cls.yaml", "yolo11n-cls.yaml",
                                  "yolo11n-cls-resnet18.yaml"])
def test_logits_match_jax(name):
    jmodel, jmeta = jax_build_model(name)
    variables = _jax_variables(jmodel)
    model, meta = build_model(name)
    assert meta["task"] == jmeta["task"] == "classify" and meta["strides"] == []
    assert meta["head"] == jmeta["head"] == "Classify" and meta["head_index"] == jmeta["head_index"]
    model.load_state_dict(from_jax_variables(variables), strict=True)
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(_nchw(x)).numpy()
    want = np.asarray(jax.jit(lambda v, xx: jmodel.apply(v, xx, train=False))(variables,
                                                                             jnp.asarray(x)))
    assert got.shape == want.shape == (2, meta["nc"])
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)


def test_resnet18_body_parameter_count():
    model, meta = build_model("yolo11n-cls-resnet18.yaml")
    head = model.blocks[meta["head_index"]]
    body = sum(p.numel() for p in model.parameters()) - sum(p.numel() for p in head.parameters())
    assert body == 11_176_512 and meta["head_index"] == 5


# ---- (b) the loss and the train step ---------------------------------------------------------

def test_classification_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((6, 10)) * 3).astype(np.float32)
    labels = rng.integers(0, 10, 6).astype(np.float32)

    def jloss(lg):
        out = jax_loss.classification_loss(lg, {"cls": jnp.asarray(labels)})
        return out.total, out.items
    (jtotal, jitems), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(logits))
    t = torch.tensor(logits, requires_grad=True)
    out = classification_loss(t, {"cls": torch.tensor(labels)})
    out.total.backward()
    np.testing.assert_allclose(out.items.numpy(), np.asarray(jitems), rtol=1e-6)
    np.testing.assert_allclose(out.total.item(), float(jtotal), rtol=1e-6)
    g, w = t.grad.numpy(), np.asarray(jgrad)
    assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-5


def _common(**kw) -> dict:
    return dict(model="tinycls.yaml", data="synthetic", imgsz=64, batch=4, nbs=4, workers=1,
                seed=0, optimizer="SGD", warmup_epochs=0.0, **kw)


def test_three_steps_match_jax(tmp_path, monkeypatch):
    common = _common(lr0=1e-2)
    jtr = _jax_trainer(common, tmp_path, monkeypatch, task="classify")
    ptr = port_trainer_like(jtr, common)
    assert isinstance(ptr, ClassificationTrainer) and ptr.loss_names == ("loss",)
    assert not ptr.device_augment
    assert_trajectories_match(jtr, ptr, steps=3)


# ---- (c) class folders -----------------------------------------------------------------------

JPEG = Path(__file__).resolve().parent / "data" / "jpeg"


def write_class_folder(root, per_class: int, seed: int = 0):
    """train/ and val/ class folders of smooth PNG frames (three classes, ragged sizes), with
    a 720x1280 JPEG frame and an Exif-rotated JPEG among the train images."""
    import shutil

    import cv2
    rng = np.random.default_rng(seed)
    shapes = [(48, 80), (80, 48), (64, 64), (37, 90)]
    for split in ("train", "val"):
        for c in ("cat", "dog", "eel"):
            d = root / split / c
            d.mkdir(parents=True)
            for i in range(per_class):
                h, w = shapes[(i + len(c)) % len(shapes)]
                small = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3), dtype=np.uint8)
                cv2.imwrite(str(d / f"{i:02d}.png"), cv2.resize(small, (w, h)))
    shutil.copy(f"{JPEG}/frames/frame_00.jpg", root / "train" / "dog" / "frame.jpg")
    shutil.copy(f"{JPEG}/variants/exif_orientation_6.jpg", root / "train" / "eel" / "exif.jpg")
    return root


@pytest.fixture(scope="module")
def cls_dir(tmp_path_factory):
    return write_class_folder(tmp_path_factory.mktemp("cls_data"), 4)


@pytest.mark.parametrize("hyp", [{}, {"hsv_h": 0.5, "hsv_s": 0.9, "hsv_v": 0.9}],
                         ids=["defaults", "strong-hsv"])
def test_classification_items_match_jax(cls_dir, hyp):
    train = cls_dir / "train"
    got = ClassificationDataset(train, imgsz=64, augment=True, hyp=get_cfg(hyp), seed=3)
    want = jax_dataset.ClassificationDataset(train, imgsz=64, augment=True,
                                             hyp=jax_get_cfg(overrides=hyp), seed=3)
    assert got.names == want.names and len(got) == len(want) == 14
    assert [s for s in got.samples] == [tuple(s) for s in want.samples]
    for epoch in (0, 1):
        got.epoch = want.epoch = epoch
        for i in range(len(want)):
            g, w = got[i], want[i]
            assert g.keys() == w.keys() == {"img", "cls"} and g["img"].shape == (64, 64, 3)
            np.testing.assert_array_equal(g["img"], w["img"], err_msg=f"epoch {epoch} item {i}")
            assert g["cls"] == w["cls"] and g["cls"].dtype == np.float32
    val = ClassificationDataset(train, imgsz=40, augment=False)
    jval = jax_dataset.ClassificationDataset(train, imgsz=40, augment=False)
    for i in range(len(jval)):
        np.testing.assert_array_equal(val[i]["img"], jval[i]["img"], err_msg=f"val item {i}")


# ---- (d) validation and training -------------------------------------------------------------

class _Logits(torch.nn.Module):
    """Serves fixed logits batch by batch (the validator's model)."""

    def __init__(self, logits):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))
        self.logits, self.i = logits, 0

    def forward(self, x):
        out = torch.tensor(self.logits[self.i:self.i + len(x)])
        self.i += len(x)
        return out


def test_classification_validator_matches_jax(monkeypatch):
    kw = dict(n=10, imgsz=32, nc=3, seed=2, task="classify")
    from sar_yolo_tpu_torch.data.dataset import SyntheticDataset
    rng = np.random.default_rng(0)
    logits = np.round(rng.standard_normal((12, 8)), 1).astype(np.float32)  # ties
    logits[10:] = logits[9]  # the padded tail repeats the last sample
    calls = []

    class JaxModel:
        def apply(self, variables, img, train=False):
            calls.append(len(img))
            return jnp.asarray(logits[(len(calls) - 1) * 4:(len(calls) - 1) * 4 + len(img)])
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f)
    want = jax_validator.ClassificationValidator()(
        model=JaxModel(), variables={}, meta={"nc": 8}, dataset=jax_dataset.SyntheticDataset(**kw),
        args=jax_get_cfg(overrides={"batch": 4, "workers": 1}), data={})
    got = port_validator.ClassificationValidator()(
        model=_Logits(logits), meta={"nc": 8}, dataset=SyntheticDataset(**kw),
        args=get_cfg({"batch": 4, "workers": 1}), data={})
    assert calls == [4, 4, 4]
    assert got.keys() == want.keys() and 0 < got["metrics/accuracy_top1"] < \
        got["metrics/accuracy_top5"] < 1
    for k in set(want) - {"speed/ms_per_image"}:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert got["fitness"] == got["metrics/accuracy_top1"]


def test_folder_train_and_val_match_jax(cls_dir, tmp_path, monkeypatch):
    common = dict(model="tinycls.yaml", data=str(cls_dir), imgsz=32, batch=4, nbs=4, workers=1,
                  seed=0, optimizer="SGD", lr0=1e-2, warmup_epochs=0.0, epochs=1)
    jtr = _jax_trainer(common, tmp_path, monkeypatch, task="classify")
    ptr = port_trainer_like(jtr, common)
    assert ptr.data["names"] == jtr.data["names"] == {0: "cat", 1: "dog", 2: "eel"}
    assert len(ptr.train_set) == 14 and len(ptr.val_set) == 12
    assert_trajectories_match(jtr, ptr, steps=3)
    m = YOLO("tinycls.yaml", device="cpu")
    metrics = m.train(**{k: v for k, v in common.items() if k != "model"}, project=str(tmp_path))
    assert {"train/loss", "metrics/accuracy_top1", "metrics/accuracy_top5"} <= set(metrics)
    jyolo, pyolo = jax_and_port_yolo("tinycls.yaml", 3)
    kw = dict(data=str(cls_dir), imgsz=32, batch=5, name="val", exist_ok=True)
    want = jyolo.val(plots=False, project=str(tmp_path / "jax"), **kw)
    got = pyolo.val(project=str(tmp_path / "port"), **kw)
    for k in set(want) - {"speed/ms_per_image"}:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    train_split = pyolo.val(project=str(tmp_path / "port"), **{**kw, "split": "train"})
    assert train_split.keys() == got.keys()


# ---- (e) serving -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cls_pair():
    return jax_and_port_yolo("tinycls.yaml", 4)


def test_predict_batched_matches_jax(cls_pair):
    jyolo, pyolo = cls_pair
    frames = np.random.default_rng(0).integers(0, 256, (3, 48, 80, 3), np.uint8)
    kw = dict(imgsz=64)
    assert type(pyolo._get_predictor(kw)) is ClassificationPredictor
    want = np.asarray(jyolo.predict_batched(frames, **kw))
    got = pyolo.predict_batched(frames, **kw)
    assert got.shape == want.shape == (3, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=0, atol=1e-6)
    res, jres = pyolo.predict(list(frames), **kw), jyolo.predict(list(frames), **kw)
    for r, j in zip(res, jres):
        assert r.boxes is None and r.obb is None and len(r.probs) == 3
        assert r.probs.top1 == j.probs.top1 and r.probs.top5 == j.probs.top5
        np.testing.assert_allclose(r.probs.top5conf, j.probs.top5conf, rtol=0, atol=1e-5)
        assert abs(r.probs.top1conf - j.probs.top1conf) < 1e-5
        assert r.summary()[0]["class"] == j.summary()[0]["class"] and r.verbose().startswith("c")


def test_classify_checkpoint(cls_dir, tmp_path):
    m = YOLO("tinycls.yaml", device="cpu")
    m.train(data=str(cls_dir), imgsz=32, batch=4, epochs=1, workers=1, project=str(tmp_path))
    ck = YOLO(m.ckpt_dir, device="cpu")
    assert ck.task == "classify" and ck.names == {0: "cat", 1: "dog", 2: "eel"}
    frames = np.random.default_rng(1).integers(0, 256, (2, 48, 80, 3), np.uint8)
    np.testing.assert_allclose(ck.predict_batched(frames, imgsz=32),
                               m.predict_batched(frames, imgsz=32), rtol=0, atol=1e-6)
    val = ck.val(data=str(cls_dir), imgsz=32, batch=4, project=str(tmp_path))
    assert set(val) >= {"metrics/accuracy_top1", "metrics/accuracy_top5", "fitness"}
    folded = YOLO(m.ckpt_dir, device="cpu").fuse()
    np.testing.assert_allclose(folded.predict_batched(frames, imgsz=32),
                               ck.predict_batched(frames, imgsz=32), rtol=0, atol=1e-5)
    txt = tmp_path / "probs.txt"
    ck.predict(list(frames[:1]), imgsz=32)[0].save_txt(txt)
    top1, cls = txt.read_text().split()
    assert int(cls) in (0, 1, 2) and 0 < float(top1) <= 1
