"""Test-time augmentation of the PyTorch port against the JAX package (`ops/tta.py`, the
predictor's per-frame route and the validator).

The same numpy inputs and weights go through both packages. `scale_pad_image`: within 5e-6 of
`jax.image.resize`'s bilinear (the two compute their interpolation weights differently:
1.7e-6 measured on [0, 1] inputs). `forward_tta` on yolov13n (A2C2f at layers 6 and 8) with
seeded, uncalibrated weights (calibrated BN at 64-96 px drives this depth's maps to ~1e4,
where float32 rounding alone moves boxes by pixels): boxes within 1e-4 px plus 1e-6 of their
size (an ulp of 120 px is 7.6e-6), scores within 1e-5. `YOLO.predict(augment=True)` and the validator on the BN-folded models (each package
folds its own): rows within 1e-4, metrics within 1e-6 (a match decided otherwise would move
them by over 1e-2). Every other head warns and serves or
validates one scale.
"""

import numpy as np
import pytest
import torch

from sar_yolo_tpu_torch.engine import predictor as port_predictor
from sar_yolo_tpu_torch.engine import validator as port_validator
from sar_yolo_tpu_torch.ops.tta import forward_tta, scale_pad_image
from torch_port_common import jax_and_port_yolo, one_torch_thread  # noqa: F401

STRIDES = (8, 16, 32)
RESIZE_TOL = 5e-6
BOX_TOL, BOX_RTOL, SCORE_TOL = 1e-4, 1e-6, 1e-5
ROW_TOL = 1e-4


@pytest.fixture(scope="module")
def v13():
    """yolov13n (nc 6) with the same numpy-filled weights in both packages, class logits
    spread so that scores leave gaps to put thresholds in."""
    return jax_and_port_yolo("yolov13n.yaml", 3, cls_gain=20.0)


@pytest.mark.parametrize("hw", [(64, 64), (96, 96), (100, 160), (640, 640)], ids=str)
def test_scale_pad_image_matches_jax(hw):
    import jax.numpy as jnp

    from sar_yolo_tpu.ops.tta import scale_pad_image as jax_scale_pad_image
    x = np.random.default_rng(hw[0]).random((2, *hw, 3), np.float32)
    for ratio in (1.0, 0.83, 0.67):
        want = np.asarray(jax_scale_pad_image(jnp.asarray(x), ratio))
        got = scale_pad_image(torch.from_numpy(x).permute(0, 3, 1, 2), ratio)
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)
        if ratio < 1:  # the pad rows and columns hold 0.447
            nh, nw = int(hw[0] * ratio), int(hw[1] * ratio)
            assert (got[:, nh:] == np.float32(0.447)).all()
            assert (got[:, :, nw:] == np.float32(0.447)).all()


@pytest.mark.parametrize("size", [64, 96])
def test_forward_tta_matches_jax(v13, size):
    import jax
    import jax.numpy as jnp

    from sar_yolo_tpu.ops.tta import forward_tta as jax_forward_tta
    jyolo, pyolo = v13
    nc = jyolo.meta["nc"]
    x = np.random.default_rng(size).random((2, size, size, 3), np.float32)
    fn = jax.jit(lambda v, xx: jax_forward_tta(
        lambda xi: jyolo.model.apply(v, xi, train=False), xx, STRIDES, nc))
    want = np.asarray(fn(jyolo.variables, jnp.asarray(x)))
    with torch.no_grad():
        got = forward_tta(pyolo.model.eval(), torch.from_numpy(x).permute(0, 3, 1, 2),
                          list(STRIDES), nc).numpy()
    # full scale without P5, 0.83 whole, 0.67 without P3 (all three passes at size x size)
    n = [(size // s) ** 2 for s in STRIDES]
    assert got.shape == want.shape == (2, n[0] + n[1] + sum(n) + n[1] + n[2], 4 + nc)
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=BOX_RTOL, atol=BOX_TOL)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], rtol=0, atol=SCORE_TOL)


def _gap_conf(scores: np.ndarray, lo: float = 0.3) -> float:
    """A threshold in the widest gap of the sorted scores above `lo`."""
    s = np.sort(scores[scores > lo])
    i = int(np.argmax(np.diff(s)))
    return float((s[i] + s[i + 1]) / 2)


def _frames():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, (72, 128, 3), np.uint8) for _ in range(2)]


def test_predict_augment_matches_jax(v13):
    jyolo, pyolo = v13
    frames = _frames()
    low = pyolo.predict(frames, imgsz=64, augment=True, conf=0.3)
    conf = _gap_conf(np.concatenate([r.boxes.conf for r in low]))
    want = jyolo.predict(frames, imgsz=64, augment=True, conf=conf)
    got = pyolo.predict(frames, imgsz=64, augment=True, conf=conf)
    single = pyolo.predict(frames, imgsz=64, conf=conf)
    assert sum(len(r) for r in want) > 0
    for g, w in zip(got, want):
        gb, wb = g.boxes.data, np.asarray(w.boxes.data)
        assert gb.shape == wb.shape
        np.testing.assert_array_equal(gb[:, 5], wb[:, 5])
        np.testing.assert_allclose(gb[:, :5], wb[:, :5], rtol=0, atol=ROW_TOL)
    assert any(len(g) != len(s) or not np.allclose(g.boxes.data, s.boxes.data)
               for g, s in zip(got, single)), "augment=True served the single-scale rows"
    # the batched route never reads `augment`, as the JAX package's does not
    batch = np.stack(frames)
    np.testing.assert_array_equal(pyolo.predict_batched(batch, imgsz=64, augment=True, conf=conf),
                                  pyolo.predict_batched(batch, imgsz=64, conf=conf))


class _PlantedSet:
    """A JAX synthetic set's images with ground truth planted at given boxes (xyxy pixels) and
    classes."""

    def __init__(self, base, boxes: list, classes: list, imgsz: int, max_labels: int = 16):
        self.base, self.boxes, self.classes = base, boxes, classes
        self.imgsz, self.max_labels = imgsz, max_labels

    def __len__(self):
        return len(self.boxes)

    def __getitem__(self, i):
        item = dict(self.base[i])
        b = np.asarray(self.boxes[i], np.float32)[:self.max_labels]
        xywh = np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                         b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], 1) / self.imgsz
        n, M = len(b), self.max_labels
        item["bboxes"] = np.zeros((M, 4), np.float32)
        item["bboxes"][:n] = xywh
        item["cls"] = np.zeros(M, np.float32)
        item["cls"][:n] = np.asarray(self.classes[i])[:n]
        item["mask"] = (np.arange(M) < n).astype(np.float32)
        return item


def test_val_augment_matches_jax(tmp_path):
    """tinydet with BN calibrated (image-dependent rows; a shallow graph, so float32 rounding
    stays small), ground truth planted 1 px from six of its TTA detections an image."""
    from sar_yolo_tpu.cfg import get_cfg as jax_get_cfg
    from sar_yolo_tpu.data import SyntheticDataset as JaxSyntheticDataset
    from sar_yolo_tpu.engine.validator import DetectionValidator as JaxDetectionValidator
    from sar_yolo_tpu_torch.cfg.default import get_cfg
    from sar_yolo_tpu_torch.ops.nms import non_max_suppression
    jyolo, pyolo = jax_and_port_yolo("tinydet.yaml", 3, calibrate=64)
    nc = pyolo.meta["nc"]
    base = JaxSyntheticDataset(n=4, imgsz=64, nc=3, max_labels=16, seed=0)
    x = torch.from_numpy(np.stack([base[i]["img"] for i in range(4)])).permute(0, 3, 1, 2)
    with torch.no_grad():
        dets = non_max_suppression(forward_tta(pyolo._fused_for_serving(), x.float() / 255.0,
                                               list(STRIDES), nc),
                                   conf_thres=0.001, iou_thres=0.7, max_det=6, nc=nc).numpy()
    planted = _PlantedSet(base, [d[:, :4] - 1.0 for d in dets], [d[:, 5] for d in dets], 64)
    data = {"nc": nc, "names": {i: f"c{i}" for i in range(nc)}}
    kw = dict(augment=True, batch=4, imgsz=64, workers=1, verbose=False)
    vmodel, vvars = jyolo._fused_for_serving()
    want = JaxDetectionValidator()(model=vmodel, variables=vvars, meta=jyolo.meta,
                                   dataset=planted, data=data, args=jax_get_cfg(
                                       overrides={**kw, "save_dir": str(tmp_path / "j")}))
    args = get_cfg({**kw, "project": str(tmp_path)})
    args.save_dir = str(tmp_path / "p")
    got = port_validator.DetectionValidator()(model=pyolo._fused_for_serving(), meta=pyolo.meta,
                                              dataset=planted, args=args, data=data)
    assert want["metrics/mAP50(B)"] > 0.1
    keys = [k for k in want if k.startswith("metrics/") or k == "fitness"]
    assert keys and set(keys) <= set(got)
    for k in keys:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    args.augment = False
    single = port_validator.DetectionValidator()(model=pyolo._fused_for_serving(),
                                                 meta=pyolo.meta, dataset=planted, args=args,
                                                 data=data)
    assert single["metrics/mAP50-95(B)"] != got["metrics/mAP50-95(B)"]


@pytest.fixture(scope="module")
def tinyjde():
    return jax_and_port_yolo("tinyjde.yaml", 3, bias_init=True)


def test_non_detect_heads_warn_and_serve_one_scale(tinyjde, monkeypatch, tmp_path):
    """JDE (and every head but Detect): augment=True warns and gives augment=False's rows and
    metrics, as the JAX predictor and validator do."""
    _, pyolo = tinyjde
    warned = []
    for module in (port_predictor, port_validator):
        monkeypatch.setattr(module.LOGGER, "warning", lambda msg: warned.append(msg))
    frames = _frames()
    kw = dict(imgsz=64, conf=0.05)
    want = pyolo.predict(frames, **kw)
    got = pyolo.predict(frames, augment=True, **kw)
    assert len(warned) == 1 and "Detect-only" in warned[0]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.boxes.data, w.boxes.data)
        np.testing.assert_array_equal(g.embeds, w.embeds)
    val_kw = dict(data="synthetic", imgsz=64, batch=4, workers=1, project=str(tmp_path))
    m_want = pyolo.val(**val_kw)
    m_got = pyolo.val(augment=True, **val_kw)
    assert len(warned) == 2 and "Detect-only" in warned[1]
    assert {k: v for k, v in m_got.items() if not k.startswith("speed")} == \
        {k: v for k, v in m_want.items() if not k.startswith("speed")}
