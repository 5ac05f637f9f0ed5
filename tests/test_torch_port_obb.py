"""The OBB task of the PyTorch port against the JAX package (the heads and graphs:
`test_torch_port_obb_cls_graphs.py`).

(a) `test_rotated_geometry_matches_jax`: `_obb_covariance`, `probiou` (and its CIoU
branch), `dist2rbox` and `xywhr2xyxyxyxy` on random boxes, square boxes (c = 0) and angles
at -pi/4, pi/4 and 3pi/4: within 1e-6 absolute.
(b) `test_decode_obb_matches_jax`: `decode_obb` of random maps: boxes within 1e-6 relative
+ 1e-4 px (random DFL logits reach ~600 px, where a float32 ulp is 6e-5), scores and angles
within 1e-6. `test_rotated_nms_matches_jax`: the same candidates
through both rotated NMS at nc 3 and nc 80 (1200 anchors, pre_topk 1024): equal rows, at an
IoU threshold that no candidate pair's float64 probiou lies within 1e-5 of (so that no
float32 rounding of log / exp decides a suppression).
(c) `test_rotated_assigner_matches_jax`: the rotated assigner's labels, boxes, foreground
and gt indices equal, its scores within 1e-5, on data where no anchor lies within 1e-4 px of
a box edge in the box's own frame.
(d) `test_obb_loss_matches_jax`: `obb_loss` items within 1e-5 relative, the maps' gradient
within 1e-3 relative L2; `test_obb_train_step_matches_jax`: tinyobb's first step (items
within 1e-5, the float64 gradient within 1e-3 relative L2 of JAX's float32 one);
`test_three_steps_match_jax`: 3 SGD steps as `assert_trajectories_match` holds them.
(e) `test_synthetic_obb_items_match_jax`: SyntheticDataset(task="obb") items bit for bit
(the rotated rectangles through `cv.fill_poly` against `cv2.fillPoly`).
(f) `test_obb_validator_matches_jax`: both validators on the same planted detections: the
per-image true positives, the `(B)` metrics within 1e-6 and the rotated save_txt files
equal; `test_yolo_val_matches_jax`: `YOLO.val(data="synthetic")` of tinyobb.
(g) `test_predict_batched_matches_jax`: served xywhr rows as JAX's `OBBPredictor` serves them
(pixel values within 1e-3 px + 1e-5 relative, scores and angles within 1e-4) and
Results.obb; `test_obb_checkpoint_serves_as_obb`.
(h) `test_obb_disk_labels_jax_fault`: JAX reads a DOTA row as a 4-column box, on which its
`obb_loss` fails; the port's `YOLODataset(task="obb")` raises NotImplementedError.
(i) `test_converters_match_jax`: `convert_dota_to_yolo_obb` (a PNG, a JPEG and an Exif-rotated
JPEG, DOTA v1.0 and v2.0 classes) and `convert_coco` (boxes and polygons, with and without
the 91 -> 80 map) write the JAX package's label files byte for byte.
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
from sar_yolo_tpu.ops import boxes as jax_boxes
from sar_yolo_tpu.ops import decode as jax_decode_module
from sar_yolo_tpu.ops import nms as jax_nms_module
from sar_yolo_tpu.utils import loss as jax_loss
from sar_yolo_tpu.utils import metrics as jax_metrics
from sar_yolo_tpu.utils.tal import task_aligned_assigner as jax_assigner
from sar_yolo_tpu_torch import YOLO
from sar_yolo_tpu_torch.cfg.default import get_cfg
from sar_yolo_tpu_torch.data.dataset import SyntheticDataset, YOLODataset
from sar_yolo_tpu_torch.engine import validator as port_validator
from sar_yolo_tpu_torch.engine.predictor import OBBPredictor
from sar_yolo_tpu_torch.engine.trainer import OBBTrainer
from sar_yolo_tpu_torch.ops import boxes
from sar_yolo_tpu_torch.ops.decode import decode_obb
from sar_yolo_tpu_torch.ops.nms import non_max_suppression_rotated
from sar_yolo_tpu_torch.utils import metrics as port_metrics
from sar_yolo_tpu_torch.utils.loss import obb_loss
from sar_yolo_tpu_torch.utils.tal import task_aligned_assigner
from test_torch_port_pose import _first_step_check, _jax_trainer, _nchw
from torch_port_common import (assert_trajectories_match, jax_and_port_yolo,  # noqa: F401
                               one_torch_thread, port_trainer_like)

STRIDES = (8, 16, 32)
GEOM_TOL = 1e-6


def _rboxes(rng, n, squares=False):
    wh = rng.uniform(2, 40, (n, 2))
    if squares:
        wh[:, 1] = wh[:, 0]
    r = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (n, 1))
    r[:4, 0] = [-np.pi / 4, np.pi / 4, 3 * np.pi / 4, 0.0][:min(n, 4)]
    return np.concatenate([rng.uniform(0, 64, (n, 2)), wh, r], 1).astype(np.float32)


# ---- (a) rotated geometry --------------------------------------------------------------------

@pytest.mark.parametrize("squares", [False, True], ids=["rect", "square"])
def test_rotated_geometry_matches_jax(squares):
    rng = np.random.default_rng(1 + squares)
    a, b = _rboxes(rng, 24, squares), _rboxes(rng, 24, squares)
    b[:8, :2] = a[:8, :2] + rng.uniform(-3, 3, (8, 2))  # overlapping pairs
    ta, tb = torch.tensor(a), torch.tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for g, w in zip(boxes._obb_covariance(ta), jax_boxes._obb_covariance(ja)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=GEOM_TOL)
    for ciou in (False, True):
        got = boxes.probiou(ta[:, None], tb[None], CIoU=ciou).numpy()
        want = np.asarray(jax_boxes.probiou(ja[:, None], jb[None], CIoU=ciou))
        assert got.shape == (24, 24, 1) and (got > 0.3).sum() >= 8
        np.testing.assert_allclose(got, want, rtol=0, atol=GEOM_TOL)
    dist = rng.uniform(0, 10, (24, 4)).astype(np.float32)
    ang = a[:, 4:5]
    anchors = rng.uniform(0, 8, (24, 2)).astype(np.float32)
    np.testing.assert_allclose(
        boxes.dist2rbox(torch.tensor(dist), torch.tensor(ang), torch.tensor(anchors)).numpy(),
        np.asarray(jax_boxes.dist2rbox(jnp.asarray(dist), jnp.asarray(ang), jnp.asarray(anchors))),
        rtol=0, atol=GEOM_TOL * 10)  # coordinates up to ~20: 1e-6 relative
    np.testing.assert_allclose(boxes.xywhr2xyxyxyxy(ta).numpy(),
                               np.asarray(jax_boxes.xywhr2xyxyxyxy(ja)), rtol=0,
                               atol=GEOM_TOL * 64)  # coordinates up to ~90: 1e-6 relative


# ---- (b) decode and rotated NMS --------------------------------------------------------------

def _maps(nc, seed, imgsz=64, B=2, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, imgsz // s, imgsz // s, 64 + nc + 1)) * scale)
            .astype(np.float32) for s in STRIDES]


def test_decode_obb_matches_jax():
    maps = _maps(3, 0)
    want = np.asarray(jax_decode_module.decode_obb([jnp.asarray(m) for m in maps], STRIDES, 3))
    got = decode_obb([_nchw(m) for m in maps], STRIDES, 3).numpy()
    assert got.shape == want.shape == (2, 84, 4 + 3 + 1)
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], rtol=0, atol=1e-6)


def _nms_preds(nc, seed, B=2, N=1200):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 160, (B, N, 2))
    wh = rng.uniform(4, 40, (B, N, 2))
    scores = rng.uniform(0, 1, (B, N, nc)) ** 4
    r = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (B, N, 1))
    return np.concatenate([xy, wh, scores, r], -1).astype(np.float32)


def _gap_threshold(preds, nc, conf, want=0.7, margin=1e-5, pre_topk=1024):
    """An IoU threshold near `want` that no pair of candidates' float64 probiou (with the
    class offset as NMS adds it) lies within `margin` of."""
    vals = []
    for p in preds.astype(np.float64):
        score = p[:, 4:4 + nc].max(-1)
        idx = np.argsort(-np.where(score >= conf, score, 0), kind="stable")[:pre_topk]
        idx = idx[score[idx] >= conf]
        b = np.concatenate([p[idx, :4], p[idx, -1:]], -1)
        c = p[idx, 4:4 + nc].argmax(-1)
        off = np.abs(b[:, :2]).max() + b[:, 2:4].max() + 1.0
        b[:, :2] += c[:, None] * off
        t = torch.tensor(b)
        vals.append(boxes.probiou(t[:, None], t[None]).squeeze(-1).numpy().ravel())
    vals = np.sort(np.concatenate(vals))
    for thr in want + np.arange(0, 0.05, 1e-4):
        i = np.searchsorted(vals, thr)
        near = vals[max(i - 1, 0):i + 1]
        if np.all(np.abs(near - thr) > margin):
            return float(thr)
    raise AssertionError("no gap in the candidates' IoUs")


@pytest.mark.parametrize("nc", [3, 80])
def test_rotated_nms_matches_jax(nc):
    preds = _nms_preds(nc, nc)
    conf = 0.05
    thr = _gap_threshold(preds, nc, conf)
    kw = dict(conf_thres=conf, iou_thres=thr, max_det=300, nc=nc)
    want = np.asarray(jax_nms_module.non_max_suppression_rotated(jnp.asarray(preds), **kw))
    got = non_max_suppression_rotated(torch.tensor(preds), **kw).numpy()
    assert got.shape == want.shape == (2, 300, 7)
    kept = (got[..., 5] > 0).sum(1)
    assert (kept > 50).all(), kept
    np.testing.assert_array_equal(got, want)


# ---- (c) the rotated assigner ----------------------------------------------------------------

def test_rotated_assigner_matches_jax():
    rng = np.random.default_rng(4)
    B, M, nc, imgsz = 2, 5, 3, 64
    anc = np.stack(np.meshgrid(np.arange(8) + 0.5, np.arange(8) + 0.5), -1).reshape(-1, 2) * 8
    anc = anc.astype(np.float32)
    N = len(anc)
    gt = np.concatenate([rng.uniform(12, 52, (B, M, 2)), rng.uniform(10, 40, (B, M, 2)),
                         rng.uniform(-np.pi / 4, 3 * np.pi / 4, (B, M, 1))], -1).astype(np.float32)
    mask = (np.arange(M)[None] < np.array([[3], [5]])).astype(np.float32)
    gt *= mask[..., None]
    # no anchor within 1e-4 px of an edge in the box's own frame
    d = anc[None, None] - gt[:, :, None, :2].astype(np.float64)
    r = gt[:, :, None, 4].astype(np.float64)
    dx = d[..., 0] * np.cos(r) + d[..., 1] * np.sin(r)
    dy = -d[..., 0] * np.sin(r) + d[..., 1] * np.cos(r)
    margin = np.minimum(np.abs(np.abs(dx) - gt[:, :, None, 2] / 2),
                        np.abs(np.abs(dy) - gt[:, :, None, 3] / 2))
    assert margin[mask > 0].min() > 1e-4
    pd = np.concatenate([anc + rng.uniform(-2, 2, (N, 2)), rng.uniform(8, 30, (N, 2)),
                         rng.uniform(-0.5, 2.0, (N, 1))], -1)
    pd = np.broadcast_to(pd, (B, N, 5)).astype(np.float32).copy()
    scores = rng.uniform(0, 1, (B, N, nc)).astype(np.float32)
    labels = rng.integers(0, nc, (B, M)).astype(np.float32)
    want = jax_assigner(jnp.asarray(scores), jnp.asarray(pd), jnp.asarray(anc), jnp.asarray(labels),
                        jnp.asarray(gt), jnp.asarray(mask), topk=4, num_classes=nc, rotated=True)
    got = task_aligned_assigner(torch.tensor(scores), torch.tensor(pd), torch.tensor(anc),
                                torch.tensor(labels), torch.tensor(gt), torch.tensor(mask), topk=4,
                                num_classes=nc, rotated=True)
    assert got.fg_mask.sum() >= 8 and got.target_bboxes.shape == (B, N, 5)
    for name in ("target_labels", "target_bboxes", "fg_mask", "target_gt_idx"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(want.target_scores),
                               rtol=1e-5, atol=1e-7)


# ---- (d) the loss and the train step ---------------------------------------------------------

def _targets(seed, B=2, M=6):
    rng = np.random.default_rng(seed)
    wh = rng.uniform(0.1, 0.5, (B, M, 2))
    cxy = rng.uniform(0.25, 0.75, (B, M, 2))
    r = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (B, M, 1))
    mask = (np.arange(M)[None] < np.array([[4], [6]])).astype(np.float32)
    mask[0, 3] = 1.0
    bb = np.concatenate([cxy, wh, r], -1)
    bb[0, 3, 2] = 1.0 / 64  # under 2 px: dropped
    return {"cls": (rng.integers(0, 3, (B, M)) * mask).astype(np.float32),
            "bboxes": (bb * mask[..., None]).astype(np.float32), "mask": mask}


def test_obb_loss_matches_jax():
    nc = 3
    maps, batch = _maps(nc, 1, scale=0.5), _targets(2)
    hyp = jax_get_cfg()
    kw = dict(nc=nc, reg_max=16, strides=STRIDES)

    def jloss(ms):
        out = jax_loss.obb_loss(ms, {k: jnp.asarray(v) for k, v in batch.items()}, hyp, **kw)
        return out.total, out.items
    (_, jitems), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        [jnp.asarray(m) for m in maps])
    feats = [_nchw(m).requires_grad_() for m in maps]
    out = obb_loss(feats, {k: torch.tensor(v) for k, v in batch.items()}, get_cfg(), **kw)
    out.total.backward()
    np.testing.assert_allclose(out.items.numpy(), np.asarray(jitems), rtol=1e-5, atol=1e-7)
    assert (out.items > 0).all()
    g = torch.cat([f.grad.flatten() for f in feats])
    w = torch.cat([_nchw(x).flatten() for x in jgrad])
    assert ((g - w).norm() / w.norm()).item() < 1e-3


def _common(**kw) -> dict:
    return dict(model="tinyobb.yaml", data="synthetic", imgsz=64, batch=2, nbs=2, workers=1,
                max_labels=16, seed=0, optimizer="SGD", warmup_epochs=0.0, **kw)


def test_obb_train_step_matches_jax(tmp_path, monkeypatch):
    common = _common(lr0=1e-4)
    jtr = _jax_trainer(common, tmp_path, monkeypatch, task="obb")
    ptr = port_trainer_like(jtr, common)
    assert isinstance(ptr, OBBTrainer) and ptr.loss_names == ("box", "cls", "dfl")
    assert not ptr.device_augment
    meta = jtr.meta
    _first_step_check(jtr, ptr, jax_loss.obb_loss,
                      dict(nc=meta["nc"], reg_max=meta["reg_max"], strides=tuple(meta["strides"])))


def test_three_steps_match_jax(tmp_path, monkeypatch):
    common = _common(lr0=1e-3)
    jtr = _jax_trainer(common, tmp_path, monkeypatch, task="obb")
    assert_trajectories_match(jtr, port_trainer_like(jtr, common), steps=3)


# ---- (e) synthetic data ----------------------------------------------------------------------

@pytest.mark.parametrize("imgsz", [64, 640])
def test_synthetic_obb_items_match_jax(imgsz):
    kw = dict(n=6, imgsz=imgsz, nc=3, max_labels=8, seed=imgsz, task="obb")
    got, want = SyntheticDataset(**kw), jax_dataset.SyntheticDataset(**kw)
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g.keys() == w.keys() == {"img", "cls", "bboxes", "mask"}
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"item {i} {k}")
        assert g["bboxes"].shape == (8, 5) and g["mask"].sum() >= 1


# ---- (f) validation --------------------------------------------------------------------------

def _planted(dataset, seed):
    """Rotated detections made from the ground truth of `dataset`'s items (moved a little,
    scores spread, a false positive an image), (B, 20, 7)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((len(dataset), 20, 7), np.float32)
    for b in range(len(dataset)):
        it = dataset[b]
        m = it["mask"] > 0
        s = it["img"].shape[0]
        gt = it["bboxes"][m] * [s, s, s, s, 1]
        n = len(gt)
        rows = np.concatenate([gt[:, :2] + rng.normal(0, 1.5, (n, 2)),
                               gt[:, 2:4] * rng.uniform(0.85, 1.15, (n, 2)),
                               gt[:, 4:5] + rng.normal(0, 0.1, (n, 1)),
                               rng.uniform(0.3, 0.95, (n, 1)),
                               np.where(rng.uniform(size=(n, 1)) < 0.8, it["cls"][m][:, None],
                                        (it["cls"][m][:, None] + 1) % 3)], 1)
        fp = [[10, 10, 8, 6, 0.3, 0.5, 0]]
        out[b, :n + 1] = np.concatenate([rows, fp])
    return out


def test_obb_validator_matches_jax(tmp_path, monkeypatch):
    kw = dict(n=8, imgsz=64, nc=3, max_labels=8, seed=3, task="obb")
    dets = _planted(SyntheticDataset(**kw), 0)
    recorded = {"port": [], "jax": []}
    for name, mod in (("port", port_metrics), ("jax", jax_metrics)):
        orig = mod.DetMetrics.update

        def update(self, tp, conf, cls, gt_cls, _orig=orig, _name=name):
            recorded[_name].append((np.array(tp), np.array(conf), np.array(cls)))
            return _orig(self, tp, conf, cls, gt_cls)
        monkeypatch.setattr(mod.DetMetrics, "update", update)
    monkeypatch.setattr(port_validator.OBBValidator, "postprocess",
                        lambda self, feats: torch.tensor(dets))
    monkeypatch.setattr(jax_nms_module, "non_max_suppression_rotated",
                        lambda preds, **k: jnp.asarray(dets))
    monkeypatch.setattr(jax_decode_module, "decode_obb", lambda feats, *a, **k: feats)

    class JaxModel:
        def apply(self, variables, img, train=False):
            return img
    meta = {"nc": 3, "strides": list(STRIDES), "reg_max": 16}
    data = {"names": {0: "a", 1: "b", 2: "c"}}
    common = dict(batch=8, workers=1, save_txt=True, save_conf=True, conf=0.001)
    jargs = jax_get_cfg(overrides={**common, "plots": False})
    jargs.save_dir = str(tmp_path / "jax")
    want = jax_validator.OBBValidator()(model=JaxModel(), variables={}, meta=meta,
                                        dataset=jax_dataset.SyntheticDataset(**kw), args=jargs,
                                        data=data)
    args = get_cfg(common)
    args.save_dir = str(tmp_path / "port")
    got = port_validator.OBBValidator()(model=torch.nn.Conv2d(3, 1, 1), meta=meta,
                                        dataset=SyntheticDataset(**kw), args=args, data=data)
    assert len(recorded["port"]) == len(recorded["jax"]) == 8
    for g, w in zip(recorded["port"], recorded["jax"]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert 0 < got["metrics/mAP50-95(B)"] < 1 and got["metrics/mAP50(B)"] > 0.3
    assert got.keys() == want.keys()
    for k in set(want) - {"speed/ms_per_image"}:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    files = sorted(p.name for p in (tmp_path / "jax" / "labels").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port" / "labels").iterdir())
    assert len(files) == 8
    for f in files:
        text = (tmp_path / "port" / "labels" / f).read_text()
        assert text == (tmp_path / "jax" / "labels" / f).read_text() and len(text.split()[0]) == 1


@pytest.fixture(scope="module")
def obb_pair():
    return jax_and_port_yolo("tinyobb.yaml", 4, cls_gain=0.3, box_gain=0.1, calibrate=64)


def _sorted_rows(d):
    d = d[d[:, 5] > 0]
    return d[np.lexsort((d[:, 3], d[:, 2], d[:, 1], d[:, 0], d[:, 6]))]


def _same_rows(got, want):
    """The same kept rows: classes equal, pixel values within 1e-3 px + 1e-5 of their size,
    angles and scores within 1e-4."""
    assert got.shape == want.shape
    for g, w in zip(got, want):
        gs, ws = _sorted_rows(g), _sorted_rows(w)
        assert len(gs) == len(ws) > 0
        np.testing.assert_array_equal(gs[:, 6], ws[:, 6])
        np.testing.assert_allclose(gs[:, :4], ws[:, :4], rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(gs[:, 4:6], ws[:, 4:6], rtol=0, atol=1e-4)


def test_yolo_val_matches_jax(obb_pair, tmp_path, monkeypatch):
    jyolo, pyolo = obb_pair
    seen = {"port": [], "jax": []}
    for name, mod in (("port", port_metrics), ("jax", jax_metrics)):
        orig = mod.DetMetrics.update

        def update(self, tp, conf, cls, gt_cls, _orig=orig, _name=name):
            seen[_name].append((np.array(tp), np.array(conf), np.array(cls)))
            return _orig(self, tp, conf, cls, gt_cls)
        monkeypatch.setattr(mod.DetMetrics, "update", update)
    kw = dict(data="synthetic", imgsz=64, batch=6, conf=0.2, name="val", exist_ok=True)
    want = jyolo.val(plots=False, project=str(tmp_path / "jax"), **kw)
    got = pyolo.val(project=str(tmp_path / "port"), **kw)
    assert len(seen["port"]) == len(seen["jax"]) == 16
    assert sum(len(c) for _, c, _ in seen["port"]) > 16
    for (gtp, gc, gk), (wtp, wc, wk) in zip(seen["port"], seen["jax"]):
        o, p = np.lexsort((gc, gk)), np.lexsort((wc, wk))
        np.testing.assert_array_equal(gk[o], wk[p])
        np.testing.assert_allclose(gc[o], wc[p], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(gtp[o], wtp[p])
    for k in set(want) - {"speed/ms_per_image"}:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


# ---- (g) serving -----------------------------------------------------------------------------

def test_predict_batched_matches_jax(obb_pair):
    jyolo, pyolo = obb_pair
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 48, 80, 3), np.uint8)
    kw = dict(imgsz=64, conf=0.2)
    assert type(pyolo._get_predictor(kw)) is OBBPredictor
    want = np.asarray(jyolo.predict_batched(frames, **kw))
    got = pyolo.predict_batched(frames, **kw)
    assert got.shape == (2, 300, 7)
    _same_rows(got, want)
    res, jres = pyolo.predict(list(frames), **kw), jyolo.predict(list(frames), **kw)
    for r, j in zip(res, jres):
        assert r.boxes is None and r.probs is None and len(r) == len(j.obb) > 0
        jd = np.asarray(j.obb.data)
        o, p = np.lexsort(r.obb.data[:, :4].T[::-1]), np.lexsort(jd[:, :4].T[::-1])
        np.testing.assert_allclose(r.obb.data[o], jd[p], rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(r.obb.xyxyxyxy[o], j.obb.xyxyxyxy[p], rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(r.obb.xyxy[o], j.obb.xyxy[p], rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(r.obb.cls, r.obb.data[:, 6])


def test_obb_checkpoint_serves_as_obb(tmp_path):
    m = YOLO("tinyobb.yaml", device="cpu")
    metrics = m.train(data="synthetic", imgsz=64, batch=4, epochs=1, workers=1,
                      project=str(tmp_path))
    assert "metrics/mAP50-95(B)" in metrics and "train/dfl" in metrics
    ck = YOLO(m.ckpt_dir, device="cpu")
    assert ck.task == "obb" and ck.meta["head"] == "OBB"
    frames = np.random.default_rng(1).integers(0, 256, (2, 48, 80, 3), np.uint8)
    np.testing.assert_array_equal(ck.predict_batched(frames, imgsz=64, conf=0.01),
                                  m.predict_batched(frames, imgsz=64, conf=0.01))
    assert "metrics/mAP50(B)" in ck.val(data="synthetic", imgsz=64, batch=8, project=str(tmp_path))


# ---- (h) the JAX fault -----------------------------------------------------------------------

def test_obb_disk_labels_jax_fault(tmp_path):
    """A DOTA-style row `class x1 y1 ... x4 y4` takes the JAX YOLODataset's detect branch
    (`dataset.py:290-293`) and becomes a 4-column box, on which JAX's `obb_loss` fails; the
    port refuses the task in YOLODataset instead."""
    import cv2
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    cv2.imwrite(str(tmp_path / "images" / "0.png"), np.full((64, 64, 3), 90, np.uint8))
    (tmp_path / "labels" / "0.txt").write_text("0 0.2 0.2 0.6 0.25 0.7 0.6 0.3 0.55\n")
    jds = jax_dataset.YOLODataset(str(tmp_path / "images"), imgsz=64, task="obb", max_labels=4)
    item = jds[0]
    assert item["bboxes"].shape == (4, 4)
    batch = {k: jnp.asarray(item[k][None]) for k in ("cls", "bboxes", "mask")}
    with pytest.raises(ValueError, match="squeeze"):
        jax_loss.obb_loss([jnp.asarray(m[:1]) for m in _maps(1, 0)], batch, jax_get_cfg(), nc=1,
                          reg_max=16, strides=STRIDES)
    with pytest.raises(NotImplementedError, match="no OBB label branch"):
        YOLODataset(str(tmp_path / "images"), imgsz=64, task="obb")
    with pytest.raises(NotImplementedError, match="no OBB label branch"):
        OBBTrainer(dict(model="tinyobb.yaml", data={"path": str(tmp_path), "train": "images",
                                                    "names": {0: "plane"}}, imgsz=64,
                        project=str(tmp_path)), device="cpu").setup()


# ---- (i) the converters ----------------------------------------------------------------------

def _dota_tree(root):
    """A DOTA tree: a PNG, a 720x1280 JPEG and an Exif-rotated JPEG (orientation 6: its
    decoded image is transposed), each with corner annotations, headers and odd rows."""
    import shutil

    import cv2
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / f"{split}_original").mkdir(parents=True)
    cv2.imwrite(str(root / "images" / "train" / "P0001.png"), np.zeros((100, 200, 3), np.uint8))
    jpeg = Path(__file__).resolve().parent / "data" / "jpeg"
    shutil.copy(jpeg / "frames" / "frame_03.jpg", root / "images" / "train" / "P0002.jpg")
    shutil.copy(jpeg / "variants" / "exif_orientation_6.jpg", root / "images" / "val" / "P0003.jpg")
    rows = ("imagesource:GoogleEarth\ngsd:0.1\n20 10 180 10 180 90 20 90 plane 0\n"
            "0 0 10 0 10 10 0 10 small-vehicle 1\n5 5 6 5 6 6 5 6 unknown-thing 0\n"
            "1 2 3 4 5 6 7 8 ground track field 1\nbad row\n33.5 7 40 9 38 30 31 28 harbor\n")
    for stem, split in (("P0001", "train"), ("P0002", "train"), ("P0003", "val"), ("P0004", "val")):
        (root / "labels" / f"{split}_original" / f"{stem}.txt").write_text(rows)


@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_converters_match_jax(tmp_path, version):
    from sar_yolo_tpu.data import converter as jax_converter
    from sar_yolo_tpu_torch.data import converter
    for name, mod in (("port", converter), ("jax", jax_converter)):
        _dota_tree(tmp_path / name)
        mod.convert_dota_to_yolo_obb(tmp_path / name, version=version)
    for split in ("train", "val"):
        got = sorted((tmp_path / "port" / "labels" / split).iterdir())
        want = sorted((tmp_path / "jax" / "labels" / split).iterdir())
        assert [p.name for p in got] == [p.name for p in want] and len(got) >= 1
        for g, w in zip(got, want):
            assert g.read_text() == w.read_text() and len(g.read_text().splitlines()) == 4
    ann = {"images": [{"id": i, "file_name": f"im{i}.jpg", "width": 100 + i, "height": 80}
                      for i in (1, 2)],
           "annotations": [{"image_id": 1, "category_id": 1, "bbox": [10, 20, 30, 40],
                            "iscrowd": 0, "segmentation": [[10, 20, 40, 20, 40, 60]]},
                           {"image_id": 1, "category_id": 90, "bbox": [1, 2, 3, 4], "iscrowd": 0},
                           {"image_id": 2, "category_id": 13, "bbox": [5, 5, 9, 9], "iscrowd": 1},
                           {"image_id": 2, "category_id": 44, "bbox": [5, 5, 9, 9], "iscrowd": 0}]}
    import json
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    for seg in (False, True):
        outs = [mod.convert_coco(tmp_path / "ann.json", save_dir=tmp_path / f"{name}{seg}",
                                 use_segments=seg, cls91to80=version == "1.0")
                for name, mod in (("port", converter), ("jax", jax_converter))]
        for stem in ("im1", "im2"):
            assert (outs[0] / "labels" / f"{stem}.txt").read_text() == \
                (outs[1] / "labels" / f"{stem}.txt").read_text()
    assert converter.coco80_to_coco91_class() == jax_converter.coco80_to_coco91_class()
