"""The segment task of the PyTorch port against the JAX package and OpenCV (the heads and
graphs: `test_torch_port_pose_seg_graphs.py`).

(a) `test_fill_poly_matches_cv2`: `data/cv.py::fill_poly` equal to `cv2.fillPoly` on 240
seeded polygons (convex and not, self-touching, repeated and collinear vertices, one and two
points, vertices far off the canvas) in uint8 and float32 maps;
`test_resize_nearest_cv_matches_cv2`: `resize_nearest_cv` equal to INTER_NEAREST.
(b) `test_crop_and_process_mask_match_jax`: `crop_mask` equal; `process_mask`'s booleans
identical wherever |sigmoid - 0.5| > 1e-6, at the prototypes' resolution and upsampled.
(c) `test_segmentation_loss_matches_jax`: items within 1e-5 relative and the gradient of maps
and prototypes within 1e-3 relative L2, with gt masks at the prototypes' size and at twice
it (JAX's nearest resize), and with every weight tied (`lax.top_k`'s order).
(d) `test_segment_train_step_matches_jax` / `test_three_steps_match_jax`: tinyseg from the JAX
trainer's weights on synthetic data, as the pose file holds tinypose.
(e) `test_segment_items_match_jax`: a polygon dataset of PNG files: train items (mosaic,
copy-paste through the polygons, affine, flips, mixup) and val / rect items bit for bit,
masks included; `test_augmentations_carry_polygons`; the label cache each package reads.
(f) `test_segment_validator_matches_jax`: both validators on the same rows and prototypes
(masks made to cover the ground truth): `(B)` and `(M)` keys within 1e-6;
`test_yolo_val_matches_jax`: `YOLO.val(data="synthetic")` of tinyseg: rows (scores within
1e-4, boxes 1e-3 px, raw coefficients 1e-4 + 1e-5 of their size) and metrics within 1e-6.
(g) `test_predict_batched_matches_jax`: rows within 1e-4 (1e-3 px), masks equal where the
mask probability is not within 1e-4 of 0.5; `YOLO.predict`'s Results.masks, and their
`Masks.xy` / `xyn` contours equal to JAX's.
(h) The JAX behaviours: `test_rect_val_masks_are_square` (gt masks are imgsz / 4 square in
rect batches, stretched to the prototypes' grid in the validator) and
`test_masks_stay_in_letterbox_space`; `test_multi_scale_resizes_masks_as_jax`; the segment
task stays on the host route; the keys pose, kobj, overlap_mask, mask_ratio and
retina_masks are accepted; `test_segment_checkpoint_serves_as_segment`.
"""

import copy
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.cfg import get_cfg as jax_get_cfg
from sar_yolo_tpu.data import augment as jax_augment
from sar_yolo_tpu.data import dataset as jax_dataset
from sar_yolo_tpu.engine import trainer as jax_trainer_module
from sar_yolo_tpu.engine import validator as jax_validator
from sar_yolo_tpu.engine.results import Masks as JaxMasks
from sar_yolo_tpu.ops import masks as jax_masks
from sar_yolo_tpu.utils import loss as jax_loss
from sar_yolo_tpu_torch import YOLO
from sar_yolo_tpu_torch.cfg.default import DEFAULT_CFG, get_cfg
from sar_yolo_tpu_torch.data import augment, cv
from sar_yolo_tpu_torch.data.dataset import YOLODataset
from sar_yolo_tpu_torch.engine import validator as port_validator
from sar_yolo_tpu_torch.engine.predictor import SegmentPredictor
from sar_yolo_tpu_torch.engine.trainer import SegmentTrainer
from sar_yolo_tpu_torch.ops.masks import crop_mask, process_mask
from sar_yolo_tpu_torch.utils.loss import segmentation_loss
from test_torch_port_pose import _common, _first_step_check, _jax_trainer, _record_dets, _smooth
from torch_port_common import (assert_trajectories_match, jax_and_port_yolo,  # noqa: F401
                               one_torch_thread, port_trainer_like)

STRIDES = (8, 16, 32)


# ---- (a) OpenCV's fillPoly and INTER_NEAREST -------------------------------------------------

def _polygon(rng, kind: str, h: int, w: int):
    if kind == "points":  # one or two vertices, or a vertex repeated
        n = int(rng.integers(1, 4))
        p = rng.integers(-3, max(h, w) + 3, (n, 2))
        return np.concatenate([p, p[:1]]) if n == 3 else p
    if kind == "star":  # non-convex, edges crossing, collinear runs
        n = int(rng.integers(5, 12))
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        rad = rng.uniform(0.2, 0.6, n) * min(h, w) * np.where(np.arange(n) % 2, 1, 0.4)
        p = np.stack([w / 2 + rad * np.cos(ang), h / 2 + rad * np.sin(ang)], 1)
        return np.round(p[rng.permutation(n)] if rng.random() < 0.3 else p)
    if kind == "touching":  # a vertex visited twice, a zero-area spike
        p = rng.integers(0, min(h, w), (int(rng.integers(3, 7)), 2))
        return np.concatenate([p, p[:1], p[1:2] + 1, p[:1]])
    return rng.integers(-2 * w, 3 * w, (int(rng.integers(3, 9)), 2))  # far off the canvas


@pytest.mark.parametrize("kind", ["points", "star", "touching", "off_canvas"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_fill_poly_matches_cv2(kind, dtype):
    rng = np.random.default_rng(["points", "star", "touching", "off_canvas"].index(kind))
    value = 1 if dtype == np.uint8 else 3.0
    for _ in range(30):
        h, w = (int(v) for v in rng.integers(8, 48, 2))
        poly = _polygon(rng, kind, h, w).astype(np.int32)
        want = np.zeros((h, w), dtype)
        cv2.fillPoly(want, [poly], value)
        got = cv.fill_poly(np.zeros((h, w), dtype), poly, value)
        np.testing.assert_array_equal(got, want, err_msg=str(poly.tolist()))


def test_resize_nearest_cv_matches_cv2():
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 9, (40, 56)).astype(np.float32)
    for h, w in ((96, 168), (40, 56), (13, 7), (160, 160), (57, 41)):
        np.testing.assert_array_equal(cv.resize_nearest_cv(src, (w, h)),
                                      cv2.resize(src, (w, h), interpolation=cv2.INTER_NEAREST))


# ---- (b) masks -------------------------------------------------------------------------------

def test_crop_and_process_mask_match_jax():
    rng = np.random.default_rng(1)
    protos = rng.standard_normal((16, 20, 8)).astype(np.float32)  # (mh, mw, nm)
    coeffs = rng.standard_normal((12, 8)).astype(np.float32)
    xy = rng.uniform(-10, 70, (12, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (12, 2))], 1).astype(np.float32)
    m = rng.uniform(0, 1, (12, 16, 20)).astype(np.float32)
    np.testing.assert_array_equal(crop_mask(torch.tensor(m), torch.tensor(boxes / 4)).numpy(),
                                  np.asarray(jax_masks.crop_mask(jnp.asarray(m),
                                                                 jnp.asarray(boxes / 4))))
    p = torch.tensor(protos).permute(2, 0, 1)
    prob = torch.einsum("nc,chw->nhw", torch.tensor(coeffs).double(), p.double()).sigmoid()
    for upsample, size in ((False, (16, 20)), (True, (64, 80))):
        want = np.asarray(jax_masks.process_mask(jnp.asarray(protos), jnp.asarray(coeffs),
                                                 jnp.asarray(boxes), (64, 80), upsample=upsample))
        got = process_mask(p, torch.tensor(coeffs), torch.tensor(boxes), (64, 80),
                           upsample=upsample).numpy()
        assert got.shape == want.shape == (12, *size) and got.dtype == bool
        if not upsample:
            far = (prob - 0.5).abs().numpy() > 1e-6
            np.testing.assert_array_equal(got[far], want[far])
        else:
            assert (got != want).mean() < 1e-3
        assert 0.01 < got.mean() < 0.5


# ---- (c) the loss ----------------------------------------------------------------------------

def _seg_batch(seed, mh, B=2, M=5, imgsz=64):
    rng = np.random.default_rng(seed)
    wh = rng.uniform(0.15, 0.5, (B, M, 2))
    cxy = rng.uniform(wh / 2, 1 - wh / 2)
    mask = (np.arange(M)[None] < np.array([[3], [5]])).astype(np.float32)
    masks = np.zeros((B, mh, mh), np.float32)
    for b in range(B):
        for j in range(int(mask[b].sum())):
            x1, y1 = ((cxy[b, j] - wh[b, j] / 2) * mh).astype(int)
            x2, y2 = ((cxy[b, j] + wh[b, j] / 2) * mh).astype(int)
            masks[b, y1:y2, x1:x2] = j + 1
    return {"cls": (rng.integers(0, 2, (B, M)) * mask).astype(np.float32),
            "bboxes": (np.concatenate([cxy, wh], -1) * mask[..., None]).astype(np.float32),
            "mask": mask, "masks": masks}


@pytest.mark.parametrize("case", ["same_size", "masks_2x", "tied_weights"])
def test_segmentation_loss_matches_jax(case):
    nc, nm = 2, 8
    rng = np.random.default_rng(3)
    maps = [(rng.standard_normal((2, 64 // s, 64 // s, 64 + nc + nm)) * 0.5).astype(np.float32)
            for s in STRIDES]
    if case == "tied_weights":  # every class logit equal: assigned weights tie widely
        for m in maps:
            m[..., 64:64 + nc] = 0.3
    protos = rng.standard_normal((2, 16, 16, nm)).astype(np.float32)
    batch = _seg_batch(4, 32 if case == "masks_2x" else 16)
    hyp = jax_get_cfg()
    kw = dict(nc=nc, reg_max=16, strides=STRIDES, nm=nm)

    def jloss(ms, pr):
        out = jax_loss.segmentation_loss((ms, pr), {k: jnp.asarray(v) for k, v in batch.items()},
                                         hyp, **kw)
        return out.total, out.items
    (_, jitems), (jg_maps, jg_pr) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(m) for m in maps], jnp.asarray(protos))

    def nchw(a):
        return torch.tensor(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))
    feats = [nchw(m).requires_grad_() for m in maps]
    pr = nchw(protos).requires_grad_()
    out = segmentation_loss((feats, pr), {k: torch.tensor(v) for k, v in batch.items()},
                            get_cfg(), **kw)
    out.total.backward()
    np.testing.assert_allclose(out.items.numpy(), np.asarray(jitems), rtol=1e-5, atol=1e-8)
    assert (out.items > 0).all()
    g = torch.cat([f.grad.flatten() for f in feats] + [pr.grad.flatten()])
    w = torch.cat([nchw(x).flatten() for x in jg_maps] + [nchw(jg_pr).flatten()])
    assert ((g - w).norm() / w.norm()).item() < 1e-3


# ---- (d) the train step ----------------------------------------------------------------------

def _seg_common(**kw):
    return {**_common(**kw), "model": "tinyseg.yaml"}


def test_segment_train_step_matches_jax(tmp_path, monkeypatch):
    common = _seg_common(lr0=1e-4)
    jtr = _jax_trainer(common, tmp_path, monkeypatch, task="segment")
    ptr = port_trainer_like(jtr, common)
    assert isinstance(ptr, SegmentTrainer) and ptr.loss_names == ("box", "seg", "cls", "dfl")
    meta = jtr.meta
    _first_step_check(jtr, ptr, jax_loss.segmentation_loss,
                      dict(nc=meta["nc"], reg_max=meta["reg_max"], strides=tuple(meta["strides"]),
                           nm=meta["nm"]))


def test_three_steps_match_jax(tmp_path, monkeypatch):
    common = _seg_common(lr0=1e-3)
    jtr = _jax_trainer(common, tmp_path, monkeypatch, task="segment")
    assert_trajectories_match(jtr, port_trainer_like(jtr, common), steps=3)


# ---- (e) host data ---------------------------------------------------------------------------

SHAPES = [(90, 160), (160, 90), (100, 100), (72, 128)]


def _poly_rows(rng, n):
    rows = []
    for _ in range(n):
        c = rng.uniform(0.2, 0.8, 2)
        k = int(rng.integers(3, 9))
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        r = rng.uniform(0.04, 0.2, k)
        p = np.clip(c + np.stack([np.cos(ang), np.sin(ang)], 1) * r[:, None], 0, 1)
        rows.append(f"{rng.integers(0, 2)} " + " ".join(f"{v:.6f}" for v in p.ravel()))
    return rows


def write_seg_dataset(root, n_train, n_val, seed=0):
    """A 2-class polygon dataset of PNG frames; its dataset dict."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            cv2.imwrite(str(root / "images" / split / f"{i:03d}.png"),
                        _smooth(rng, *SHAPES[i % len(SHAPES)]))
            (root / "labels" / split / f"{i:03d}.txt").write_text(
                "\n".join(_poly_rows(rng, int(rng.integers(1, 7)))) + "\n")
    return {"path": str(root), "train": "images/train", "val": "images/val",
            "names": {0: "a", 1: "b"}}


@pytest.fixture(scope="module")
def seg_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg_data")
    return root, write_seg_dataset(root, 12, 6)


def _pair(root, split, augment, **hyp):
    kw = dict(imgsz=64, max_labels=16, task="segment")
    path = str(root / "images" / split)
    return (YOLODataset(path, augment=augment, hyp=get_cfg(hyp), **kw),
            jax_dataset.YOLODataset(path, augment=augment, hyp=jax_get_cfg(overrides=hyp), **kw))


def _same_items(got, want):
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g.keys() == w.keys() and "masks" in g
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"item {i} {k}")


@pytest.mark.parametrize("hyp", [{"seed": 0, "copy_paste": 0.9},
                                 {"seed": 4, "mixup": 0.7, "flipud": 0.5, "copy_paste": 0.5,
                                  "degrees": 15.0, "shear": 3.0}],
                         ids=["copy_paste", "mixup-flipud-rotate-shear"])
def test_segment_items_match_jax(seg_dir, hyp):
    root, _ = seg_dir
    got, want = _pair(root, "train", True, **hyp)
    _same_items(got, want)
    assert any(got[i]["masks"].max() > 1 for i in range(len(got)))
    got.mosaic_enabled = want.mosaic_enabled = False
    _same_items(got, want)
    got, want = _pair(root, "val", False)
    _same_items(got, want)
    got.init_rect(4)
    want.init_rect(4)
    _same_items(got, want)


def test_segment_label_cache_is_shared(seg_dir, monkeypatch):
    from sar_yolo_tpu_torch.data import dataset as port_dataset
    root, _ = seg_dir
    path = str(root / "images" / "val")
    cache = root / "labels" / "val.cache.npz"
    cache.unlink(missing_ok=True)
    want = jax_dataset.YOLODataset(path, imgsz=64, task="segment")
    monkeypatch.setattr(port_dataset, "image_shape", None)
    got = YOLODataset(path, imgsz=64, task="segment")
    for g, w in zip(got.labels, want.labels):
        assert g.keys() == w.keys() == {"cls", "bboxes", "tags", "polygons"}
        for a, b in zip(g["polygons"], w["polygons"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(g["bboxes"], w["bboxes"])
    monkeypatch.undo()
    cache.unlink()
    YOLODataset(path, imgsz=64, task="segment")
    monkeypatch.setattr(jax_dataset, "_image_shape", None)
    again = jax_dataset.YOLODataset(path, imgsz=64, task="segment")
    np.testing.assert_array_equal(again.labels[1]["polygons"][0], want.labels[1]["polygons"][0])


def test_augmentations_carry_polygons():
    rng = np.random.default_rng(8)
    items = []
    for _ in range(4):
        h = int(rng.integers(40, 64))
        polys = [np.array([[float(v) for v in p.split()[1:]]]).reshape(-1, 2) * [64, h]
                 for p in _poly_rows(rng, int(rng.integers(1, 5)))]
        polys = [p.astype(np.float32) for p in polys]
        boxes = np.array([[p[:, 0].min(), p[:, 1].min(), p[:, 0].max(), p[:, 1].max()]
                          for p in polys], np.float32)
        items.append({"img": _smooth(rng, h, 64), "cls": np.zeros(len(polys), np.float32),
                      "bboxes": boxes, "polygons": polys})
    out = {}
    for name, mod in (("port", augment), ("jax", jax_augment)):
        r = np.random.default_rng(12)
        it = mod.mosaic4([{k: (v.copy() if k != "polygons" else [p.copy() for p in v])
                           for k, v in x.items()} for x in items], 64, rng=r)
        border = it.pop("mosaic_border")
        it = mod.copy_paste(it, p=0.9, rng=r)
        it = mod.random_perspective(it, degrees=20.0, translate=0.2, scale=0.5, border=border,
                                    rng=r)
        it = mod.mixup(it, {"img": np.full_like(it["img"], 9), "cls": items[0]["cls"].copy(),
                            "bboxes": items[0]["bboxes"].copy(),
                            "polygons": [p.copy() for p in items[0]["polygons"]]}, rng=r)
        it = mod.random_flip(it, fliplr=0.5, flipud=0.5, rng=r)
        out[name] = it
    g, w = out["port"], out["jax"]
    assert g.keys() == w.keys() and len(g["polygons"]) == len(w["polygons"]) > 4
    for k in ("img", "cls", "bboxes"):
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    for a, b in zip(g["polygons"], w["polygons"]):
        np.testing.assert_array_equal(a, b)


# ---- (f) validation --------------------------------------------------------------------------

def test_segment_validator_matches_jax():
    """Prototype j is +8 inside ground truth j's map and -8 outside; detection j's coefficient
    picks it (one of them for the wrong class, one a spare box), so the masks overlap the
    ground truth at IoUs below and above the thresholds."""
    rng = np.random.default_rng(2)
    B, M, nm, S, mh = 2, 4, 6, 64, 16
    batch = _seg_batch(9, mh, B=B, M=M)
    protos = np.full((B, mh, mh, nm), -8.0, np.float32)
    dets = np.zeros((B, 10, 6 + nm), np.float32)
    for b in range(B):
        n = int(batch["mask"][b].sum())
        for j in range(n):
            region = batch["masks"][b] == j + 1
            region = np.roll(region, int(rng.integers(-1, 2)), 1)
            protos[b][region, j] = 8.0
            cx, cy, w, h = batch["bboxes"][b, j] * S
            jit = rng.normal(0, 1.0, 4)
            dets[b, j, :6] = [cx - w / 2 + jit[0], cy - h / 2 + jit[1], cx + w / 2 + jit[2],
                              cy + h / 2 + jit[3], rng.uniform(0.3, 0.9), batch["cls"][b, j]]
            dets[b, j, 6 + j] = 1.0
        dets[b, n, :6] = [2, 2, 30, 30, 0.6, 1 - batch["cls"][b, 0]]
        dets[b, n, 6] = 1.0
    batch["img"] = np.zeros((B, S, S, 3), np.uint8)
    out = []
    for mod, pr in ((port_validator, protos.transpose(0, 3, 1, 2)), (jax_validator, protos)):
        v = mod.SegmentValidator()
        v.meta, v.data = {"nc": 2, "nm": nm}, {"names": {0: "a", 1: "b"}}
        v.args = get_cfg() if mod is port_validator else jax_get_cfg()
        v.init_metrics()
        v._protos = np.ascontiguousarray(pr)
        v.update_metrics(dets, batch, (S, S))
        out.append(v.finalize_metrics())
    got, want = out
    assert got.keys() == want.keys() and "metrics/mAP50-95(M)" in got
    assert 0 < got["metrics/mAP50-95(M)"] < 1
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


@pytest.fixture(scope="module")
def seg_pair():
    return jax_and_port_yolo("tinyseg.yaml", 4, cls_gain=0.3, box_gain=0.1, calibrate=64)


def _sorted(d, masks=None):
    keep = d[:, 4] > 0
    order = np.lexsort((d[keep, 3], d[keep, 2], d[keep, 1], d[keep, 0], d[keep, 5]))
    return d[keep][order], (None if masks is None else masks[keep][order])


def test_yolo_val_matches_jax(seg_pair, tmp_path, monkeypatch):
    jyolo, pyolo = seg_pair
    kw = dict(data="synthetic", imgsz=64, batch=6, conf=0.2, name="val", exist_ok=True)
    jdets = _record_dets(monkeypatch, jax_validator)
    pdets = _record_dets(monkeypatch, port_validator)
    want = jyolo.val(plots=False, project=str(tmp_path / "jax"), **kw)
    got = pyolo.val(project=str(tmp_path / "port"), **kw)
    assert [len(d) for d in pdets] == [len(d) for d in jdets] == [6, 6, 4]
    for g, w in zip(pdets, jdets):
        assert g.shape[1:] == (300, 6 + 16)
        for gb, wb in zip(g, w):
            (gs, _), (ws, _) = _sorted(gb), _sorted(wb)
            assert len(gs) == len(ws) > 0
            np.testing.assert_allclose(gs[:, :4], ws[:, :4], rtol=0, atol=1e-3)
            np.testing.assert_allclose(gs[:, 4], ws[:, 4], rtol=0, atol=1e-4)
            # raw mask coefficients (up to ~10): 1e-4 + 1e-5 of their size
            np.testing.assert_allclose(gs[:, 6:], ws[:, 6:], rtol=1e-5, atol=1e-4)
    assert "metrics/mAP50(M)" in got
    for k in set(want) - {"speed/ms_per_image"}:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


# ---- (g) serving -----------------------------------------------------------------------------

def test_predict_batched_matches_jax(seg_pair):
    jyolo, pyolo = seg_pair
    rng = np.random.default_rng(0)
    frames = np.stack([_smooth(rng, 48, 80) for _ in range(2)])
    kw = dict(imgsz=64, conf=0.2)
    predictor = pyolo._get_predictor(kw)
    assert type(predictor) is SegmentPredictor
    wd, wm = (np.asarray(a) for a in jyolo.predict_batched(frames, **kw))
    gd, gm = pyolo.predict_batched(frames, **kw)
    assert gd.shape == wd.shape == (2, 300, 6) and gm.shape == wm.shape == (2, 300, 16, 16)
    assert gm.dtype == bool
    x, _, _ = predictor.preprocess(frames)
    with torch.no_grad():
        feats, protos = predictor.model(x)
        rows = predictor.decode_nms(feats)
        prob = torch.einsum("bnc,bchw->bnhw", rows[..., 6:], protos).sigmoid()
    for b in range(2):
        (gs, gms), (ws, wms) = _sorted(gd[b], gm[b]), _sorted(wd[b], wm[b])
        assert len(gs) == len(ws) > 0
        np.testing.assert_allclose(gs[:, :4], ws[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(gs[:, 4], ws[:, 4], rtol=0, atol=1e-4)
        keep = gd[b][:, 4] > 0
        order = np.lexsort((gd[b][keep, 3], gd[b][keep, 2], gd[b][keep, 1], gd[b][keep, 0],
                            gd[b][keep, 5]))
        near = ((prob[b][torch.from_numpy(keep)] - 0.5).abs().numpy() <= 1e-4)[order]
        np.testing.assert_array_equal(gms[~near], wms[~near])
        assert gms.any()
    res = pyolo.predict(list(frames), **kw)
    want = jyolo.predict(list(frames), **kw)
    contours = 0
    for b, (r, w) in enumerate(zip(res, want)):
        assert r.masks is not None and r.masks.data.shape == (len(r), 16, 16)
        np.testing.assert_allclose(np.sort(r.boxes.data[:, 4]), np.sort(gd[b][gd[b][:, 4] > 0, 4]),
                                   rtol=0, atol=1e-5)  # one frame against a batch of two
        # the contours: JAX's Masks.xy / xyn (cv2.findContours) of the same masks, and of
        # JAX's own masks where they are equal
        jm = JaxMasks(r.masks.data, r.orig_shape)
        for got_xy, want_xy in zip(r.masks.xy, jm.xy):
            assert got_xy.dtype == np.float32
            np.testing.assert_array_equal(got_xy, want_xy)
            contours += len(got_xy) > 0
        for got_xyn, want_xyn in zip(r.masks.xyn, jm.xyn):
            np.testing.assert_array_equal(got_xyn, want_xyn)
        for k in range(min(len(r), len(w))):
            if np.array_equal(r.masks.data[k], np.asarray(w.masks.data[k])):
                np.testing.assert_array_equal(r.masks.xy[k], w.masks.xy[k])
    assert contours > 0


# ---- (h) the JAX behaviours and the rest -----------------------------------------------------

def test_rect_val_masks_are_square(seg_dir, monkeypatch):
    """In a rect batch (64 x 96 here) the gt masks stay imgsz / 4 square (16 x 16) in both
    packages, and the validator stretches them to the prototypes' 16 x 24 by INTER_NEAREST."""
    root, _ = seg_dir
    got, want = _pair(root, "val", False)
    got.init_rect(2)
    want.init_rect(2)
    shapes = [got[i]["img"].shape[:2] for i in range(len(got))]
    assert any(h != w for h, w in shapes)
    for i in range(len(got)):
        assert got[i]["masks"].shape == want[i]["masks"].shape == (16, 16)
    seen = []
    orig = port_validator.resize_nearest_cv
    monkeypatch.setattr(port_validator, "resize_nearest_cv",
                        lambda m, size: seen.append((m.shape, size)) or orig(m, size))
    m = YOLO("tinyseg.yaml", device="cpu")
    m.val(data=str(root / "data.yaml") if (root / "data.yaml").exists() else
          {"path": str(root), "train": "images/train", "val": "images/val", "names": {0: "a", 1: "b"}},
          imgsz=64, batch=2, rect=True, conf=0.001, project=str(root / "runs"))
    assert any(shape == (16, 16) and size != (16, 16) for shape, size in seen)


def test_masks_stay_in_letterbox_space(seg_pair):
    """Masks come back at the prototypes' resolution of the square letterboxed input (16 x 16
    for a 48 x 80 frame at 64), as JAX's `SegmentPredictor` returns them, not in the frame."""
    _, pyolo = seg_pair
    frames = np.zeros((1, 48, 80, 3), np.uint8)
    _, masks = pyolo.predict_batched(frames, imgsz=64, conf=0.0)
    assert masks.shape == (1, 300, 16, 16)


def test_multi_scale_resizes_masks_as_jax():
    rng = np.random.default_rng(0)
    batch = {"img": rng.integers(0, 256, (2, 64, 64, 3), np.uint8),
             "masks": rng.integers(0, 4, (2, 16, 16)).astype(np.float32)}
    args = dict(seed=3, imgsz=64)
    jself = types.SimpleNamespace(args=types.SimpleNamespace(**args), meta={"strides": [8, 16, 32]})
    pself = types.SimpleNamespace(args=types.SimpleNamespace(**args), meta={"strides": [8, 16, 32]},
                                  _ms_rng=np.random.default_rng(3 + 7))
    for _ in range(4):
        want = jax_trainer_module.BaseTrainer._multi_scale(jself, batch, 0)
        got = SegmentTrainer._multi_scale(pself, batch)
        np.testing.assert_array_equal(got["img"], want["img"])
        np.testing.assert_array_equal(got["masks"], want["masks"])
    assert got["masks"].shape[1] == got["img"].shape[1] // 4


def test_segment_keys_and_host_route(tmp_path):
    for k, v in (("pose", 12.0), ("kobj", 1.0), ("overlap_mask", True), ("mask_ratio", 4),
                 ("retina_masks", False)):
        assert DEFAULT_CFG[k] == v == jax_get_cfg().get(k)
    args = get_cfg({"overlap_mask": False, "mask_ratio": 2, "retina_masks": True})
    assert not args.overlap_mask and args.mask_ratio == 2 and args.retina_masks
    tr = SegmentTrainer(dict(model="tinyseg.yaml", data="synthetic", imgsz=64, copy_paste=0.0,
                             device_augment=True, project=str(tmp_path)), device="cpu")
    assert not tr._device_augment_enabled()


def test_segment_checkpoint_serves_as_segment(seg_dir, tmp_path):
    root, data = seg_dir
    m = YOLO("tinyseg.yaml", device="cpu")
    metrics = m.train(data=data, imgsz=64, batch=4, epochs=1, workers=1, multi_scale=True,
                      overlap_mask=True, project=str(tmp_path))
    assert "metrics/mAP50-95(M)" in metrics and "train/seg" in metrics
    assert not m.trainer.device_augment
    ck = YOLO(m.ckpt_dir, device="cpu")
    assert ck.task == "segment" and ck.meta["nm"] == 16 and ck.meta["nc"] == 2
    frames = np.random.default_rng(1).integers(0, 256, (2, 48, 80, 3), np.uint8)
    for a, b in zip(ck.predict_batched(frames, imgsz=64, conf=0.01),
                    m.predict_batched(frames, imgsz=64, conf=0.01)):
        np.testing.assert_array_equal(a, b)
    assert "metrics/mAP50(M)" in ck.val(data=data, imgsz=64, batch=4, project=str(tmp_path))


def test_protos_pass_half_remat_and_ensemble(tmp_path):
    """Segment's (maps, protos) output through `half_model` (bf16 maps and prototypes),
    `remat` (the same loss and gradient as the plain step) and `Ensemble` (merged rows)."""
    from sar_yolo_tpu_torch.engine.model import Ensemble
    from sar_yolo_tpu_torch.nn.fuse import fuse_model, half_model
    m = YOLO("tinyseg.yaml", device="cpu")
    m._ensure_variables()
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    half = half_model(fuse_model(copy.deepcopy(m.model)).eval())
    with torch.no_grad():
        maps, protos = half(x.to(torch.bfloat16))
    assert protos.dtype == torch.bfloat16 and protos.shape == (1, 16, 16, 16) and len(maps) == 3
    common = dict(model="tinyseg.yaml", data="synthetic", imgsz=64, batch=2, nbs=2, workers=1,
                  max_labels=16, optimizer="SGD", warmup_epochs=0.0, project=str(tmp_path))
    grads = []
    for remat in (False, True):
        tr = SegmentTrainer({**common, "remat": remat}, device="cpu")
        tr.setup()
        b = tr.to_device(next(iter(tr.train_loader)))
        total, items, _ = tr.loss(tr.model(b["img"]), b)
        total.backward()
        grads.append((items, [p.grad.clone() for p in tr.model.parameters()]))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=0, atol=0)
    for g0, g1 in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(g0, g1, rtol=1e-6, atol=1e-9)
    frames = np.random.default_rng(2).integers(0, 256, (2, 48, 80, 3), np.uint8)
    merged = Ensemble([m, YOLO("tinyseg.yaml", device="cpu")]).predict(list(frames), imgsz=64,
                                                                       conf=1e-5)
    assert len(merged) == 2 and all(d.shape[1] == 6 and len(d) for d in merged)
