"""The pose task of the PyTorch port against the JAX package (the heads and graphs:
`test_torch_port_pose_seg_graphs.py`).

(a) `test_decode_and_nms_carry_keypoints`: decode of random Pose maps (17 x 3 and 5 x 2
keypoints; xy to input pixels, visibility sigmoided) and NMS carrying them in the rows,
against JAX's: rows within 1e-4 px / 1e-6; `kpts_decode` equal.
(b) `test_pose_loss_matches_jax`: `pose_loss` of random maps and targets (K 17 with
COCO's sigmas, K 5 with 1 / K, K 4 x 2 without visibility): items within 1e-5 relative,
the gradient of the maps within 1e-3 relative L2.
(c) `test_pose_train_step_matches_jax` / `test_three_steps_match_jax`: tinypose (synthetic,
5 keypoints, 64 px) from the JAX trainer's weights: the first step's items within 1e-5
relative and the float64 gradient within 1e-3 relative L2; then 3 SGD steps as
`assert_trajectories_match` holds them.
(d) `test_pose_items_match_jax`: a 17-keypoint dataset of PNG files with COCO's `flip_idx`:
train items (mosaic, copy-paste, affine, HSV, flips with flip_idx, mixup) and val / rect
items bit for bit with JAX's, and the label cache each package reads from the other;
`test_augmentations_carry_keypoints`: mosaic4, copy_paste, mixup, random_perspective (the
visibility of keypoints off the canvas zeroed) and random_flip with `flip_idx` directly.
(e) `test_device_augment_keypoints_match_jax`: `device_train_augment` with JAX's draws on a
batch with keypoints: keypoints within 1e-5, flips permuted by flip_idx.
(f) `test_pose_validator_matches_jax`: both validators' metrics on the same detections
(the ground truth moved a little, keypoints jittered): `(B)` and `(P)` keys within 1e-6;
`test_yolo_val_matches_jax`: `YOLO.val(data="synthetic")` of tinypose, rows and metrics.
(g) `test_predict_batched_matches_jax`: served rows (keypoints un-letterboxed) as JAX's
`PosePredictor` serves them: scores and visibilities within 1e-4, pixel coordinates within
1e-3 px + 1e-5 of their size (float32 rounding of the maps, times a stride of up to 32,
over r); and `YOLO.predict`'s Results (boxes clipped, keypoints not).
(h) The JAX behaviours: `test_synthetic_keypoint_count_jax_fault` (JAX's synthetic set has 5
keypoints whatever the model's, so its 17-keypoint model fails in the loss; the port takes
the dataset's keypoint shape, as Ultralytics does) and
`test_dataset_keypoint_shape_rebuilds_the_head`; `test_pose_checkpoint_serves_as_pose`.
"""

import copy

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.cfg import get_cfg as jax_get_cfg
from sar_yolo_tpu.data import augment as jax_augment
from sar_yolo_tpu.data import dataset as jax_dataset
from sar_yolo_tpu.data import device_augment as jax_da
from sar_yolo_tpu.engine import validator as jax_validator
from sar_yolo_tpu.ops.decode import decode_detect as jax_decode
from sar_yolo_tpu.ops.decode import kpts_decode as jax_kpts_decode
from sar_yolo_tpu.ops.nms import non_max_suppression as jax_nms
from sar_yolo_tpu.utils import loss as jax_loss
from sar_yolo_tpu_torch import YOLO
from sar_yolo_tpu_torch.cfg.default import get_cfg
from sar_yolo_tpu_torch.data import augment
from sar_yolo_tpu_torch.data.dataset import YOLODataset
from sar_yolo_tpu_torch.data.device_augment import device_train_augment
from sar_yolo_tpu_torch.engine import validator as port_validator
from sar_yolo_tpu_torch.engine.predictor import PosePredictor
from sar_yolo_tpu_torch.engine.trainer import PoseTrainer
from sar_yolo_tpu_torch.ops.decode import decode_detect, kpts_decode
from sar_yolo_tpu_torch.ops.nms import non_max_suppression
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from sar_yolo_tpu_torch.utils.loss import pose_loss
from test_torch_port_device_augment import HYP, jax_params
from torch_port_common import (assert_trajectories_match, jax_and_port_yolo,  # noqa: F401
                               jax_jde_trainer, one_torch_thread, port_trainer_like)

COCO_FLIP = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]
STRIDES = (8, 16, 32)


def _maps(nc, nk, seed, imgsz=64, B=2, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, imgsz // s, imgsz // s, 64 + nc + nk)) * scale)
            .astype(np.float32) for s in STRIDES]


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


# ---- (a) decode and NMS ----------------------------------------------------------------------

@pytest.mark.parametrize("kpt_shape", [(17, 3), (5, 2)])
def test_decode_and_nms_carry_keypoints(kpt_shape):
    nc, nk = 2, kpt_shape[0] * kpt_shape[1]
    maps = _maps(nc, nk, 0)
    want = np.asarray(jax_decode([jnp.asarray(m) for m in maps], STRIDES, nc, kpt_shape=kpt_shape))
    got = decode_detect([_nchw(m) for m in maps], STRIDES, nc, kpt_shape=kpt_shape).numpy()
    assert got.shape == want.shape == (2, 84, 4 + nc + nk)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    conf = 0.6
    wd = np.asarray(jax_nms(jnp.asarray(want), conf_thres=conf, iou_thres=0.7, max_det=50, nc=nc))
    gd = non_max_suppression(torch.tensor(want), conf_thres=conf, iou_thres=0.7, max_det=50,
                             nc=nc).numpy()
    assert gd.shape == wd.shape == (2, 50, 6 + nk) and (gd[..., 4] > 0).sum() > 4
    np.testing.assert_array_equal(gd, wd)
    pk = np.random.default_rng(3).standard_normal((2, 84, *kpt_shape)).astype(np.float32)
    anchors = np.random.default_rng(4).uniform(0, 8, (84, 2)).astype(np.float32)
    np.testing.assert_allclose(kpts_decode(torch.tensor(anchors), torch.tensor(pk)).numpy(),
                               np.asarray(jax_kpts_decode(jnp.asarray(anchors), jnp.asarray(pk))),
                               rtol=0, atol=1e-6)


# ---- (b) the loss ----------------------------------------------------------------------------

def _targets(kpt_shape, seed, B=2, M=6):
    rng = np.random.default_rng(seed)
    wh = rng.uniform(0.1, 0.5, (B, M, 2))
    cxy = rng.uniform(wh / 2, 1 - wh / 2)
    mask = (np.arange(M)[None] < np.array([[4], [6]])).astype(np.float32)
    K, D = kpt_shape
    kxy = cxy[:, :, None] + rng.uniform(-0.5, 0.5, (B, M, K, 2)) * wh[:, :, None]
    parts = [kxy] + ([rng.integers(0, 3, (B, M, K, 1)).astype(float)] if D == 3 else [])
    return {"cls": (rng.integers(0, 2, (B, M)) * mask).astype(np.float32),
            "bboxes": (np.concatenate([cxy, wh], -1) * mask[..., None]).astype(np.float32),
            "mask": mask, "keypoints": (np.concatenate(parts, -1) *
                                        mask[..., None, None]).astype(np.float32)}


@pytest.mark.parametrize("kpt_shape", [(17, 3), (5, 3), (4, 2)])
def test_pose_loss_matches_jax(kpt_shape):
    nc, nk = 2, kpt_shape[0] * kpt_shape[1]
    maps, batch = _maps(nc, nk, 1, scale=0.5), _targets(kpt_shape, 2)
    hyp = jax_get_cfg()
    kw = dict(nc=nc, reg_max=16, strides=STRIDES, kpt_shape=kpt_shape)

    def jloss(ms):
        out = jax_loss.pose_loss(ms, {k: jnp.asarray(v) for k, v in batch.items()}, hyp, **kw)
        return out.total, out.items
    (jtotal, jitems), jgrad = jax.value_and_grad(jloss, has_aux=True)([jnp.asarray(m) for m in maps])
    feats = [_nchw(m).requires_grad_() for m in maps]
    out = pose_loss(feats, {k: torch.tensor(v) for k, v in batch.items()}, get_cfg(), **kw)
    out.total.backward()
    np.testing.assert_allclose(out.items.numpy(), np.asarray(jitems), rtol=1e-5, atol=1e-7)
    assert (out.items[:2] > 0).all() and (out.items[2] > 0) == (kpt_shape[1] == 3)
    g = torch.cat([f.grad.flatten() for f in feats])
    w = torch.cat([_nchw(x).flatten() for x in jgrad])
    assert ((g - w).norm() / w.norm()).item() < 1e-3


# ---- (c) the train step ----------------------------------------------------------------------

def _common(**kw) -> dict:
    return dict(model="tinypose.yaml", data="synthetic", imgsz=64, batch=2, nbs=2, workers=1,
                max_labels=16, seed=0, optimizer="SGD", warmup_epochs=0.0, **kw)


def _jax_trainer(common, tmp_path, monkeypatch, task="pose"):
    overrides = {**common, "mesh_shape": [1], "plots": False, "val": False, "save": False,
                 "project": str(tmp_path)}
    return jax_jde_trainer(overrides, seed=11, monkeypatch=monkeypatch, task=task)


def _first_step_check(jtr, ptr, loss_fn, kw):
    """The first batch: the port's items within 1e-5 relative of JAX's, its float64 gradient
    within 1e-3 relative L2 of JAX's float32 gradient."""
    jtr.train_loader.set_epoch(0)
    batch = next(iter(jtr.train_loader))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    bs = jtr.state.batch_stats

    def loss(params):
        feats, _ = jtr.model.apply({"params": params, "batch_stats": bs},
                                   jb["img"].astype(jnp.float32) / 255.0, train=True,
                                   mutable=["batch_stats"])
        out = loss_fn(feats, jb, jtr.args, **kw)
        return out.total, out.items
    jgrad, jitems = jax.jit(jax.grad(loss, has_aux=True))(jax.device_get(jtr.state.params))
    want = from_jax_variables({"params": jax.device_get(jgrad)})
    b = ptr.to_device(batch)
    _, items, _ = ptr.loss(ptr.model(b["img"]), b)
    np.testing.assert_allclose(items.numpy(), np.asarray(jitems), rtol=1e-5, atol=1e-8)
    assert (items > 0).all(), items
    model = copy.deepcopy(ptr.model).double()
    ptr.loss(model(b["img"].double()), b)[0].backward()
    got = torch.cat([p.grad.flatten() for _, p in model.named_parameters()])
    ref = torch.cat([want[n].double().flatten() for n, _ in model.named_parameters()])
    assert ((got - ref).norm() / ref.norm()).item() < 1e-3


def test_pose_train_step_matches_jax(tmp_path, monkeypatch):
    common = _common(lr0=1e-4)
    jtr = _jax_trainer(common, tmp_path, monkeypatch)
    ptr = port_trainer_like(jtr, common)
    assert isinstance(ptr, PoseTrainer) and ptr.loss_names == ("box", "pose", "kobj", "cls", "dfl")
    assert ptr.meta["kpt_shape"] == jtr.meta["kpt_shape"] == (5, 3)
    meta = jtr.meta
    _first_step_check(jtr, ptr, jax_loss.pose_loss,
                      dict(nc=meta["nc"], reg_max=meta["reg_max"], strides=tuple(meta["strides"]),
                           kpt_shape=(5, 3)))


def test_three_steps_match_jax(tmp_path, monkeypatch):
    common = _common(lr0=1e-3)
    jtr = _jax_trainer(common, tmp_path, monkeypatch)
    assert_trajectories_match(jtr, port_trainer_like(jtr, common), steps=3)


# ---- (d) host data ---------------------------------------------------------------------------

SHAPES = [(90, 160), (160, 90), (100, 100), (72, 128)]


def _smooth(rng, h, w):
    small = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3), dtype=np.uint8)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)


def _pose_rows(rng, n, K=17):
    rows = []
    for _ in range(n):
        w, h = rng.uniform(0.1, 0.4, 2)
        cx, cy = rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2)
        k = np.concatenate([np.stack([cx + rng.uniform(-.6, .6, K) * w,
                                      cy + rng.uniform(-.6, .6, K) * h], 1),
                            rng.integers(0, 3, (K, 1))], 1)
        rows.append(f"0 {cx:.6f} {cy:.6f} {w:.6f} {h:.6f} " +
                    " ".join(f"{v:.6f}" for v in k.ravel()))
    return rows


def write_pose_dataset(root, n_train, n_val, seed=0):
    """A 17-keypoint pose dataset of PNG frames with COCO's flip_idx; its dataset dict."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            cv2.imwrite(str(root / "images" / split / f"{i:03d}.png"),
                        _smooth(rng, *SHAPES[i % len(SHAPES)]))
            (root / "labels" / split / f"{i:03d}.txt").write_text(
                "\n".join(_pose_rows(rng, int(rng.integers(1, 6)))) + "\n")
    return {"path": str(root), "train": "images/train", "val": "images/val",
            "names": {0: "person"}, "kpt_shape": [17, 3], "flip_idx": COCO_FLIP}


@pytest.fixture(scope="module")
def pose_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("pose_data")
    data = write_pose_dataset(root, 12, 6)
    (root / "data.yaml").write_text(
        "path: .\ntrain: images/train\nval: images/val\nkpt_shape: [17, 3]\n"
        f"flip_idx: {COCO_FLIP}\nnames:\n  0: person\n")
    return root, data


def _pair(root, split, augment, **hyp):
    kw = dict(imgsz=64, max_labels=16, task="pose", kpt_shape=(17, 3), flip_idx=COCO_FLIP)
    path = str(root / "images" / split)
    return (YOLODataset(path, augment=augment, hyp=get_cfg(hyp), **kw),
            jax_dataset.YOLODataset(path, augment=augment, hyp=jax_get_cfg(overrides=hyp), **kw))


def _same_items(got, want):
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g.keys() == w.keys() and "keypoints" in g
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"item {i} {k}")


@pytest.mark.parametrize("hyp", [{"seed": 0}, {"seed": 3, "mixup": 0.7, "flipud": 0.5,
                                               "copy_paste": 0.9, "degrees": 20.0}],
                         ids=["defaults", "mixup-flipud-copy_paste-rotate"])
def test_pose_items_match_jax(pose_dir, hyp):
    root, data = pose_dir
    got, want = _pair(root, "train", True, **hyp)
    _same_items(got, want)
    got.mosaic_enabled = want.mosaic_enabled = False  # close_mosaic: letterbox + affine
    _same_items(got, want)
    got, want = _pair(root, "val", False)
    _same_items(got, want)
    got.init_rect(4)
    want.init_rect(4)
    _same_items(got, want)


def test_pose_label_cache_is_shared(pose_dir, monkeypatch):
    from sar_yolo_tpu_torch.data import dataset as port_dataset
    root, _ = pose_dir
    kw = dict(imgsz=64, task="pose", kpt_shape=(17, 3))
    path = str(root / "images" / "val")
    cache = root / "labels" / "val.cache.npz"
    cache.unlink(missing_ok=True)
    want = jax_dataset.YOLODataset(path, **kw)
    monkeypatch.setattr(port_dataset, "image_shape", None)  # reading the cache must not verify
    got = YOLODataset(path, **kw)
    for g, w in zip(got.labels, want.labels):
        assert g.keys() == w.keys() == {"cls", "bboxes", "tags", "keypoints"}
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    monkeypatch.undo()
    cache.unlink()
    YOLODataset(path, **kw)  # the port writes it
    monkeypatch.setattr(jax_dataset, "_image_shape", None)
    again = jax_dataset.YOLODataset(path, **kw)
    np.testing.assert_array_equal(again.labels[0]["keypoints"], want.labels[0]["keypoints"])


def _kpt_item(rng, h, w, n=5, K=17):
    x1, y1 = rng.uniform(0, w * 0.7, n), rng.uniform(0, h * 0.7, n)
    bw, bh = rng.uniform(4, w * 0.3, n), rng.uniform(4, h * 0.3, n)
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)
    kxy = np.stack([rng.uniform(x1[:, None] - 5, x1[:, None] + bw[:, None] + 5, (n, K)),
                    rng.uniform(y1[:, None] - 5, y1[:, None] + bh[:, None] + 5, (n, K))], -1)
    kpts = np.concatenate([kxy, rng.integers(0, 3, (n, K, 1))], -1).astype(np.float32)
    return {"img": _smooth(rng, h, w), "cls": rng.integers(0, 3, n).astype(np.float32),
            "bboxes": boxes, "keypoints": kpts}


def test_augmentations_carry_keypoints():
    rng = np.random.default_rng(5)
    items = [_kpt_item(rng, int(rng.integers(40, 64)), 64, n=int(rng.integers(1, 5)))
             for _ in range(4)]
    out = {}
    for name, mod in (("port", augment), ("jax", jax_augment)):
        r = np.random.default_rng(11)
        it = mod.mosaic4([{k: v.copy() for k, v in x.items()} for x in items], 64, rng=r)
        border = it.pop("mosaic_border")
        it = mod.copy_paste(it, p=0.9, rng=r)
        it = mod.random_perspective(it, degrees=30.0, translate=0.3, scale=0.5, border=border,
                                    rng=r)
        it = mod.mixup(it, {k: v.copy() for k, v in items[0].items() if k != "img"} |
                       {"img": np.full_like(it["img"], 7)}, rng=r)
        it = mod.random_flip(it, fliplr=0.5, flipud=0.5, rng=r, flip_idx=COCO_FLIP)
        it = mod.random_flip(it, fliplr=1.0, rng=r, flip_idx=COCO_FLIP)
        out[name] = it
    g, w = out["port"], out["jax"]
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    vis = g["keypoints"][..., 2]
    assert len(g["keypoints"]) > 4 and (vis == 0).any() and (vis > 0).any()


# ---- (e) device augmentation -----------------------------------------------------------------

@pytest.mark.parametrize("mosaic", [True, False])
def test_device_augment_keypoints_match_jax(mosaic):
    B, S, M, K = 4, 64, 8, 17
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)
    wh = rng.uniform(0.05, 0.4, (B, M, 2))
    cxy = rng.uniform(wh / 2, 1 - wh / 2)
    mask = (np.arange(M)[None] < rng.integers(2, M + 1, (B, 1))).astype(np.float32)
    kpts = np.concatenate([rng.uniform(-0.1, 1.1, (B, M, K, 2)), rng.integers(0, 3, (B, M, K, 1))],
                          -1) * mask[..., None, None]
    batch = {"img": img, "cls": (rng.integers(0, 3, (B, M)) * mask).astype(np.float32),
             "bboxes": (np.concatenate([cxy, wh], -1) * mask[..., None]).astype(np.float32),
             "mask": mask, "keypoints": kpts.astype(np.float32)}
    hyp = {**HYP, "fliplr": 0.5, "flipud": 0.5, "mixup": 0.5, "flip_idx": tuple(COCO_FLIP)}
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda b, k: jax_da.device_train_augment(b, k, hyp, mosaic=mosaic))(
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    got = device_train_augment({k: torch.from_numpy(v) for k, v in batch.items()},
                               jax_params(key, {k: v for k, v in hyp.items() if k != "flip_idx"},
                                          mosaic), hyp, mosaic=mosaic)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["keypoints"].numpy(), np.asarray(want["keypoints"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["bboxes"].numpy(), np.asarray(want["bboxes"]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    v = got["keypoints"][..., 2][got["mask"] > 0]
    assert (v == 0).any() and (v > 0).any()


# ---- (f) validation --------------------------------------------------------------------------

def _validator_dets(seed, K=17, B=3, M=5, S=64):
    """A batch of ground truth and detections made from it (boxes and keypoints moved a
    little, scores spread, a false positive an image)."""
    rng = np.random.default_rng(seed)
    wh = rng.uniform(0.15, 0.4, (B, M, 2))
    cxy = rng.uniform(wh / 2, 1 - wh / 2)
    mask = (np.arange(M)[None] < np.array([[3], [5], [4]])).astype(np.float32)
    kxy = cxy[:, :, None] + rng.uniform(-0.4, 0.4, (B, M, K, 2)) * wh[:, :, None]
    kpts = np.concatenate([kxy, rng.integers(0, 3, (B, M, K, 1))], -1) * mask[..., None, None]
    batch = {"img": np.zeros((B, S, S, 3), np.uint8), "cls": np.zeros((B, M), np.float32),
             "bboxes": (np.concatenate([cxy, wh], -1) * mask[..., None]).astype(np.float32),
             "mask": mask, "keypoints": kpts.astype(np.float32)}
    dets = np.zeros((B, 20, 6 + K * 3), np.float32)
    for b in range(B):
        n = int(mask[b].sum())
        xy = cxy[b, :n] * S + rng.normal(0, 1.5, (n, 2))
        half = wh[b, :n] * S / 2 * rng.uniform(0.85, 1.15, (n, 2))
        k = kpts[b, :n].copy()
        k[..., :2] = k[..., :2] * S + rng.normal(0, 1.0, (n, K, 2))
        k[..., 2] = rng.uniform(0, 1, (n, K))
        rows = np.concatenate([xy - half, xy + half, rng.uniform(0.3, 0.95, (n, 1)),
                               np.zeros((n, 1)), k.reshape(n, -1)], 1)
        fp = np.concatenate([[5, 5, 20, 20, 0.5, 0], rng.uniform(0, S, K * 3)])
        dets[b, :n + 1] = np.concatenate([rows, fp[None]])
    return dets, batch


def test_pose_validator_matches_jax():
    meta = {"nc": 1, "kpt_shape": (17, 3)}
    out = []
    for mod in (port_validator, jax_validator):
        v = mod.PoseValidator()
        v.meta, v.data = meta, {"names": {0: "person"}}
        v.args = get_cfg() if mod is port_validator else jax_get_cfg()
        v.init_metrics()
        for seed in (0, 1):
            dets, batch = _validator_dets(seed)
            v.update_metrics(dets, batch, (64, 64))
        out.append(v.finalize_metrics())
    got, want = out
    assert got.keys() == want.keys() and "metrics/mAP50-95(P)" in got
    assert 0 < got["metrics/mAP50-95(P)"] < 1 and got["metrics/mAP50(B)"] > 0
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


def _record_dets(monkeypatch, module):
    seen = []
    orig = module.BaseValidator.update_metrics

    def update_metrics(self, dets, batch, hw):
        seen.append(np.array(dets))
        return orig(self, dets, batch, hw)
    monkeypatch.setattr(module.BaseValidator, "update_metrics", update_metrics)
    return seen


@pytest.fixture(scope="module")
def pose_pair():
    return jax_and_port_yolo("tinypose.yaml", 4, cls_gain=0.3, box_gain=0.1, calibrate=64)


def _sorted_rows(d):
    d = d[d[:, 4] > 0]
    return d[np.lexsort((d[:, 3], d[:, 2], d[:, 1], d[:, 0], d[:, 5]))]


def _same_rows(got, want, K=5):
    """The same kept rows: classes equal, pixel coordinates (boxes and keypoint xy, up to
    keypoints far off the frame reach ~300 px) within 1e-3 px + 1e-5 of their size, scores
    and keypoint visibilities within 1e-4."""
    assert got.shape == want.shape
    xy = np.r_[0:4, [6 + 3 * k + j for k in range(K) for j in (0, 1)]]
    prob = np.r_[4, [8 + 3 * k for k in range(K)]]
    for g, w in zip(got, want):
        gs, ws = _sorted_rows(g), _sorted_rows(w)
        assert len(gs) == len(ws) > 0
        np.testing.assert_array_equal(gs[:, 5], ws[:, 5])
        np.testing.assert_allclose(gs[:, xy], ws[:, xy], rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(gs[:, prob], ws[:, prob], rtol=0, atol=1e-4)


def test_yolo_val_matches_jax(pose_pair, tmp_path, monkeypatch):
    jyolo, pyolo = pose_pair
    kw = dict(data="synthetic", imgsz=64, batch=6, conf=0.2, name="val", exist_ok=True)
    jdets = _record_dets(monkeypatch, jax_validator)
    pdets = _record_dets(monkeypatch, port_validator)
    want = jyolo.val(plots=False, project=str(tmp_path / "jax"), **kw)
    got = pyolo.val(project=str(tmp_path / "port"), **kw)
    assert [len(d) for d in pdets] == [len(d) for d in jdets] == [6, 6, 4]
    for g, w in zip(pdets, jdets):
        assert g.shape[1:] == (300, 6 + 15)
        _same_rows(g, w)
    assert got.keys() >= set(want) - {"speed/ms_per_image"} and "metrics/mAP50(P)" in got
    for k in set(want) - {"speed/ms_per_image"}:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


# ---- (g) serving -----------------------------------------------------------------------------

def test_predict_batched_matches_jax(pose_pair):
    jyolo, pyolo = pose_pair
    rng = np.random.default_rng(0)
    frames = np.stack([_smooth(rng, 48, 80) for _ in range(2)])
    kw = dict(imgsz=64, conf=0.2)
    predictor = pyolo._get_predictor(kw)
    assert type(predictor) is PosePredictor
    want = np.asarray(jyolo.predict_batched(frames, **kw))
    got = pyolo.predict_batched(frames, **kw)
    assert got.shape == (2, 300, 6 + 15)
    _same_rows(got, want)
    res = pyolo.predict(list(frames), **kw)
    jres = jyolo.predict(list(frames), **kw)
    for r, j in zip(res, jres):
        assert r.keypoints is not None and r.keypoints.data.shape[1:] == (5, 3)
        assert len(r) == len(j) > 0
        order = np.lexsort(r.boxes.data[:, :4].T[::-1])
        jorder = np.lexsort(j.boxes.data[:, :4].T[::-1])
        np.testing.assert_allclose(r.boxes.data[order], j.boxes.data[jorder], rtol=0, atol=1e-3)
        np.testing.assert_allclose(r.keypoints.data[order], np.asarray(j.keypoints.data)[jorder],
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(r.keypoints.xyn, r.keypoints.data[..., :2] / [80, 48])
    kx = np.concatenate([r.keypoints.data[..., 0].ravel() for r in res])
    assert (kx < 0).any() or (kx > 80).any()  # keypoints are not clipped to the frame


# ---- (h) the JAX behaviours ------------------------------------------------------------------

def _tinypose17():
    from sar_yolo_tpu_torch.cfg.models import model_config
    return {**model_config("tinypose.yaml"), "kpt_shape": [17, 3]}


def test_synthetic_keypoint_count_jax_fault(tmp_path, monkeypatch):
    """JAX's trainer gives the synthetic set 5 keypoints (`trainer.py:198`) and keeps the
    model's 17, so its first step fails in `pose_loss`; the port builds the head for the
    dataset's 5 keypoints and trains."""
    common = dict(model=_tinypose17(), data="synthetic", imgsz=64, batch=2, nbs=2, workers=1,
                  max_labels=16, epochs=1, optimizer="SGD", val=False, save=False)
    jtr = _jax_trainer({k: v for k, v in common.items() if k != "epochs"}, tmp_path, monkeypatch)
    assert jtr.meta["kpt_shape"] == (17, 3) and jtr.train_set.kpt_shape == (5, 3)
    batch = next(iter(jtr.train_loader))
    with pytest.raises(Exception):
        jtr._train_step(jtr.state, {k: jnp.asarray(v) for k, v in batch.items()}, False)
    ptr = PoseTrainer({**common, "project": str(tmp_path)}, device="cpu")
    ptr.train()
    assert ptr.meta["kpt_shape"] == (5, 3) and ptr.model.blocks[-1].kpt_shape == (5, 3)
    assert ptr.meta["cfg"]["kpt_shape"] == [5, 3]


def test_dataset_keypoint_shape_rebuilds_the_head(pose_dir, tmp_path):
    """tinypose (5 x 3) on the 17-keypoint folder: the head is built for 17 keypoints."""
    root, _ = pose_dir
    tr = PoseTrainer(dict(model="tinypose.yaml", data=str(root / "data.yaml"), imgsz=64, batch=4,
                          workers=1, project=str(tmp_path)), device="cpu")
    tr.setup()
    assert tr.meta["kpt_shape"] == (17, 3) and tr.train_set.flip_idx == COCO_FLIP
    assert not tr.device_augment  # the host route: copy_paste 0.1
    batch = next(iter(tr.train_loader))
    assert batch["keypoints"].shape == (4, 128, 17, 3)
    total, items = tr.train_step(batch)
    assert torch.isfinite(items).all()


def test_pose_checkpoint_serves_as_pose(pose_dir, tmp_path):
    root, data = pose_dir
    m = YOLO("tinypose.yaml", device="cpu")
    metrics = m.train(data=data, imgsz=64, batch=4, epochs=1, workers=1, copy_paste=0.0,
                      project=str(tmp_path))
    assert "metrics/mAP50-95(P)" in metrics and "train/kobj" in metrics
    assert m.trainer.device_augment and m.trainer.aug_hyp["flip_idx"] == tuple(COCO_FLIP)
    ck = YOLO(m.ckpt_dir, device="cpu")
    assert ck.task == "pose" and ck.meta["kpt_shape"] == (17, 3)
    frames = np.random.default_rng(1).integers(0, 256, (2, 48, 80, 3), np.uint8)
    np.testing.assert_array_equal(ck.predict_batched(frames, imgsz=64, conf=0.01),
                                  m.predict_batched(frames, imgsz=64, conf=0.01))
    val = ck.val(data=data, imgsz=64, batch=4, project=str(tmp_path))
    assert "metrics/mAP50(P)" in val
