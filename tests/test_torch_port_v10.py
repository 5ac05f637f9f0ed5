"""YOLOv10's NMS-free path in the PyTorch port against the JAX package.

(a) `test_postprocess_end2end_matches_jax`: the flat (anchor, class) top-k rows of random
decoded predictions, with padding (N * nc < max_det), a conf threshold and equal scores
inside the k (JAX's order: lower flat index first): rows equal, boxes within 1e-6 of 640
px; `test_end2end_serving_makes_no_host_sync`: it runs on `meta` tensors with every host
read of a tensor's value made to fail.
(b) `test_forward_matches_jax`: the eval forward maps of every v10 file (n, s, m, b, l, x
and tinyv10) at 64 px, 1e-4 absolute, unfused, with the strict bridge.
(c) `test_dual_assignment_loss_and_gradient_match_jax`: tinyv10 (nc 3, synthetic, 64 px,
batch 2) from the JAX trainer's weights on its first batch: the loss items (one2many at
TAL top-k 10 plus one2one at top-k 1) within 1e-5 relative or 4x JAX's own spread under
1e-7 weight perturbations, whichever is larger; the float64 gradient of the port within
1e-3 relative L2 of JAX's float32 gradient, as a whole and layer by layer (JAX's own
float32 rounding reaches ~3e-4 of the stem's BN gradient); and, with the one2one branch
fed detached maps (as Ultralytics does), the
backbone's gradient lies over 1e-2 (relative L2) from JAX's: the one2one loss reaches the
backbone in both packages.
(d) `test_three_steps_match_jax`: 3 SGD steps of tinyv10 against JAX's train step, held as
`assert_trajectories_match` holds tinydet.
(e) `test_yolo_val_end2end_matches_jax`: `YOLO.val(data="synthetic")` of tinyv10 (BN
calibrated, class logits of both branches scaled): the same rows per image (classes
equal, boxes within 1e-3 px, scores within 1e-4), the metrics within 1e-6.
(f) `test_fuse_folds_repvggdw`: yolov10n's BN-folded model (RepVGGDW merged into one 7x7),
BN calibrated: its maps no farther (max abs) from the unfused model run in float64 than
twice JAX's `fuse_variables` + `fused=True` maps are (which lie within 1e-5 of the maps'
largest magnitude, ~3e3, from it); the bridged tree has the folded model's keys; and
`YOLO.fuse()` serving the rows of the unfused model (1e-4 on scores, 1e-3 px on boxes)
at a threshold in a gap of the scores.
(g) `test_v10_checkpoint_serves_end2end_as_detect`: `YOLO.train` of tinyv10 (its epoch's
validation on the end2end path), then `YOLO(checkpoint)`: task detect, head v10Detect,
the same rows, and a validation.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.engine import validator as jax_validator
from sar_yolo_tpu.nn.fuse import fuse as jax_fuse
from sar_yolo_tpu.nn.tasks import build_model as jax_build_model
from sar_yolo_tpu.ops.nms import postprocess_end2end as jax_postprocess_end2end
from sar_yolo_tpu.utils.loss import detection_loss
from sar_yolo_tpu_torch import YOLO
from sar_yolo_tpu_torch.engine import validator as port_validator
from sar_yolo_tpu_torch.engine.trainer import DetectionTrainer
from sar_yolo_tpu_torch.nn.fuse import fuse_model
from sar_yolo_tpu_torch.nn.modules import head as PH
from sar_yolo_tpu_torch.nn.modules.block import RepVGGDW
from sar_yolo_tpu_torch.nn.tasks import build_model
from sar_yolo_tpu_torch.ops.decode import decode_detect
from sar_yolo_tpu_torch.ops.nms import postprocess_end2end
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from torch_port_common import (assert_trajectories_match, fill_variables,  # noqa: F401
                               jax_and_port_yolo, jax_jde_trainer, one_torch_thread,
                               port_trainer_like)

ATOL = 1e-4

# ---- (a) postprocess_end2end -----------------------------------------------------------------

E2E_CASES = {  # (B, N, nc, max_det, conf)
    "padded": (2, 50, 3, 300, 0.0),
    "conf": (2, 400, 5, 100, 0.3),
    "nc80": (3, 1000, 80, 300, 0.25),
}


def _preds(B, N, nc, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 640, (B, N, 2))
    wh = rng.uniform(2, 200, (B, N, 2))
    return np.concatenate([xy, wh, rng.uniform(0, 1, (B, N, nc))], -1).astype(np.float32)


@pytest.mark.parametrize("case", list(E2E_CASES))
def test_postprocess_end2end_matches_jax(case):
    B, N, nc, max_det, conf = E2E_CASES[case]
    preds = _preds(B, N, nc)
    want = np.asarray(jax_postprocess_end2end(jnp.asarray(preds), max_det=max_det,
                                              conf_thres=conf, nc=nc))
    got = postprocess_end2end(torch.tensor(preds), max_det=max_det, conf_thres=conf, nc=nc).numpy()
    assert got.shape == want.shape == (B, max_det, 6)
    np.testing.assert_array_equal(got[..., 4:], want[..., 4:])
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=1e-6 * 640)
    kept = (got[..., 4] > 0).sum(1)
    assert (kept > 0).all() and (kept <= min(max_det, N * nc)).all()
    if N * nc < max_det:
        assert (got[:, N * nc:] == 0).all()


def test_postprocess_end2end_orders_equal_scores_as_jax():
    """Equal scores inside the top k come out lower flat index first, as from lax.top_k."""
    preds = _preds(2, 60, 4, seed=3)
    scores = preds[..., 4:]
    scores[0, ::3, 1] = 0.75  # 20 equal scores, all inside the top 100
    scores[1, 5:20, :] = 0.9  # 60 equal scores, also inside it
    want = np.asarray(jax_postprocess_end2end(jnp.asarray(preds), max_det=100, nc=4))
    got = postprocess_end2end(torch.tensor(preds), max_det=100, nc=4).numpy()
    assert (got[0, :, 4] == 0.75).sum() == 20 and (got[1, :, 4] == 0.9).sum() == 60
    np.testing.assert_array_equal(got[..., 4:], want[..., 4:])
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=1e-6 * 640)


def test_end2end_serving_makes_no_host_sync(monkeypatch):
    """`postprocess_end2end` reads no tensor's value on the host: it runs on meta tensors,
    which have no values to read."""
    for name in ("item", "tolist", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, lambda *a, **k: pytest.fail(f"host read: {name}"))
    out = postprocess_end2end(torch.empty(4, 8400, 84, device="meta"), max_det=300,
                              conf_thres=0.25, nc=80)
    assert out.shape == (4, 300, 6) and out.device.type == "meta"


# ---- (b) the v10 graphs ----------------------------------------------------------------------

V10 = ["yolov10n.yaml", "yolov10s.yaml", "yolov10m.yaml", "yolov10b.yaml", "yolov10l.yaml",
       "yolov10x.yaml", "tinyv10.yaml"]


def _jax_variables(jmodel, x, seed: int = 0):
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, train=False))
    return fill_variables(shapes, np.random.default_rng(seed))


def _compare_maps(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)


def _nchw(x):
    return torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("name", V10)
def test_forward_matches_jax(name):
    jmodel, _ = jax_build_model(name)
    x = np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    variables = _jax_variables(jmodel, jnp.asarray(x))
    pmodel, meta = build_model(name)
    assert meta["head"] == "v10Detect" and meta["task"] == "detect"
    assert isinstance(pmodel.blocks[-1], PH.v10Detect) and not pmodel.blocks[-1].legacy
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in pmodel.parameters()) == n_jax
    with torch.no_grad():
        got = pmodel(_nchw(x))
    want = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=False))(variables, jnp.asarray(x))
    _compare_maps(got, want)


# ---- (c), (d) the dual-assignment loss -------------------------------------------------------

def _common(**kw) -> dict:
    return dict(model="tinyv10.yaml", data="synthetic", imgsz=64, batch=2, nbs=2, workers=1,
                max_labels=16, seed=0, optimizer="SGD", warmup_epochs=0.0, **kw)


def _jax_trainer(common, tmp_path, monkeypatch):
    overrides = {**common, "mesh_shape": [1], "plots": False, "val": False, "save": False,
                 "project": str(tmp_path)}
    jtr = jax_jde_trainer(overrides, seed=11, monkeypatch=monkeypatch, task="detect")
    assert jtr.meta["head"] == "v10Detect" and jtr.meta["nc"] == 3
    return jtr


def test_dual_assignment_loss_and_gradient_match_jax(tmp_path, monkeypatch):
    common = _common(lr0=1e-4)
    jtr = _jax_trainer(common, tmp_path, monkeypatch)
    jtr.train_loader.set_epoch(0)
    batch = next(iter(jtr.train_loader))
    meta, batch_stats = jtr.meta, jtr.state.batch_stats
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    kw = dict(nc=meta["nc"], reg_max=meta["reg_max"], strides=tuple(meta["strides"]))

    def loss(params):
        feats, _ = jtr.model.apply({"params": params, "batch_stats": batch_stats},
                                   jb["img"].astype(jnp.float32) / 255.0, train=True,
                                   mutable=["batch_stats"])
        m = detection_loss(feats["one2many"], jb, jtr.args, tal_topk=10, **kw)
        o = detection_loss(feats["one2one"], jb, jtr.args, tal_topk=1, **kw)
        return m.total + o.total, m.items + o.items

    grad = jax.jit(jax.grad(loss, has_aux=True))
    params = jax.device_get(jtr.state.params)
    jgrad, jitems = grad(params)
    want = from_jax_variables({"params": jax.device_get(jgrad)})
    rng = np.random.default_rng(0)
    runs = [grad(jax.tree.map(
        lambda p: (p * (1 + 1e-7 * rng.standard_normal(p.shape))).astype(np.float32), params))
        for _ in range(3)]
    item_spread = np.max([np.abs(np.asarray(i) - np.asarray(jitems)) for _, i in runs], 0)

    ptr = port_trainer_like(jtr, common)
    assert isinstance(ptr, DetectionTrainer) and ptr.loss_names == ("box", "cls", "dfl")
    b = ptr.to_device(batch)
    feats = ptr.model(b["img"])
    assert set(feats) == {"one2many", "one2one"}
    total, items, _ = ptr.loss(feats, b)
    err = np.abs(items.numpy() - np.asarray(jitems))
    assert (err <= np.maximum(1e-5 * np.abs(np.asarray(jitems)), 4 * item_spread)).all(), \
        (items, jitems, item_spread)
    assert (items > 0).all()

    def float64_grad(model):
        ptr.loss(model(b["img"].double()), b)[0].backward()
        return {n: p.grad for n, p in model.named_parameters()}

    got = float64_grad(copy.deepcopy(ptr.model).double())
    assert got.keys() == want.keys()

    def flat(g, names):
        return torch.cat([g[n].double().flatten() for n in names])

    names = list(got)

    def rel_l2(g, subset):
        return ((flat(g, subset) - flat(want, subset)).norm() / flat(want, subset).norm()).item()

    assert rel_l2(got, names) < 1e-3, f"gradient {rel_l2(got, names):.3g} from JAX's"
    layers = sorted({int(n.split(".")[1]) for n in names})
    for i in layers:  # every layer of the graph, the backbone's included
        sub = [n for n in names if int(n.split(".")[1]) == i]
        assert rel_l2(got, sub) < 1e-3, f"layer {i}: gradient {rel_l2(got, sub):.3g} from JAX's"

    # the one2one branch fed detached maps (Ultralytics' v10Detect): the backbone's gradient
    # moves away from JAX's, so the match above includes the one2one loss's share
    detached = copy.deepcopy(ptr.model).double()
    head = detached.blocks[-1]
    live = head._maps
    head._maps = lambda xs, prefix="": live([x.detach() for x in xs] if prefix else xs, prefix)
    got_d = float64_grad(detached)
    backbone = [n for n in names if int(n.split(".")[1]) < meta["head_index"]]
    gap = rel_l2(got_d, backbone)
    assert gap > 1e-2, f"detaching the one2one input moved the backbone gradient by {gap:.3g}"


def test_three_steps_match_jax(tmp_path, monkeypatch):
    common = _common(lr0=1e-3)
    jtr = _jax_trainer(common, tmp_path, monkeypatch)
    ptr = port_trainer_like(jtr, common)
    assert ptr.meta["head"] == "v10Detect"
    assert_trajectories_match(jtr, ptr, steps=3)


# ---- (e) validation on the end2end path ------------------------------------------------------

def _v10_pair(cfg: str, seed: int, cls_gain: float, box_gain: float, calibrate: int):
    """`jax_and_port_yolo` with the class and box logits of both branch copies scaled."""
    jyolo, pyolo = jax_and_port_yolo(cfg, seed, calibrate=calibrate)
    variables = jyolo.variables
    head = variables["params"][f"blocks_{jyolo.meta['head_index']}"]
    for name, sub in head.items():
        if name.endswith("_pred"):
            gain = cls_gain if name.removeprefix("o2o_").startswith("cv3_") else box_gain
            sub["kernel"] = sub["kernel"] * np.float32(gain)
    pyolo.load_jax_variables(variables)
    return jyolo, pyolo


def _record_dets(monkeypatch, module):
    seen = []
    orig = module.BaseValidator.update_metrics

    def update_metrics(self, dets, batch, hw):
        seen.append(np.array(dets))
        return orig(self, dets, batch, hw)
    monkeypatch.setattr(module.BaseValidator, "update_metrics", update_metrics)
    return seen


def _sorted_rows(d):
    d = d[d[:, 4] > 0]
    return d[np.lexsort((d[:, 3], d[:, 2], d[:, 1], d[:, 0], d[:, 5]))]


def _assert_same_rows(got, want):
    assert got.shape == want.shape
    for g, w in zip(got, want):
        gs, ws = _sorted_rows(g), _sorted_rows(w)
        assert len(gs) == len(ws) > 0
        np.testing.assert_array_equal(gs[:, 5], ws[:, 5])
        np.testing.assert_allclose(gs[:, :4], ws[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(gs[:, 4], ws[:, 4], rtol=0, atol=1e-4)


def test_yolo_val_end2end_matches_jax(tmp_path, monkeypatch):
    jyolo, pyolo = _v10_pair("tinyv10.yaml", 4, cls_gain=0.3, box_gain=0.1, calibrate=64)
    kw = dict(data="synthetic", imgsz=64, batch=6, name="val", exist_ok=True)
    jdets = _record_dets(monkeypatch, jax_validator)
    pdets = _record_dets(monkeypatch, port_validator)
    want = jyolo.val(plots=False, project=str(tmp_path / "jax"), **kw)
    got = pyolo.val(project=str(tmp_path / "port"), **kw)
    assert [len(d) for d in pdets] == [len(d) for d in jdets] == [6, 6, 4]
    for g, w in zip(pdets, jdets):
        assert g.shape[1:] == (300, 6)
        assert ((g[..., 4] > 0).sum(1) <= 84 * 3).all()  # 252 (anchor, class) pairs at 64 px
        assert np.abs(g[..., 4][g[..., 4] > 0] - 0.001).min() > 1e-5  # none at the threshold
        _assert_same_rows(g, w)
    keys = set(want) - {"speed/ms_per_image"}
    assert keys <= set(got)
    for k in keys:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


# ---- (f) fuse --------------------------------------------------------------------------------

def test_fuse_folds_repvggdw(monkeypatch):
    jyolo, pyolo = _v10_pair("yolov10n.yaml", 6, cls_gain=0.002, box_gain=0.002, calibrate=64)
    assert any(isinstance(m, RepVGGDW) for m in pyolo.model.modules())
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    fmodel, fvars = jax_fuse(jyolo.model, jyolo.variables)
    fused = fuse_model(copy.deepcopy(pyolo.model).eval())
    merged = [m for m in fused.modules() if isinstance(m, RepVGGDW)]
    assert merged and all(m.conv1 is None and m.conv.kernel_size == (7, 7) for m in merged)
    exact = copy.deepcopy(pyolo.model).double().eval()
    with torch.no_grad():
        maps, ref = fused(_nchw(x)), exact(_nchw(x).double())
    want = jax.jit(lambda v, xx: fmodel.apply(v, xx, train=False))(fvars, jnp.asarray(x))
    for g, w, r in zip(maps, want, ref):  # calibrated maps reach ~3e3: float32 rounding rules
        w = torch.tensor(np.asarray(w).transpose(0, 3, 1, 2)).double()
        err, jax_err = (g.double() - r).abs().max().item(), (w - r).abs().max().item()
        assert err <= 2 * jax_err and jax_err < 1e-5 * r.abs().max().item(), (err, jax_err)
    bridged = from_jax_variables(jax.device_get(fvars))
    assert set(bridged) == set(fused.state_dict())

    # YOLO.fuse() serves the rows of the unfused model, at a threshold in a gap of the scores
    frames = np.random.default_rng(3).integers(0, 256, (2, 48, 64, 3), np.uint8)
    predictor = pyolo._get_predictor({"imgsz": 64})
    xin, _, _ = predictor.preprocess(frames)
    meta = pyolo.meta
    with torch.no_grad():
        scores = decode_detect(pyolo.model.eval()(xin), meta["strides"], 80)[..., 4:]
    s = np.sort(scores.flatten().numpy())[::-1][:600]
    mids = (s[:-1] + s[1:]) / 2
    counts = (scores.flatten(1).numpy()[:, :, None] > mids).sum(1)  # (frames, thresholds)
    fit = (counts.min(0) >= 5) & (counts.max(0) < 300)  # rows in each frame, no top-k cut
    j = int(np.argmax(np.where(fit, s[:-1] - s[1:], -1.0)))
    conf = float(mids[j])
    assert fit[j] and s[j] - s[j + 1] > 1e-4 and s[0] < 1.0
    with torch.no_grad():
        feats = pyolo.model.eval()(xin)
    unfused = postprocess_end2end(decode_detect(feats, meta["strides"], 80), 300, conf, 80)
    unfused = torch.cat([(unfused[..., :4] - torch.tensor([0.0, 8.0, 0.0, 8.0])),
                         unfused[..., 4:]], -1).numpy()  # 48x64 letterboxed at 64: pad 8 rows
    pyolo.fuse()
    assert pyolo.fused and not any(isinstance(m, torch.nn.BatchNorm2d)
                                   for m in pyolo.model.modules())
    got = pyolo.predict_batched(frames, imgsz=64, conf=conf)
    assert got.shape == (2, 300, 6)
    _assert_same_rows(got, unfused)


# ---- (g) checkpoints -------------------------------------------------------------------------

def test_v10_checkpoint_serves_end2end_as_detect(tmp_path):
    m = YOLO("tinyv10.yaml", device="cpu")
    metrics = m.train(data="synthetic", imgsz=64, batch=8, epochs=1, workers=0, max_labels=16,
                      project=str(tmp_path))
    assert {"train/box", "train/cls", "train/dfl", "metrics/mAP50(B)"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    ckpt = YOLO(m.ckpt_dir, device="cpu")
    assert ckpt.task == "detect" and ckpt.meta["head"] == "v10Detect" and ckpt.meta["nc"] == 3
    frames = np.random.default_rng(0).integers(0, 256, (2, 48, 64, 3), np.uint8)
    want = m.predict_batched(frames, imgsz=64, conf=0.001)
    got = ckpt.predict_batched(frames, imgsz=64, conf=0.001)
    assert got.shape == (2, 300, 6) and (got[..., 4] > 0).any()
    np.testing.assert_array_equal(got, want)
    res = ckpt.predict(frames[0], imgsz=64, conf=0.001)[0]
    assert res.embeds is None and len(res) > 0
    assert {"metrics/mAP50(B)", "fitness"} <= set(ckpt.val(data="synthetic", imgsz=64, batch=8,
                                                           project=str(tmp_path)))
