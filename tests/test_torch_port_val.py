"""The validation path of the PyTorch port against the JAX package.

(a) the host metrics (`box_iou_np`, `match_predictions`, `compute_ap`,
`ap_per_class`, `DetMetrics`) on seeded inputs with tied IoUs and tied
confidences: within 1e-12 (the same numpy code on the same inputs);
(b) multi-label NMS with an embedding bank: the same kept rows in the same
order, within 1e-6;
(c) the eval loader: the same batches and `_pad`;
(d) `JDEValidator.update_metrics` + `finalize_metrics` of both packages fed the
same detections, made from synthetic ground truth with seeded jitter, clustered
embeddings and state logits: every key within 1e-9 (in float64; in float32 the
silhouette and Davies-Bouldin within 1e-6, relative above 1, since the port
computes them in float64 and scikit-learn in float32), the per-state table, the printed tables,
the CSV rows and the xlsx read back by the JAX reader;
(e) `YOLO.val` end to end on the same weights, tinyjde and yolov13n-JDE at 64 px:
per-batch detections within 1e-4, metrics within 1e-6 (relative where a value exceeds
1, as the Davies-Bouldin index may), the save_txt and save_json files (the same
rows, numbers within that plus one unit of their last printed digit); the same at
256 px with rect batches (192x288 and 288x192) on a dataset folder; then, on
tinyjde, both validators on ground truth planted near the model's own
detections, which is what reaches the match-conditional metrics end to end;
(f) `YOLO.train`'s per-epoch validation (tinyjde, 2 epochs, nc 3, so
multi-label NMS) beside the JAX trainer's: per-epoch metrics and fitness within
1e-6, and the same run without validation trains to the same weights bit for
bit. `speed/ms_per_image` is never compared.
"""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.cfg import get_cfg as jax_get_cfg
from sar_yolo_tpu.data.build import build_dataloader
from sar_yolo_tpu.data.dataset import SyntheticDataset as JaxSyntheticDataset
from sar_yolo_tpu.engine import validator as jax_validator
from sar_yolo_tpu.engine.model import YOLO as JaxYOLO
from sar_yolo_tpu.nn.tasks import infer_strides
from sar_yolo_tpu.ops.nms import non_max_suppression as jax_nms
from sar_yolo_tpu.utils import IterableSimpleNamespace
from sar_yolo_tpu.utils import metrics as jax_metrics
from sar_yolo_tpu.utils.xlsx import read_xlsx as jax_read_xlsx
from sar_yolo_tpu_torch.cfg.default import get_cfg
from sar_yolo_tpu_torch.data.build import DataLoader
from sar_yolo_tpu_torch.data.dataset import SyntheticDataset
from sar_yolo_tpu_torch.engine import validator as port_validator
from sar_yolo_tpu_torch.engine.model import YOLO
from sar_yolo_tpu_torch.ops.nms import non_max_suppression
from sar_yolo_tpu_torch.utils import metrics as port_metrics
from torch_port_common import (fill_variables, jax_jde_trainer, one_torch_thread,  # noqa: F401
                               port_trainer_like)

MATCH_KEYS = ["metrics/state_acc", "metrics/state_macro_precision", "metrics/state_macro_recall",
              "metrics/state_macro_f1", "metrics/mAP50(S)", "metrics/mAP50-95(S)",
              "metrics/reid_pos_cos", "metrics/reid_neg_cos", "metrics/reid_separation",
              "metrics/reid_pos_euc", "metrics/reid_neg_euc", "metrics/reid_silhouette",
              "metrics/reid_davies_bouldin"]


def _assert_metrics_equal(got: dict, want: dict, tol: float, loose: dict | None = None):
    """The same keys, each value within tol (per key in `loose`), relative above 1."""
    got = {k: v for k, v in got.items() if k != "speed/ms_per_image"}
    want = {k: v for k, v in want.items() if k != "speed/ms_per_image"}
    assert got.keys() == want.keys()
    for k, w in want.items():
        atol = (loose or {}).get(k, tol) * max(1.0, abs(w))
        np.testing.assert_allclose(got[k], w, rtol=0, atol=atol, err_msg=k)


# ---- (a) the host metrics ---------------------------------------------------------------

def _tied_image(rng, n_gt=6, n_pred=14):
    """Boxes on an 8 px grid (exact IoU ties), duplicated predictions, confidences in
    fifths (ties), 3 classes."""
    def boxes(n):
        xy = rng.integers(0, 8, (n, 2)) * 8.0
        wh = rng.integers(2, 5, (n, 2)) * 8.0
        return np.concatenate([xy, xy + wh], 1).astype(np.float32)
    gt, gt_cls = boxes(n_gt), rng.integers(0, 3, n_gt).astype(np.float32)
    pred = np.concatenate([gt[rng.integers(0, n_gt, n_pred // 2)], boxes(n_pred - n_pred // 2)])
    pred[::3] = pred[0]
    pred_cls = np.where(rng.uniform(size=n_pred) < 0.7, gt_cls[rng.integers(0, n_gt, n_pred)],
                        rng.integers(0, 3, n_pred)).astype(np.float32)
    conf = (rng.integers(1, 6, n_pred) / 5).astype(np.float32)
    return gt, gt_cls, pred, pred_cls, conf


def test_host_metrics_match_jax_with_ties():
    rng = np.random.default_rng(0)
    jm, pm = jax_metrics, port_metrics
    jdm, pdm = jm.DetMetrics({0: "a", 1: "b", 2: "c"}), pm.DetMetrics({0: "a", 1: "b", 2: "c"})
    n_tp = 0
    for _ in range(8):
        gt, gt_cls, pred, pred_cls, conf = _tied_image(rng)
        np.testing.assert_array_equal(pm.box_iou_np(gt, pred), jm.box_iou_np(gt, pred))
        tp = pm.match_predictions(pred, pred_cls, gt, gt_cls)
        np.testing.assert_array_equal(tp, jm.match_predictions(pred, pred_cls, gt, gt_cls))
        n_tp += tp[:, 0].sum()
        jdm.update(tp, conf, pred_cls, gt_cls)
        pdm.update(tp, conf, pred_cls, gt_cls)
    assert n_tp > 10
    recall = np.sort(rng.uniform(size=20))
    precision = rng.integers(0, 4, 20) / 3
    assert pm.compute_ap(recall, precision) == jm.compute_ap(recall, precision)
    tp = np.concatenate(pdm.stats["tp"])
    args = (tp, np.concatenate(pdm.stats["conf"]), np.concatenate(pdm.stats["pred_cls"]),
            np.concatenate(pdm.stats["target_cls"]))
    got, want = pm.ap_per_class(*args), jm.ap_per_class(*args)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12, err_msg=k)
    res = pdm.process()
    _assert_metrics_equal(res, jdm.process(), 1e-12)
    assert 0 < res["metrics/mAP50-95(B)"] < res["metrics/mAP50(B)"] < 1


# ---- (b) multi-label NMS -----------------------------------------------------------------

@pytest.mark.parametrize("n_anchors", [120, 700], ids=["under_pre_topk", "over_pre_topk"])
def test_multi_label_nms_matches_jax(n_anchors):
    """nc 3, conf 0.001: scores in tenths (ties, zeros under conf), every fifth anchor a copy
    of the one before it; 700 anchors give 2100 pairs for the top 1024."""
    rng = np.random.default_rng(3)
    B, nc, n_states, n_emb = 2, 3, 2, 4
    xy = rng.uniform(0, 64, (B, n_anchors, 2))
    wh = rng.uniform(4, 24, (B, n_anchors, 2))
    scores = rng.integers(0, 11, (B, n_anchors, nc)) / 10
    states = rng.uniform(size=(B, n_anchors, n_states))
    preds = np.concatenate([xy, wh, scores, states], -1).astype(np.float32)
    preds[:, 1::5] = preds[:, 0::5][:, :preds[:, 1::5].shape[1]]
    bank = rng.normal(size=(B, n_anchors, n_emb)).astype(np.float32)
    kw = dict(conf_thres=0.001, iou_thres=0.7, max_det=300, nc=nc, multi_label=True)
    want = np.asarray(jax_nms(jnp.asarray(preds), extras_bank=jnp.asarray(bank), **kw))
    got = non_max_suppression(torch.tensor(preds), extras_bank=torch.tensor(bank), **kw).numpy()
    assert got.shape == want.shape == (B, 300, 6 + n_emb + n_states)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for b in range(B):
        kept = got[b][got[b, :, 4] > 0]
        assert len(kept) > 20
        # one anchor, several classes: the same box kept under two classes
        uniq = np.unique(kept[:, :4], axis=0)
        assert len(uniq) < len(kept)


# ---- (c) the eval loader -----------------------------------------------------------------

def test_eval_loader_matches_jax():
    jax_set = JaxSyntheticDataset(n=16, imgsz=32, nc=3, max_labels=8, task="jde")
    want = list(build_dataloader(jax_set, batch_size=6, shuffle=False, workers=2, drop_last=False,
                                 pad_last=True))
    loader = DataLoader(SyntheticDataset(n=16, imgsz=32, nc=3, max_labels=8, task="jde"), 6,
                        workers=2, shuffle=False, drop_last=False, pad_last=True)
    got = list(loader)
    assert len(loader) == len(got) == len(want) == 3
    assert [b["_pad"] for b in got] == [w["_pad"] for w in want] == [0, 0, 2]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---- (d) the JDE metrics from the same detections ------------------------------------------

E_TEST, S_TEST = 8, 3


def _detections_from_gt(dtype, n_img=12, per_batch=4, imgsz=64):
    """Batches of synthetic JDE ground truth, and (B, 40, 6 + 8 + 3) detections made from it:
    1-2 jittered copies of each GT box (some under IoU 0.5), 15% with the wrong class,
    confidences in eighths (ties), embeddings around one center per tag, state logits
    peaked at clamp(tag) (tag 3 clamps to state 2) with noise, and 2 false positives."""
    ds = JaxSyntheticDataset(n=n_img, imgsz=imgsz, nc=3, max_labels=8, task="jde")
    rng = np.random.default_rng(21)
    centers = rng.normal(size=(4, E_TEST)) * 2
    out = []
    for start in range(0, n_img, per_batch):
        items = [ds[i] for i in range(start, start + per_batch)]
        batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
        dets = np.zeros((per_batch, 40, 6 + E_TEST + S_TEST), dtype)
        for b in range(per_batch):
            rows = []
            m = batch["mask"][b] > 0
            for (cx, cy, w, h), c, tag in zip(batch["bboxes"][b][m] * imgsz, batch["cls"][b][m],
                                              batch["tags"][b][m]):
                for _ in range(rng.integers(1, 3)):
                    box = np.array([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
                    box += rng.normal(0, 0.08 * min(w, h), 4)
                    cls = c if rng.uniform() < 0.85 else (c + 1) % 3
                    state = np.eye(S_TEST)[min(int(tag), S_TEST - 1)] + rng.normal(0, 0.6, S_TEST)
                    rows.append([*box, rng.integers(1, 9) / 8, cls,
                                 *(centers[int(tag)] + rng.normal(0, 0.5, E_TEST)), *state])
            for _ in range(2):
                x1, y1 = rng.uniform(0, imgsz - 16, 2)
                rows.append([x1, y1, x1 + 12, y1 + 12, rng.integers(1, 9) / 8, rng.integers(0, 3),
                             *rng.normal(size=E_TEST), *rng.normal(size=S_TEST)])
            dets[b, :len(rows)] = rows
        out.append((dets, batch))
    return out


def _run_validator(v, batches, logger, monkeypatch):
    """Two runs (init, update, finalize, print); returns the second run's results and the
    printed lines of both."""
    lines = []
    monkeypatch.setattr(logger, "info", lambda msg, *a: lines.append(str(msg)))
    for _ in range(2):
        v.init_metrics()
        for dets, batch in batches:
            v.update_metrics(dets, batch, batch["img"].shape[1:3])
        results = v.finalize_metrics()
        v.print_results(results, 12)
    return results, lines


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["float64", "float32"])
def test_jde_metrics_match_jax(dtype, tmp_path, monkeypatch):
    meta = {"nc": 3, "embed_dim": E_TEST, "state_classes": S_TEST}
    data = {"names": {0: "person", 1: "boat", 2: "car"},
            "person_states": {0: "stands", 1: "laying_down", 2: "walking"}}
    batches = _detections_from_gt(dtype)
    jv = jax_validator.JDEValidator()
    jv.meta, jv.data = meta, data
    jv.args = IterableSimpleNamespace(save_dir=str(tmp_path / "jax"), model="tinyjde.yaml",
                                      verbose=True)
    pv = port_validator.JDEValidator()
    pv.meta, pv.data = meta, data
    pv.args = get_cfg({"model": "tinyjde.yaml"})
    pv.args.save_dir = str(tmp_path / "port")
    want, want_lines = _run_validator(jv, batches, jax_validator.LOGGER, monkeypatch)
    got, got_lines = _run_validator(pv, batches, port_validator.LOGGER, monkeypatch)

    assert set(MATCH_KEYS) <= set(got)
    loose = {} if dtype == np.float64 else {"metrics/reid_silhouette": 1e-6,
                                            "metrics/reid_davies_bouldin": 1e-6}
    _assert_metrics_equal(got, want, 1e-9, loose)
    assert 0.3 < got["metrics/state_acc"] < 1 and got["metrics/reid_separation"] > 0.2
    assert 0 < got["metrics/mAP50(S)"] < 1 and got["metrics/mAP50-95(B)"] > 0
    for k in ("precision", "recall", "f1", "support"):
        np.testing.assert_allclose(pv.state_table[k], jv.state_table[k], rtol=0, atol=1e-12)
    assert got_lines == want_lines and any("laying_down" in s for s in got_lines)
    assert any(s.split()[:1] == ["boat"] for s in got_lines)  # the per-class table

    rows, jrows = _csv_rows(tmp_path / "port" / "jde_results.csv"), \
        _csv_rows(tmp_path / "jax" / "jde_results.csv")
    assert len(rows) == len(jrows) == 2 and rows[0].keys() == jrows[0].keys()
    for r, jr in zip(rows, jrows):
        for k in r:
            if k == "model":
                assert r[k] == jr[k]
            elif k != "timestamp":
                assert abs(float(r[k]) - float(jr[k])) <= (0 if dtype == np.float64 else 1e-5), k
    assert jax_read_xlsx(tmp_path / "port" / "jde_results.xlsx") == rows


# ---- (e) YOLO.val end to end -----------------------------------------------------------------

@pytest.fixture(scope="module", params=["tinyjde.yaml", "yolov13n-JDE.yaml"])
def val_pair(request):
    """JAX and port YOLO objects with the same numpy-seeded weights."""
    jyolo = JaxYOLO(request.param)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jyolo.model.init(jax.random.PRNGKey(0), x, train=False))
    variables = fill_variables(shapes, np.random.default_rng(7))
    jyolo.meta["strides"] = infer_strides(jyolo.model, jyolo.meta)
    jyolo.variables = variables
    pyolo = YOLO(request.param, device="cpu")
    pyolo.load_jax_variables(variables)
    return jyolo, pyolo


def _record_dets(monkeypatch, module):
    """Record the detections each validator of `module` hands to update_metrics."""
    seen = []
    orig = module.BaseValidator.update_metrics

    def update_metrics(self, dets, batch, hw):
        seen.append(np.array(dets))
        return orig(self, dets, batch, hw)
    monkeypatch.setattr(module.BaseValidator, "update_metrics", update_metrics)
    return seen


def _assert_same_batches(got, want):
    assert len(got) == len(want) == 3  # 16 images at batch 6: 6, 6 and 4 (2 pad rows dropped)
    assert [len(g) for g in got] == [6, 6, 4]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
        assert (g[..., 4] > 0).sum() > 0


def test_yolo_val_matches_jax(val_pair, tmp_path, monkeypatch):
    jyolo, pyolo = val_pair
    kw = dict(data="synthetic", imgsz=64, batch=6, save_json=True, save_txt=True, name="val",
              exist_ok=True)
    jdets = _record_dets(monkeypatch, jax_validator)
    pdets = _record_dets(monkeypatch, port_validator)
    want = jyolo.val(plots=False, project=str(tmp_path / "jax"), **kw)
    got = pyolo.val(project=str(tmp_path / "port"), **kw)
    _assert_same_batches(pdets, jdets)
    _assert_metrics_equal(got, want, 1e-6)
    assert "metrics/coco_mAP50-95" in got and got["speed/ms_per_image"] > 0
    jdir, pdir = tmp_path / "jax" / "jde" / "val", tmp_path / "port" / "jde" / "val"
    names = sorted(p.name for p in (jdir / "labels").iterdir())
    assert names == sorted(p.name for p in (pdir / "labels").iterdir()) and len(names) == 16
    # the files print rounded values of detections that agree within 1e-4 px: the same
    # lines and classes, numbers within that plus one unit of the last printed digit
    for n in names:
        got_rows = [ln.split() for ln in (pdir / "labels" / n).read_text().splitlines()]
        want_rows = [ln.split() for ln in (jdir / "labels" / n).read_text().splitlines()]
        assert [r[0] for r in got_rows] == [r[0] for r in want_rows] and got_rows, n
        np.testing.assert_allclose(np.array(got_rows, float)[:, 1:],
                                   np.array(want_rows, float)[:, 1:], rtol=0,
                                   atol=1e-4 / 64 + 1e-6, err_msg=n)
    got_json = json.loads((pdir / "predictions.json").read_text())
    want_json = json.loads((jdir / "predictions.json").read_text())
    assert [(r["image_id"], r["category_id"]) for r in got_json] == \
        [(r["image_id"], r["category_id"]) for r in want_json]
    np.testing.assert_allclose([r["bbox"] for r in got_json], [r["bbox"] for r in want_json],
                               rtol=0, atol=1e-4 + 1e-3)
    np.testing.assert_allclose([r["score"] for r in got_json], [r["score"] for r in want_json],
                               rtol=0, atol=1e-4 + 1e-5)
    rows, jrows = _csv_rows(pdir / "jde_results.csv"), _csv_rows(jdir / "jde_results.csv")
    assert [{k: v for k, v in r.items() if k != "timestamp"} for r in rows] == \
        [{k: v for k, v in r.items() if k != "timestamp"} for r in jrows]


class _PlantedDataset:
    """The synthetic val images with ground truth near the model's own detections: per
    image its 4 best rows, each box moved by a few percent; as tag, the row's argmax state
    (a state the model gets right), but the next state for each image's best row.

    With random weights the scores hardly depend on the image: the k-th best rows of all
    images score alike, within float32 rounding. AP ranks rows by score, so rows that
    score alike are made alike, correct or not, for the ranking not to depend on rounding.
    """

    def __init__(self, base, dets, embed_dim, seed=5):
        self.base, self.items = base, []
        rng = np.random.default_rng(seed)
        s = base.imgsz
        for i, d in enumerate(dets):
            d = d[d[:, 4] > 0][:4]
            item = dict(base[i])
            for k in ("cls", "bboxes", "mask", "tags"):
                item[k] = np.zeros_like(item[k])
            x1, y1, x2, y2 = d[:, :4].T
            w, h = x2 - x1, y2 - y1
            jit = rng.uniform(-0.06, 0.06, (len(d), 4)) * np.stack([w, h, w, h], 1)
            item["bboxes"][:len(d)] = (np.stack([(x1 + x2) / 2, (y1 + y2) / 2, w, h], 1) + jit) / s
            item["cls"][:len(d)] = d[:, 5]
            item["mask"][:len(d)] = 1
            states = d[:, 6 + embed_dim:].argmax(1)
            states[0] = (states[0] + 1) % (d.shape[1] - 6 - embed_dim)
            item["tags"][:len(d)] = states
            self.items.append(item)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("val_pair", ["tinyjde.yaml"], indirect=True)
def test_validators_on_planted_ground_truth_match_jax(val_pair, tmp_path, monkeypatch):
    """Both validators on the same fused weights, on ground truth planted near the model's
    detections: box mAP over every IoU threshold, state accuracy and the ReID metrics live.

    tinyjde only: with these weights yolov13n-JDE scores its 240 kept rows within 1e-5 of
    each other, so their ranking, and with it the AP, is decided by float32 rounding."""
    jyolo, pyolo = val_pair
    seen = _record_dets(monkeypatch, port_validator)
    pyolo.val(data="synthetic", imgsz=64, batch=16, project=str(tmp_path / "probe"))
    base = SyntheticDataset(n=16, imgsz=64, nc=1, max_labels=16, task="jde")
    ds = _PlantedDataset(base, seen[0], pyolo.meta["embed_dim"])
    data = {"nc": 1, "names": {0: "c0"}}
    jargs = jax_get_cfg(overrides={"model": jyolo.cfg, "task": "jde", "mode": "val", "batch": 6,
                                   "imgsz": 64, "plots": False, "max_labels": 16})
    jargs.save_dir = str(tmp_path / "jax")
    pargs = get_cfg({"model": pyolo.cfg, "batch": 6, "imgsz": 64, "max_labels": 16})
    pargs.save_dir = str(tmp_path / "port")
    jdets = _record_dets(monkeypatch, jax_validator)
    pdets = _record_dets(monkeypatch, port_validator)
    vmodel, vvars = jyolo._fused_for_serving()
    want = jax_validator.JDEValidator()(model=vmodel, variables=vvars, meta=jyolo.meta,
                                        dataset=ds, args=jargs, data=data)
    got = port_validator.JDEValidator()(model=pyolo._fused_for_serving(), meta=pyolo.meta,
                                        dataset=ds, args=pargs, data=data)
    _assert_same_batches(pdets, jdets)
    assert set(MATCH_KEYS) <= set(got)
    _assert_metrics_equal(got, want, 1e-6)
    assert 0.2 < got["metrics/mAP50-95(B)"] < got["metrics/mAP50(B)"]
    assert 0.5 < got["metrics/state_acc"] < 1 and 0 < got["metrics/mAP50(S)"] < 1


def test_coco80_to_91_map_matches_jax():
    from sar_yolo_tpu.data.converter import coco80_to_coco91_class
    assert port_validator.COCO80_TO_91 == coco80_to_coco91_class()


@pytest.fixture(scope="module")
def rect_data(tmp_path_factory):
    """A dataset YAML over 4 landscape (160x240) and 2 portrait (240x160) PNG images with
    6-column labels: at imgsz 256 and batch 3, rect batches of 192x288 and 288x192."""
    import cv2
    root = tmp_path_factory.mktemp("rect_data")
    rng = np.random.default_rng(3)
    for d in ("images/val", "labels/val"):
        (root / d).mkdir(parents=True)
    for i, (h, w) in enumerate([(160, 240), (240, 160)] * 3):
        img = cv2.resize(rng.integers(0, 256, (h // 16, w // 16, 3), np.uint8), (w, h),
                         interpolation=cv2.INTER_CUBIC)
        cv2.imwrite(str(root / "images" / "val" / f"{i:03d}.png"), img)
        rows = [f"0 {rng.uniform(.2, .8):.6f} {rng.uniform(.2, .8):.6f} {rng.uniform(.1, .3):.6f} "
                f"{rng.uniform(.1, .3):.6f} {rng.integers(0, 6)}" for _ in range(3)]
        (root / "labels" / "val" / f"{i:03d}.txt").write_text("\n".join(rows) + "\n")
    (root / "data.yaml").write_text("path: .\ntrain: images/val\nval: images/val\nnc: 1\n"
                                    "names:\n  0: person\n")
    return root


def test_rect_val_matches_jax(val_pair, rect_data, tmp_path, monkeypatch):
    """`YOLO.val(rect=True, save_json=True)` at imgsz 256 on a dataset folder: the same
    non-square batches (192x288, then 288x192), detections within 1e-4, metrics within
    1e-6 and the same predictions.json rows, with file-stem ids and native-pixel boxes.

    With these weights both models score hundreds of rows an image alike within 1e-5
    (the scores hardly depend on the image), so which of two overlapping rows NMS keeps
    is decided by float32 rounding at the default conf; both validate at a conf in the
    widest gap among the port's 12 best scores instead."""
    jyolo, pyolo = val_pair
    kw = dict(data=str(rect_data / "data.yaml"), imgsz=256, batch=3, rect=True, name="rect",
              exist_ok=True)
    seen = {"jax": [], "port": []}
    for label, module in (("jax", jax_validator), ("port", port_validator)):
        def update_metrics(self, dets, batch, hw, orig=module.BaseValidator.update_metrics,
                           out=seen[label]):
            out.append((np.array(dets), tuple(int(v) for v in hw)))
            return orig(self, dets, batch, hw)
        monkeypatch.setattr(module.BaseValidator, "update_metrics", update_metrics)
    pyolo.val(project=str(tmp_path / "probe"), **kw)
    top = np.unique(np.concatenate([d[..., 4][d[..., 4] > 0] for d, _ in seen["port"]]))[::-1][:12]
    j = int(np.argmax(top[:-1] - top[1:]))
    kw.update(conf=float(top[j] + top[j + 1]) / 2, save_json=True)
    seen["port"].clear()
    want = jyolo.val(plots=False, project=str(tmp_path / "jax"), **kw)
    got = pyolo.val(project=str(tmp_path / "port"), **kw)
    assert [hw for _, hw in seen["port"]] == [hw for _, hw in seen["jax"]] == [(192, 288),
                                                                              (288, 192)]
    for (g, _), (w, _) in zip(seen["port"], seen["jax"]):
        assert g.shape == w.shape and (g[..., 4] > 0).sum() > 0
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    _assert_metrics_equal(got, want, 1e-6)
    got_json = json.loads((tmp_path / "port" / "jde" / "rect" / "predictions.json").read_text())
    want_json = json.loads((tmp_path / "jax" / "jde" / "rect" / "predictions.json").read_text())
    assert [(r["image_id"], r["category_id"]) for r in got_json] == \
        [(r["image_id"], r["category_id"]) for r in want_json]
    assert {r["image_id"] for r in got_json} <= set(range(6))  # the file stems
    # native pixels: inside the 240x160 or 160x240 image
    assert all(0 <= r["bbox"][0] and r["bbox"][0] + r["bbox"][2] <= 240 for r in got_json)
    np.testing.assert_allclose([r["bbox"] for r in got_json], [r["bbox"] for r in want_json],
                               rtol=0, atol=1e-4 + 1e-3)
    np.testing.assert_allclose([r["score"] for r in got_json], [r["score"] for r in want_json],
                               rtol=0, atol=1e-4 + 1e-5)


# ---- (f) per-epoch validation in YOLO.train ---------------------------------------------------

def test_train_with_val_matches_jax(tmp_path, monkeypatch):
    common = dict(model="tinyjde.yaml", data="synthetic", imgsz=64, batch=16, nbs=16, workers=2,
                  max_labels=16, seed=0, optimizer="SGD", warmup_epochs=0.0, lr0=1e-3, epochs=2)
    jtr = jax_jde_trainer({**common, "mesh_shape": [1], "plots": False, "val": True,
                           "save": False, "project": str(tmp_path / "jax")}, seed=11,
                          monkeypatch=monkeypatch)
    ptr = port_trainer_like(jtr, {**common, "project": str(tmp_path / "port")})
    quiet = port_trainer_like(jtr, {**common, "val": False, "project": str(tmp_path / "quiet")})
    monkeypatch.setattr(jtr, "_setup_train", lambda: None)  # set up by jax_jde_trainer
    runs = {}
    for label, trainer in (("jax", jtr), ("port", ptr)):
        seen = runs[label] = []

        def record(validate=trainer.validate, seen=seen):
            seen.append(validate())
            return seen[-1]
        monkeypatch.setattr(trainer, "validate", record)
        trainer.train()
    assert len(runs["port"]) == len(runs["jax"]) == 2
    assert ptr.meta["nc"] == 3  # multi-label NMS in the validator
    for got, want in zip(runs["port"], runs["jax"]):
        _assert_metrics_equal(got, want, 1e-6)
    assert ptr.fitness == runs["port"][-1]["fitness"]  # not -sum(loss)
    assert ptr.fitness == pytest.approx(jtr.fitness, abs=1e-6)
    assert ptr.best_fitness == pytest.approx(jtr.best_fitness, abs=1e-6)
    got = {k: v for k, v in ptr.metrics.items() if k.startswith("train/")}
    assert got.keys() == {k for k in jtr.metrics if k.startswith("train/")}
    lines = (ptr.save_dir / "results.csv").read_text().splitlines()
    assert len(lines) == 3 and lines[0].startswith("epoch,train/box,") and "fitness" in lines[0]

    # the same run without validation: the same losses and weights, bit for bit
    quiet.train()
    assert {k: v for k, v in quiet.metrics.items() if k.startswith("train/")} == got
    assert quiet.fitness < 0 <= ptr.fitness  # -sum(loss) without validation
    for k, v in ptr.model.state_dict().items():
        assert torch.equal(v, quiet.model.state_dict()[k]), k
    for a, b in zip(ptr.ema, quiet.ema):
        assert torch.equal(a, b)
