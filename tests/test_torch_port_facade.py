"""Model YAML files, the facade's remaining methods, the trainer's callback bus and sliced
inference of the PyTorch port against the JAX package.

(a) each of the 67 model YAML files under `sar_yolo_tpu_torch/cfg/models/` is a copy of
the JAX package's and loads equal to JAX's `yaml_model_load` of the original, from an
absolute path, a relative path and by name; a path whose stem carries a scale letter
builds as in JAX; the fork's configs, RT-DETR's and YOLO-World's that load by name
build with JAX's parameter count (an RT-DETR graph counted through its denoising path);
(b) `YOLO.train` runs each of the ten trainer events as often and at the same epochs as
JAX's trainer does (tinyjde, 2 epochs, synthetic data);
(c) `YOLO(model, task=...)`, `save` / `load` / `reset_weights` / `fuse` round trips,
`clear_callback` and `reset_callbacks`;
(d) `info`: the parameter count and the per-layer table of JAX's `info`; `profile`: JAX's
keys, and `gflops` within 5% of JAX's XLA cost analysis (yolov13n-JDE_CBAM at 640);
(e) `ops/slicing.py` (`tile_grid`, `merge_tile_detections`, `sliced_predict`) and
`Ensemble.predict` against JAX's on the same weights and frames.
"""

import ast
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.engine.model import Ensemble as JaxEnsemble
from sar_yolo_tpu.engine.model import YOLO as JaxYOLO
from sar_yolo_tpu.nn.tasks import build_model as jax_build_model
from sar_yolo_tpu.nn.tasks import yaml_model_load
from sar_yolo_tpu.ops import slicing as jax_slicing
from sar_yolo_tpu.utils import ROOT as JAX_ROOT
from sar_yolo_tpu_torch import YOLO
from sar_yolo_tpu_torch.cfg.models import MODELS_DIR, model_config
from sar_yolo_tpu_torch.engine.model import Ensemble
from sar_yolo_tpu_torch.nn.tasks import build_model
from sar_yolo_tpu_torch.ops import slicing
from sar_yolo_tpu_torch.utils.checkpoint import load_checkpoint
from torch_port_common import fill_variables, jax_and_port_yolo, one_torch_thread  # noqa: F401

FRAMES = JAX_ROOT.parent / "tests" / "data" / "jpeg" / "frames"
YAMLS = sorted(str(p.relative_to(MODELS_DIR)) for p in MODELS_DIR.rglob("*.yaml"))
EVENTS = ("on_pretrain_routine_start", "on_pretrain_routine_end", "on_train_start",
          "on_train_epoch_start", "on_train_batch_start", "on_train_batch_end",
          "on_train_epoch_end", "on_fit_epoch_end", "on_train_end", "on_model_save")


def _jax_variables(model, seed: int = 0):
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False))
    return fill_variables(shapes, np.random.default_rng(seed))


# ---- (a) model YAML files --------------------------------------------------------------------

def test_every_jax_model_yaml_is_copied():
    jax_dir = JAX_ROOT / "cfg" / "models"
    assert YAMLS == sorted(str(p.relative_to(jax_dir)) for p in jax_dir.rglob("*.yaml"))
    assert len(YAMLS) == 67


@pytest.mark.parametrize("rel", YAMLS)
def test_model_yaml_loads_as_jax(rel):
    jax_file, port_file = JAX_ROOT / "cfg" / "models" / rel, MODELS_DIR / rel
    assert port_file.read_bytes() == jax_file.read_bytes()
    want = {k: v for k, v in yaml_model_load(jax_file).items() if k != "yaml_file"}
    assert model_config(port_file) == want
    assert model_config(Path(os.path.relpath(port_file))) == want
    name = Path(rel).name
    assert model_config(name) == {k: v for k, v in yaml_model_load(name).items()
                                  if k != "yaml_file"}


def test_yaml_path_with_a_scale_letter_builds_as_jax(tmp_path):
    path = tmp_path / "yolov13s-JDE_CBAM.yaml"
    path.write_bytes((MODELS_DIR / "v13" / "yolov13-JDE_CBAM.yaml").read_bytes())
    want = {k: v for k, v in yaml_model_load(path).items() if k != "yaml_file"}
    assert want["scale"] == "s" and model_config(path) == want
    yolo = YOLO(str(path), device="cpu")
    assert yolo.meta["scale"] == "s" and yolo.task == "jde"
    with pytest.raises(FileNotFoundError):
        model_config(tmp_path / "no-such-model.yaml")


@pytest.mark.parametrize("name", ["yolov13n-JDE_CBAM.yaml", "yolov13n-P24_CBAM_JDE.yaml",
                                  "yolo11n-JDE_CBAM.yaml", "yolo11n-P24_CBAM_JDE.yaml",
                                  "yolo11n-P24_JDE.yaml", "yolov13n.yaml", "yolov8n-p2.yaml",
                                  "yolo_nas.yaml", "rtdetr-resnet50.yaml", "rtdetr-x.yaml",
                                  "tinyworld.yaml", "yolov8s-world.yaml", "rtdetr-l.yaml",
                                  "yolov8n-rtdetr.yaml"])
def test_named_config_builds_with_jax_parameter_count(name):
    model, meta = build_model(name)
    jmodel, jmeta = jax_build_model(name)
    if jmeta.get("head") == "RTDETRDecoder":  # denoising_class_embed exists on that path only
        gt = {"cls": jnp.zeros((1, 4), jnp.int32), "bboxes": jnp.full((1, 4, 4), 0.5),
              "mask": jnp.zeros((1, 4))}
        key = jax.random.PRNGKey(0)
        params = jax.eval_shape(lambda: jmodel.init({"params": key, "dropout": key, "dn": key},
                                                    jnp.zeros((1, 64, 64, 3)), train=True,
                                                    batch_gt=gt))["params"]
    else:
        params = _jax_variables(jmodel)["params"]
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert (meta["task"], meta["scale"], meta["nl"]) == (jmeta["task"], jmeta["scale"], jmeta["nl"])


# ---- (b) the trainer's callback bus ----------------------------------------------------------

def _counting(yolo) -> dict:
    """The epoch each call of each trainer event saw, and the metric keys at each
    on_fit_epoch_end."""
    seen = {e: [] for e in (*EVENTS, "fit_epoch_metrics")}
    for event in EVENTS:
        yolo.add_callback(event, lambda tr, event=event: seen[event].append(tr.epoch))
    yolo.add_callback("on_fit_epoch_end",
                      lambda tr: seen["fit_epoch_metrics"].append(sorted(tr.metrics)))
    return seen


def test_trainer_callbacks_match_jax(tmp_path):
    common = dict(data="synthetic", imgsz=64, batch=16, epochs=2, seed=0, val=False,
                  optimizer="SGD", warmup_epochs=0.0)
    jyolo = JaxYOLO("tinyjde.yaml")
    want = _counting(jyolo)
    jyolo.train(**common, plots=False, mesh_shape=[1], project=str(tmp_path / "jax"))
    pyolo = YOLO("tinyjde.yaml", device="cpu")
    got = _counting(pyolo)
    pyolo.train(**common, workers=2, project=str(tmp_path / "port"))
    assert want["on_train_batch_end"] == [0] * 4 + [1] * 4 and want["on_model_save"] == [0, 1]
    assert got == want


# ---- (c) the facade's methods ----------------------------------------------------------------

def _frames(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (2, 72, 128, 3), dtype=np.uint8)


def test_task_is_recorded_in_overrides_and_checkpoint(tmp_path):
    yolo = YOLO("tinyjde.yaml", task="jde", device="cpu")
    assert yolo.task == JaxYOLO("tinyjde.yaml", task="jde").task == "jde"
    assert yolo.overrides["task"] == JaxYOLO("tinyjde.yaml", task="jde").overrides["task"]
    _, meta = load_checkpoint(yolo.save(tmp_path / "ck"))
    assert meta["task"] == meta["train_args"]["task"] == "jde"
    assert YOLO(str(tmp_path / "ck"), device="cpu").task == "jde"
    assert YOLO(str(tmp_path / "ck"), task="detect", device="cpu").task == "detect"


def test_save_load_reset_weights_and_fuse_round_trips(tmp_path):
    yolo = YOLO("tinyjde.yaml", device="cpu")
    kw = dict(imgsz=64, conf=0.001)
    want = yolo.predict_batched(_frames(), **kw)
    ck = yolo.save(tmp_path / "ck")
    np.testing.assert_array_equal(YOLO(ck, device="cpu").predict_batched(_frames(), **kw), want)
    with torch.no_grad():
        for p in yolo.model.parameters():
            p.add_(0.1)
    yolo._drop_caches()
    assert not np.array_equal(yolo.predict_batched(_frames(), **kw), want)
    np.testing.assert_array_equal(yolo.load(ck).predict_batched(_frames(), **kw), want)
    # fuse: BN folded in place, the same detections, and save() writes the unfused weights
    yolo.fuse()
    assert yolo.fused and not any(isinstance(m, torch.nn.BatchNorm2d)
                                  for m in yolo.model.modules())
    np.testing.assert_array_equal(yolo.predict_batched(_frames(), **kw), want)
    state, _ = load_checkpoint(yolo.save(tmp_path / "ck_fused"))
    assert state["model"].keys() == load_checkpoint(ck)[0]["model"].keys()
    np.testing.assert_array_equal(YOLO(str(tmp_path / "ck_fused"), device="cpu")
                                  .predict_batched(_frames(), **kw), want)
    # load and reset_weights on a fused model: unfused again
    yolo.load(ck)
    assert not yolo.fused and any(isinstance(m, torch.nn.BatchNorm2d) for m in yolo.model.modules())
    yolo.fuse().reset_weights()
    fresh = YOLO("tinyjde.yaml", device="cpu")
    fresh._ensure_variables()
    assert not yolo.fused
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(yolo.model.state_dict()[k], v), k
    np.testing.assert_array_equal(yolo.predict_batched(_frames(), **kw), want)


def test_a_folded_model_without_its_weights_does_not_save(tmp_path):
    from sar_yolo_tpu_torch.nn.fuse import fuse_model
    yolo = YOLO("tinyjde.yaml", device="cpu")
    yolo._ensure_variables()
    fuse_model(yolo.model)
    with pytest.raises(ValueError, match="unfused weights"):
        yolo.save(tmp_path / "ck")


def test_clear_callback_and_reset_callbacks():
    yolo = YOLO("tinyjde.yaml", device="cpu")
    calls = []
    yolo.add_callback("on_predict_start", lambda p: calls.append("start"))
    yolo.add_callback("on_predict_end", lambda p: calls.append("end"))
    yolo.predict(_frames()[0], imgsz=64)
    assert calls == ["start", "end"]
    yolo.clear_callback("on_predict_start")
    yolo.predict(_frames()[0], imgsz=64)
    assert calls == ["start", "end", "end"]
    yolo.reset_callbacks()
    yolo.predict(_frames()[0], imgsz=64)
    assert calls == ["start", "end", "end"] and yolo._callbacks == {}


# ---- (d) info and profile --------------------------------------------------------------------

def _table(summary: str) -> list:
    rows = []
    for line in summary.splitlines()[2:]:
        idx, module, params, shape = line.split(maxsplit=3)
        rows.append((int(idx), module, int(params.replace(",", "")), ast.literal_eval(shape)))
    return rows


def test_info_matches_jax():
    jyolo = JaxYOLO("yolov13n-JDE_CBAM.yaml")
    jyolo.variables = _jax_variables(jyolo.model)
    want = jyolo.info(detailed=True, verbose=False, imgsz=64)
    got = YOLO("yolov13n-JDE_CBAM.yaml", device="cpu").info(detailed=True, verbose=False,
                                                             imgsz=64)
    params = [int(s.split("params=")[1].split()[0].replace(",", "")) for s in (got, want)]
    assert params[0] == params[1] == 5599240
    rows, jrows = _table(got), _table(want)
    assert [r[:3] for r in rows] == [r[:3] for r in jrows]
    for r, j in zip(rows[:-1], jrows[:-1]):  # NCHW against NHWC; the head's maps apart
        assert r[3] == (j[3][0], j[3][3], j[3][1], j[3][2]), r
    assert [s[1] for s in rows[-1][3]] == [64 + 1 + 256 + 6] * 3 and [s[2:] for s in rows[-1][3]] == \
        [(8, 8), (4, 4), (2, 2)]


def test_profile_keys_and_gflops_match_jax():
    """FlopCounterMode's count of the port's forward against XLA's cost analysis of JAX's:
    convolutions and matmuls against every operation of the fused program."""
    jyolo = JaxYOLO("yolov13n-JDE_CBAM.yaml")
    jyolo.variables = _jax_variables(jyolo.model)
    want = jyolo.profile(imgsz=640, batch=1, n_iter=1)
    got = YOLO("yolov13n-JDE_CBAM.yaml", device="cpu").profile(imgsz=640, batch=1, n_iter=1)
    assert got.keys() == want.keys()
    assert got["params"] == want["params"] and (got["imgsz"], got["batch"]) == (640, 1)
    print(f"gflops {got['gflops']} (FlopCounterMode) / {want['gflops']} (XLA) = "
          f"{got['gflops'] / want['gflops']:.4f}; bytes {got['bytes_accessed_gb']} / "
          f"{want['bytes_accessed_gb']} GB")
    assert abs(got["gflops"] / want["gflops"] - 1) < 0.05, (got["gflops"], want["gflops"])
    assert got["bytes_accessed_gb"] > 0 and got["latency_ms"] > 0 and got["imgs_per_sec"] > 0


# ---- (e) sliced inference and Ensemble -------------------------------------------------------

@pytest.mark.parametrize("hw", [(100, 100), (720, 1280), (513, 2000)])
def test_tile_grid_matches_jax(hw):
    assert slicing.tile_grid(*hw, 512, 0.2) == jax_slicing.tile_grid(*hw, 512, 0.2)


def test_merge_tile_detections_matches_jax():
    rng = np.random.default_rng(0)
    per_tile = []
    for _ in range(3):
        n = int(rng.integers(0, 30))
        xy = rng.uniform(0, 100, (n, 2))
        wh = rng.uniform(5, 40, (n, 2))
        per_tile.append(np.concatenate([xy, xy + wh, rng.uniform(0, 1, (n, 1)),
                                        rng.integers(0, 2, (n, 1)), rng.normal(size=(n, 3))],
                                       1).astype(np.float32))
    offsets = [(0, 0), (0, 60), (60, 0)]
    for iou, max_det in ((0.5, 300), (0.3, 10)):
        np.testing.assert_array_equal(slicing.merge_tile_detections(per_tile, offsets, iou, max_det),
                                      jax_slicing.merge_tile_detections(per_tile, offsets, iou,
                                                                        max_det))
    assert slicing.merge_tile_detections([np.zeros((0, 6))], [(0, 0)]).shape == (0, 6)


def _gap_conf(scores) -> float:
    """The middle of the widest gap between the 40 highest distinct scores."""
    s = np.unique(scores)[::-1][:40]
    i = int(np.argmax(-np.diff(s)))
    assert s[i] - s[i + 1] > 1e-4
    return float((s[i] + s[i + 1]) / 2)


def _assert_same_rows(got, want):
    def rows(d):
        return d[np.lexsort((d[:, 3], d[:, 2], d[:, 1], d[:, 0], d[:, 5]))]
    assert len(got) == len(want) > 0
    g, w = rows(np.asarray(got)), rows(np.asarray(want))
    np.testing.assert_array_equal(g[:, 5], w[:, 5])
    np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def tiny_pairs():
    """Two tinyjde pairs (JAX, port) with BN calibrated at 64 px and box logits scaled by
    0.1, so that scores spread and boxes stay near their anchors."""
    return [jax_and_port_yolo("tinyjde.yaml", seed, box_gain=0.1, calibrate=64)
            for seed in (3, 4)]


def test_sliced_predict_matches_jax(tiny_pairs):
    import cv2
    jyolo, pyolo = tiny_pairs[0]
    img = cv2.imread(str(FRAMES / "frame_03.jpg"))[200:360, 400:640]
    tiles = np.stack([slicing._pad_crop(img, oy, ox, 64)
                      for oy, ox in slicing.tile_grid(160, 240, 64, 0.25)])[..., ::-1]
    scores = np.concatenate([r.boxes.conf for r in pyolo.predict(tiles, imgsz=64, conf=0.001)])
    conf = _gap_conf(scores)
    kw = dict(tile=64, overlap=0.25, conf=conf, merge_iou=0.5)
    got = slicing.sliced_predict(pyolo, img, **kw)
    want = jax_slicing.sliced_predict(jyolo, img, **kw)
    assert got.shape[1] == 6
    _assert_same_rows(got, want)


def test_ensemble_matches_jax(tiny_pairs):
    jyolos, pyolos = zip(*tiny_pairs)
    frames = [str(f) for f in sorted(FRAMES.glob("*.jpg"))[:4]]
    scores = np.concatenate([r.boxes.conf for y in pyolos
                             for r in y.predict(frames, imgsz=64, conf=0.001)])
    kw = dict(imgsz=64, conf=_gap_conf(scores), merge_iou=0.5)
    got = Ensemble(list(pyolos)).predict(frames, **kw)
    want = JaxEnsemble(list(jyolos)).predict(frames, **kw)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _assert_same_rows(g, w)
