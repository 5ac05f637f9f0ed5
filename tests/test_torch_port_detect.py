"""The detect task of the PyTorch port against the JAX package: yolov8n, yolo11n and
yolov12n (detect), yolo11n-JDE, and tinydet.

(a) the config dicts against `yaml.safe_load` of the JAX package's files, the name
rule (`yolo11n-JDE.yaml` -> `yolo11-JDE.yaml`, scale n) and `parse_model` against
JAX's, the l and x scales (C3k2's forced c3k, A2C2f's residual) included;
(b) whole-model forward maps at 64-96 px from `fill_variables` weights, unfused and
BN-folded (against `fuse_variables`), 1e-4 absolute in float32, with the parameter
count, the strict bridge, the strides, the task and `legacy` (the two-3x3 cls branch
of yolov8n; the depthwise one where a C3k2 or A2C2f comes first);
(c) single modules: C3k2 (c3k False and True), YoloAttention (its head-major qkv
channels), PSABlock, C2PSA and A2C2f(a2=False), 1e-4 absolute;
(d) the head's bias init at nc 80 against JAX's `bias_init_head`;
(e) `predict_batched` of yolov8n on ragged 480x640 frames against JAX's
`DetectionPredictor.predict_batch`: the same kept rows, boxes within 1e-3 px, scores
within 1e-4, at a threshold that lies in a gap of the scores;
(f) `YOLO.val(data="synthetic")` of yolov8n (per-batch detections: boxes within 1e-3 px,
scores within 1e-4; metrics within 1e-6), and both detect validators on ground truth
planted near the detections of tinydet (BN statistics calibrated, class and box logits
scaled so that its scores and boxes depend on the image), where the box mAP is live;
(g) `YOLO.track` of yolo11n (ByteTrack and BoT-SORT without camera-motion
compensation; detect Results carry no embeddings, so BoT-SORT matches by IoU) over
tests/data/jpeg/frames/: the ids of JAX's tracker run over JAX's `YOLO.predict`;
(h) `YOLO.train` of a detect model, then `YOLO(checkpoint)`: it serves and validates as
`detect` with its nc and names; `check_bf16` on a detect model.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sar_yolo_tpu.cfg import get_cfg as jax_get_cfg
from sar_yolo_tpu.engine import validator as jax_validator
from sar_yolo_tpu.nn.fuse import fuse as jax_fuse
from sar_yolo_tpu.nn.modules import block as JB
from sar_yolo_tpu.nn.tasks import bias_init_head as jax_bias_init_head
from sar_yolo_tpu.nn.tasks import build_model as jax_build_model
from sar_yolo_tpu.nn.tasks import parse_model as jax_parse_model
from sar_yolo_tpu.nn.tasks import yaml_model_load
from sar_yolo_tpu.trackers import track_results as jax_track_results
from sar_yolo_tpu.trackers.byte_tracker import STrack as JaxSTrack
from sar_yolo_tpu.utils import ROOT as JAX_ROOT
from sar_yolo_tpu_torch import YOLO
from sar_yolo_tpu_torch.cfg.default import get_cfg
from sar_yolo_tpu_torch.cfg.models import model_config
from sar_yolo_tpu_torch.data.dataset import SyntheticDataset
from sar_yolo_tpu_torch.engine import validator as port_validator
from sar_yolo_tpu_torch.engine.predictor import DetectionPredictor
from sar_yolo_tpu_torch.nn.fuse import fuse_model
from sar_yolo_tpu_torch.nn.modules import block as PB
from sar_yolo_tpu_torch.nn.tasks import bias_init_head, build_model, parse_model
from sar_yolo_tpu_torch.ops.decode import decode_detect
from sar_yolo_tpu_torch.trackers.byte_tracker import STrack
from sar_yolo_tpu_torch.utils.checks import check_bf16
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from torch_port_common import fill_variables, jax_and_port_yolo, one_torch_thread  # noqa: F401

ATOL = 1e-4
FRAMES = JAX_ROOT.parent / "tests" / "data" / "jpeg" / "frames"

# ---- (a) configs -----------------------------------------------------------------------------

CONFIGS = {"yolov8.yaml": "v8/yolov8.yaml", "yolo11.yaml": "11/yolo11.yaml",
           "yolov12.yaml": "v12/yolov12.yaml", "yolo11-JDE.yaml": "11/yolo11-JDE.yaml",
           "tinydet.yaml": "test/tinydet.yaml"}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_dict_equals_jax_yaml(name):
    with open(JAX_ROOT / "cfg" / "models" / CONFIGS[name]) as f:
        want = yaml.safe_load(f)
    got = model_config(name)
    assert got.pop("scale") == ""
    assert got == want


@pytest.mark.parametrize("name", ["yolov8n.yaml", "yolov8m.yaml", "yolo11n.yaml", "yolo11l.yaml",
                                  "yolo11x.yaml", "yolov12n.yaml", "yolov12l.yaml",
                                  "yolo11n-JDE.yaml", "yolo11s-JDE.yaml", "tinydet.yaml"])
def test_name_rule_and_parse_model_match_jax(name):
    jd = yaml_model_load(name)
    pd = model_config(name)
    assert pd["scale"] == jd["scale"]
    assert pd == {k: v for k, v in jd.items() if k != "yaml_file"}
    j_specs, j_save, j_meta = jax_parse_model(jd)
    p_specs, p_save, p_meta = parse_model(pd)

    def rows(specs):
        return [(s.i, s.f, s.name, s.args, s.c2, s.kwargs) for s in specs]

    assert rows(p_specs) == rows(j_specs)
    assert p_save == j_save
    assert p_meta == j_meta


# ---- (b) whole models ------------------------------------------------------------------------

MODELS = {"yolov8n.yaml": (64, "detect", True, 80), "yolo11n.yaml": (96, "detect", False, 1),
          "yolov12n.yaml": (96, "detect", False, 80), "yolo11n-JDE.yaml": (96, "jde", False, 1),
          "tinydet.yaml": (64, "detect", True, 3)}


def _jax_model(name, seed=0):
    model, meta = jax_build_model(name)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False))
    return model, meta, fill_variables(shapes, np.random.default_rng(seed))


@pytest.fixture(scope="module", params=list(MODELS), ids=lambda n: n.removesuffix(".yaml"))
def pair(request):
    """(name, jax model, variables, port model with the same weights, its meta, input)."""
    name = request.param
    jmodel, _, variables = _jax_model(name)
    pmodel, meta = build_model(name)
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    imgsz = MODELS[name][0]
    x = np.random.default_rng(1).uniform(0, 1, (2, imgsz, imgsz, 3)).astype(np.float32)
    return name, jmodel, variables, pmodel, meta, x


def _compare(jax_maps, port_maps):
    assert len(jax_maps) == len(port_maps) == 3
    for w, g in zip(jax_maps, port_maps):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)


def _port_forward(model, x):
    with torch.no_grad():
        return model(torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))


def test_forward_unfused_matches_jax(pair):
    name, jmodel, variables, pmodel, meta, x = pair
    _compare(jmodel.apply(variables, jnp.asarray(x), train=False), _port_forward(pmodel, x))
    _, task, legacy, nc = MODELS[name]
    assert (meta["task"], meta["legacy"], meta["nc"], meta["strides"]) == (task, legacy, nc,
                                                                         [8, 16, 32])
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in pmodel.parameters()) == n_jax


def test_forward_fused_matches_jax(pair):
    _, jmodel, variables, pmodel, _, x = pair
    fmodel, fvars = jax_fuse(jmodel, variables)
    fused = fuse_model(copy.deepcopy(pmodel))
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in fused.modules())
    _compare(fmodel.apply(fvars, jnp.asarray(x), train=False), _port_forward(fused, x))
    bridged = from_jax_variables(jax.device_get(fvars))
    own = fused.state_dict()
    assert set(bridged) == set(own)
    for k, v in bridged.items():
        torch.testing.assert_close(own[k], v, rtol=1e-5, atol=1e-6)


def test_cls_branch_follows_legacy():
    """yolov8n keeps the v8 cls branch (two 3x3 Convs of c3 = max(ch0, min(nc, 100)) = 80
    channels); yolo11n and yolov12n take the depthwise and pointwise one."""
    v8, _ = build_model("yolov8n.yaml")
    head = v8.blocks[-1]
    assert head.legacy and head.cv3_0_0.conv.weight.shape == (80, 64, 3, 3)
    assert head.cv3_0_1.conv.weight.shape == (80, 80, 3, 3)
    for name in ("yolo11n.yaml", "yolov12n.yaml"):
        head = build_model(name)[0].blocks[-1]
        assert not head.legacy and hasattr(head, "cv3_0_0dw") and not hasattr(head, "cv3_0_0")


# ---- (c) single modules ----------------------------------------------------------------------

def _nchw(a):
    return torch.tensor(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _check_module(jax_module, port_module, x, seed=0):
    jx = jnp.asarray(x)
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), jx, train=False))
    variables = fill_variables(shapes, np.random.default_rng(seed))
    port_module.load_state_dict(from_jax_variables(variables), strict=True)
    want = np.asarray(jax_module.apply(variables, jx, train=False)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = port_module.eval()(_nchw(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


MODULE_CASES = {
    "C3k2_bottleneck": lambda: (JB.C3k2(64, 1, False, 0.25), PB.C3k2(32, 64, 1, False, 0.25), 32),
    "C3k2_c3k": lambda: (JB.C3k2(64, 2, True), PB.C3k2(48, 64, 2, True), 48),
    "C3k2_no_shortcut": lambda: (JB.C3k2(32, 1, False, 0.5, 1, False),
                                 PB.C3k2(32, 32, 1, False, 0.5, 1, False), 32),
    "YoloAttention_2heads": lambda: (JB.YoloAttention(128, 2), PB.YoloAttention(128, 2), 128),
    "YoloAttention_4heads": lambda: (JB.YoloAttention(64, 4), PB.YoloAttention(64, 4), 64),
    "PSABlock": lambda: (JB.PSABlock(128, 0.5, 2), PB.PSABlock(128, 0.5, 2), 128),
    "C2PSA": lambda: (JB.C2PSA(256, 1), PB.C2PSA(256, 256, 1), 256),
    "A2C2f_a2_false": lambda: (JB.A2C2f(64, 1, False, -1), PB.A2C2f(96, 64, 1, False, -1), 96),
}


@pytest.mark.parametrize("case", list(MODULE_CASES))
def test_module_matches_jax(case):
    jax_module, port_module, c1 = MODULE_CASES[case]()
    x = np.random.default_rng(2).normal(0, 1, (2, 5, 7, c1)).astype(np.float32)  # 35 tokens
    _check_module(jax_module, port_module, x)
    if case == "A2C2f_a2_false":  # neither residual nor gamma without attention
        assert not port_module.residual and not hasattr(port_module, "gamma")


# ---- (d) the head's bias init ----------------------------------------------------------------

def test_bias_init_at_nc80_matches_jax():
    _, jmeta, variables = _jax_model("yolov8n.yaml", seed=4)
    jmeta["strides"] = [8, 16, 32]
    want = from_jax_variables(jax.device_get(jax_bias_init_head(variables, jmeta)))
    pmodel, meta = build_model("yolov8n.yaml")
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    bias_init_head(pmodel, meta)
    got = pmodel.state_dict()
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=1e-6, atol=0, msg=k)
    assert got["blocks.22.cv3_0_pred.bias"].shape == (80,)
    assert abs(got["blocks.22.cv3_2_pred.bias"][0].item() - np.log(5 / 80 / 20 ** 2)) < 1e-6


# ---- (e) predict_batched ---------------------------------------------------------------------

def _sorted_rows(d):
    """Kept rows ordered by class, then box (rows of near-equal score may swap places)."""
    d = d[d[:, 4] > 0]
    return d[np.lexsort((d[:, 3], d[:, 2], d[:, 1], d[:, 0], d[:, 5]))]


@pytest.fixture(scope="module")
def v8_pair():
    """yolov8n with BN statistics calibrated at 320 px (so that the outputs depend on the
    image) and its box logits scaled by 0.1 (boxes near their anchors)."""
    return jax_and_port_yolo("yolov8n.yaml", 3, box_gain=0.1, calibrate=320)


def _gap_conf(scores, lo: float, hi: float) -> float:
    """The middle of the widest gap between sorted scores in [lo, hi]."""
    s = np.sort(scores[(scores > lo) & (scores < hi)])
    s = np.r_[lo, s, hi]
    i = int(np.argmax(np.diff(s)))
    return float((s[i] + s[i + 1]) / 2)


def test_predict_batched_matches_jax(v8_pair):
    """Two crops of 480x640 from the JPEG fixtures, letterboxed to 320 (r = 0.5)."""
    import cv2
    jyolo, pyolo = v8_pair
    frames = np.stack([cv2.imread(str(FRAMES / f"frame_{i:02d}.jpg"))[100:580, 300:940]
                       for i in (0, 6)])
    predictor = pyolo._get_predictor({"imgsz": 320})
    assert type(predictor) is DetectionPredictor
    x, _, _ = predictor.preprocess(frames)
    with torch.no_grad():
        scores = decode_detect(predictor.model(x), pyolo.meta["strides"], 80, 16)[..., 4:]
    conf = _gap_conf(scores.flatten().numpy(), 0.89, 0.91)
    assert (scores - conf).abs().min() > 1e-5  # no score at the threshold
    assert (scores > conf).sum((1, 2)).max() < 1024  # under NMS's pre_topk
    kw = dict(imgsz=320, conf=conf, max_det=300)
    want = np.asarray(jyolo.predict_batched(frames, **kw))
    got = pyolo.predict_batched(frames, **kw)
    assert got.shape == want.shape == (2, 300, 6)
    for b in range(2):
        g, w = _sorted_rows(got[b]), _sorted_rows(want[b])
        assert len(g) == len(w)
        assert 10 < len(g) < 300 and len(np.unique(g[:, 5])) > 1
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=1e-4)
        res = predictor.postprocess(got[b:b + 1], f"f{b}", frames[b], {})
        jres = jyolo._get_predictor(kw).postprocess(want[b:b + 1], f"f{b}", frames[b], {})
        assert res.embeds is None and res.person_states is None and res.boxes.data.shape[1] == 6
        assert len(res) == len(jres) and res.verbose() == jres.verbose()
    assert not np.array_equal(_sorted_rows(got[0]), _sorted_rows(got[1]))  # image-dependent


# ---- (f) validation --------------------------------------------------------------------------

def _record_dets(monkeypatch, module):
    seen = []
    orig = module.BaseValidator.update_metrics

    def update_metrics(self, dets, batch, hw):
        seen.append(np.array(dets))
        return orig(self, dets, batch, hw)
    monkeypatch.setattr(module.BaseValidator, "update_metrics", update_metrics)
    return seen


def _assert_metrics_equal(got: dict, want: dict, tol: float):
    keys = set(want) - {"speed/ms_per_image"}
    assert keys <= set(got), keys - set(got)
    for k in keys:
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


def _assert_same_dets(got_batches, want_batches):
    """The same kept rows per image: classes equal, boxes within 1e-3 px, scores 1e-4."""
    assert len(got_batches) == len(want_batches)
    for g, w in zip(got_batches, want_batches):
        assert g.shape == w.shape and g.shape[-1] == 6 and (g[..., 4] > 0).sum() > 0
        for b in range(len(g)):
            gs, ws = _sorted_rows(g[b]), _sorted_rows(w[b])
            assert len(gs) == len(ws)
            np.testing.assert_array_equal(gs[:, 5], ws[:, 5])
            np.testing.assert_allclose(gs[:, :4], ws[:, :4], rtol=0, atol=1e-3)
            np.testing.assert_allclose(gs[:, 4], ws[:, 4], rtol=0, atol=1e-4)


def test_yolo_val_matches_jax(v8_pair, tmp_path, monkeypatch):
    jyolo, pyolo = v8_pair
    kw = dict(data="synthetic", imgsz=64, batch=6, name="val", exist_ok=True)
    jdets = _record_dets(monkeypatch, jax_validator)
    pdets = _record_dets(monkeypatch, port_validator)
    want = jyolo.val(plots=False, project=str(tmp_path / "jax"), **kw)
    got = pyolo.val(project=str(tmp_path / "port"), **kw)
    assert [len(d) for d in pdets] == [len(d) for d in jdets] == [6, 6, 4]
    _assert_same_dets(pdets, jdets)
    _assert_metrics_equal(got, want, 1e-6)


class _PlantedDataset:
    """The synthetic val images with ground truth near the model's own detections: per
    image its 4 best rows, each box moved by a few percent, with the row's class."""

    def __init__(self, base, dets, seed=5):
        self.items = []
        rng = np.random.default_rng(seed)
        s = base.imgsz
        for i, d in enumerate(dets):
            d = d[d[:, 4] > 0][:4]
            item = dict(base[i])
            for k in ("cls", "bboxes", "mask"):
                item[k] = np.zeros_like(item[k])
            x1, y1, x2, y2 = d[:, :4].T
            w, h = x2 - x1, y2 - y1
            jit = rng.uniform(-0.06, 0.06, (len(d), 4)) * np.stack([w, h, w, h], 1)
            item["bboxes"][:len(d)] = (np.stack([(x1 + x2) / 2, (y1 + y2) / 2, w, h], 1) + jit) / s
            item["cls"][:len(d)] = d[:, 5]
            item["mask"][:len(d)] = 1
            self.items.append(item)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_detect_validators_on_planted_ground_truth_match_jax(tmp_path, monkeypatch):
    jyolo, pyolo = jax_and_port_yolo("tinydet.yaml", 7, cls_gain=0.2, box_gain=0.1, calibrate=64)
    seen = _record_dets(monkeypatch, port_validator)
    pyolo.val(data="synthetic", imgsz=64, batch=16, project=str(tmp_path / "probe"))
    base = SyntheticDataset(n=16, imgsz=64, nc=3, max_labels=16, task="detect")
    ds = _PlantedDataset(base, seen[0])
    data = {"nc": 3, "names": {i: f"c{i}" for i in range(3)}}
    jargs = jax_get_cfg(overrides={"model": jyolo.cfg, "task": "detect", "mode": "val", "batch": 6,
                                   "imgsz": 64, "plots": False, "max_labels": 16})
    jargs.save_dir = str(tmp_path / "jax")
    pargs = get_cfg({"model": pyolo.cfg, "batch": 6, "imgsz": 64, "max_labels": 16})
    pargs.save_dir = str(tmp_path / "port")
    jdets = _record_dets(monkeypatch, jax_validator)
    pdets = _record_dets(monkeypatch, port_validator)
    vmodel, vvars = jyolo._fused_for_serving()
    want = jax_validator.DetectionValidator()(model=vmodel, variables=vvars, meta=jyolo.meta,
                                              dataset=ds, args=jargs, data=data)
    got = port_validator.DetectionValidator()(model=pyolo._fused_for_serving(), meta=pyolo.meta,
                                              dataset=ds, args=pargs, data=data)
    _assert_same_dets(pdets, jdets)
    _assert_metrics_equal(got, want, 1e-6)
    assert 0.2 < got["metrics/mAP50-95(B)"] < got["metrics/mAP50(B)"]


# ---- (g) tracking ----------------------------------------------------------------------------

TRACKERS = {
    "bytetrack": "tracker_type: bytetrack\n",
    "botsort_no_gmc": "tracker_type: botsort\ngmc_method: none\nproximity_thresh: 0.5\n"
                      "appearance_thresh: 0.25\nwith_reid: True\n",
}
TRACK_COMMON = ("track_high_thresh: 0.5\ntrack_low_thresh: 0.1\nnew_track_thresh: 0.6\n"
                "track_buffer: 30\nmatch_thresh: 0.8\nfuse_score: True\n")


@pytest.fixture(scope="module")
def v11_pair():
    return jax_and_port_yolo("yolo11n.yaml", 5, cls_gain=30.0)


@pytest.mark.parametrize("kind", list(TRACKERS))
def test_yolo_track_matches_jax_tracker_over_the_frames(kind, v11_pair, tmp_path):
    jyolo, pyolo = v11_pair
    pyolo._predictor_cache = None
    cfg = tmp_path / f"{kind}.yaml"
    cfg.write_text(TRACKERS[kind] + TRACK_COMMON)
    kw = dict(imgsz=128, conf=0.1)
    STrack._count = JaxSTrack._count = 0
    want = jax_track_results(jyolo.predict(str(FRAMES), **kw), str(cfg))
    STrack._count = 0
    got = pyolo.track(str(FRAMES), tracker=str(cfg), **kw)
    assert len(got) == len(want) == 12
    ids = []
    for g, w in zip(got, want):
        assert g.embeds is None and len(g) == len(w)
        if len(w) and w.boxes.is_track:
            np.testing.assert_array_equal(g.boxes.id, w.boxes.id)
            np.testing.assert_allclose(g.boxes.data[:, :5], w.boxes.data[:, :5], rtol=0,
                                       atol=1e-3)
            ids += g.boxes.id.astype(int).tolist()
    assert len(ids) > len(set(ids)) > 0  # tracks carry over frames


# ---- (h) training, checkpoints, bf16 ---------------------------------------------------------

def test_detect_checkpoint_serves_as_detect(tmp_path):
    """A detect run's checkpoint records its task: `YOLO(checkpoint)` serves and validates
    it as a detect model with the run's nc and names."""
    m = YOLO("tinydet.yaml", device="cpu")
    metrics = m.train(data="synthetic", imgsz=64, batch=8, epochs=1, workers=0, max_labels=16,
                      project=str(tmp_path))
    assert {"train/box", "train/cls", "train/dfl", "fitness", "metrics/mAP50(B)"} <= set(metrics)
    assert not any(k in metrics for k in ("train/emb", "train/state", "metrics/mAP50(S)"))
    assert all(np.isfinite(v) for v in metrics.values())
    assert (tmp_path / "detect" / "detect" / "results.csv").exists()
    ckpt = tmp_path / "detect" / "detect" / "weights" / "best"
    m2 = YOLO(str(ckpt), device="cpu")
    assert m2.task == "detect" and m2.meta["task"] == "detect"
    assert m2.meta["nc"] == 3 and m2.names == {0: "class0", 1: "class1", 2: "class2"}
    frames = np.random.default_rng(0).integers(0, 256, (2, 48, 64, 3), np.uint8)
    want = m.predict_batched(frames, imgsz=64, conf=0.001)
    got = m2.predict_batched(frames, imgsz=64, conf=0.001)
    assert got.shape == (2, 300, 6) and (got[..., 4] > 0).any()
    np.testing.assert_array_equal(got, want)
    res = m2.predict(frames[0], imgsz=64, conf=0.001)[0]
    assert res.embeds is None and len(res) > 0
    assert set(m2.val(data="synthetic", imgsz=64, batch=8, project=str(tmp_path))) >= \
        {"metrics/mAP50(B)", "fitness"}


@pytest.mark.parametrize("name", ["yolov8n.yaml", "yolov12n.yaml"])
def test_check_bf16_runs_on_a_detect_model(name):
    model, meta = build_model(name)
    from sar_yolo_tpu_torch.nn.tasks import init_weights
    init_weights(model, meta, torch.Generator().manual_seed(0))
    model.train()
    assert check_bf16(model, imgsz=64)
    assert model.compute_dtype == torch.bfloat16 and model.training
