"""The serving path of the PyTorch port against the JAX package.

Letterbox, decode + NMS with an embedding bank, and `YOLO.predict_batched`
end to end on ragged uint8 frames (and with conf=None, the 0.25 default), all on
identical numpy inputs and weights: the same kept rows and classes, boxes within
1e-3 px, embeddings within 1e-3 and equal posture states. Also: the port imports nothing of JAX (an AST scan
of every module, the trackers and loaders included), nor scikit-learn, OpenCV, PIL,
pandas or PyYAML, which the card lacks; and its entry points refuse to run on the CPU
unless asked.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.engine.model import YOLO as JaxYOLO
from sar_yolo_tpu.ops.decode import decode_detect as jax_decode_detect
from sar_yolo_tpu.ops.nms import non_max_suppression as jax_nms
from sar_yolo_tpu.ops.preprocess import letterbox_device as jax_letterbox
from sar_yolo_tpu_torch.engine.model import YOLO
from sar_yolo_tpu_torch.ops.decode import decode_detect
from sar_yolo_tpu_torch.ops.nms import non_max_suppression
from sar_yolo_tpu_torch.ops.preprocess import letterbox_device
from torch_port_common import fill_variables, one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
BOX_ATOL = 1e-3


def _frames(b, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("hw,imgsz", [((72, 128), 96), ((50, 70), 64), ((48, 80), 96),
                                      ((33, 17), 64)], ids=str)
def test_letterbox_matches_jax(hw, imgsz):
    img = _frames(1, *hw)[0]
    want, wr, wpad = jax_letterbox(jnp.asarray(img), imgsz, scaleup=False)
    got, r, pad = letterbox_device(torch.from_numpy(img), imgsz, scaleup=False)
    assert (r, tuple(pad)) == (wr, tuple(wpad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    # the batched form gives each image its own letterbox
    both, _, _ = letterbox_device(torch.from_numpy(_frames(2, *hw)), imgsz, scaleup=False)
    np.testing.assert_allclose(both[0].numpy(), got.numpy(), rtol=0, atol=0)


def _kept(dets, b):
    d = dets[b]
    return d[d[:, 4] > 0]


def _assert_same_detections(got, want, n_emb: int):
    assert got.shape == want.shape
    for b in range(got.shape[0]):
        g, w = _kept(got, b), _kept(want, b)
        assert len(g) == len(w) and len(g) > 0
        np.testing.assert_array_equal(g[:, 5], w[:, 5])  # classes
        np.testing.assert_allclose(g[:, :5], w[:, :5], rtol=0, atol=BOX_ATOL)
        np.testing.assert_allclose(g[:, 6:6 + n_emb], w[:, 6:6 + n_emb], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g[:, 6 + n_emb:], w[:, 6 + n_emb:], rtol=0, atol=1e-5)


@pytest.mark.parametrize("levels", [((8, 8), (4, 4), (2, 2)), ((32, 32), (16, 16), (8, 8))],
                         ids=["84anchors", "1344anchors_over_pre_topk"])
def test_decode_and_nms_with_embedding_bank_match_jax(levels):
    nc, emb, states = 3, 4, 2
    rng = np.random.default_rng(5)
    feats = [rng.normal(0, 2, (2, h, w, 64 + nc + emb + states)).astype(np.float32)
             for h, w in levels]
    strides = [8, 16, 32]
    jp, jbank = jax_decode_detect([jnp.asarray(f) for f in feats], strides, nc,
                                  extra_sigmoid=states, split_extras=emb)
    pp, pbank = decode_detect([torch.tensor(f.transpose(0, 3, 1, 2)) for f in feats], strides,
                              nc, extra_sigmoid=states, split_extras=emb)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=0, atol=1e-3)
    np.testing.assert_allclose(pbank.numpy(), np.asarray(jbank), rtol=0, atol=0)
    # NMS on identical inputs (the JAX decode's), with the embedding bank
    want = np.asarray(jax_nms(jp, conf_thres=0.5, iou_thres=0.5, max_det=30, nc=nc,
                              extras_bank=jbank))
    got = non_max_suppression(torch.tensor(np.asarray(jp)), conf_thres=0.5, iou_thres=0.5,
                              max_det=30, nc=nc, extras_bank=torch.tensor(np.asarray(jbank)))
    _assert_same_detections(got.numpy(), want, emb)


@pytest.fixture(scope="module")
def jde_pair():
    """JAX and port YOLO objects for yolov13n-JDE with the same numpy-seeded weights."""
    jyolo = JaxYOLO("yolov13n-JDE.yaml")
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jyolo.model.init(jax.random.PRNGKey(0), x, train=False))
    variables = fill_variables(shapes, np.random.default_rng(7))
    from sar_yolo_tpu.nn.tasks import infer_strides
    jyolo.meta["strides"] = infer_strides(jyolo.model, jyolo.meta)
    jyolo.variables = variables
    pyolo = YOLO("yolov13n-JDE.yaml", device="cpu")
    pyolo.load_jax_variables(variables)
    return jyolo, pyolo


def test_predict_batched_matches_jax(jde_pair):
    jyolo, pyolo = jde_pair
    frames = _frames(2, 72, 128, seed=3)  # ragged: letterboxed to 54 x 96 inside 96 x 96
    kw = dict(imgsz=96, conf=0.05, iou=0.7, max_det=50)
    want = np.asarray(jyolo.predict_batched(frames, **kw))
    got = pyolo.predict_batched(frames, **kw)
    _assert_same_detections(got, want, 256)
    jpred, ppred = jyolo._get_predictor(kw), pyolo._get_predictor(kw)
    for b in range(2):
        wr = jpred.postprocess(want[b:b + 1], f"f{b}", frames[b], {})
        gr = ppred.postprocess(got[b:b + 1], f"f{b}", frames[b], {})
        assert len(gr) == len(wr)
        np.testing.assert_allclose(gr.boxes.data, wr.boxes.data, rtol=0, atol=BOX_ATOL)
        np.testing.assert_allclose(gr.embeds, wr.embeds, rtol=0, atol=1e-3)
        np.testing.assert_array_equal(gr.person_states, wr.person_states)


def test_predict_batched_conf_none_serves_at_jax_default(jde_pair):
    """conf=None serves at 0.25, as the JAX package's predictor does."""
    jyolo, pyolo = jde_pair
    frames = _frames(2, 72, 128, seed=3)
    kw = dict(imgsz=96, iou=0.7, max_det=50)
    got = pyolo.predict_batched(frames, conf=None, **kw)
    np.testing.assert_array_equal(got, pyolo.predict_batched(frames, conf=0.25, **kw))
    want = np.asarray(jyolo.predict_batched(frames, conf=None, **kw))
    _assert_same_detections(got, want, 256)
    assert (got[..., 4] >= 0.25).sum() == (got[..., 4] > 0).sum()


def test_port_imports_no_jax():
    files = sorted((REPO / "sar_yolo_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tools" / "torch_port_profile.py",
        REPO / "tools" / "torch_port_phase8_reruns.py"]
    # nor the image, chart and table libraries the card's machine lacks (the port reads YAML
    # itself and draws its charts with utils/chart.py)
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "sklearn", "sar_yolo_tpu", "cv2", "PIL",
              "pandas", "yaml", "matplotlib", "seaborn"}
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            found += [(path.name, m) for m in mods if m.split(".")[0] in banned]
    names = {str(p.relative_to(REPO)) for p in files}
    assert {"sar_yolo_tpu_torch/data/loaders.py", "sar_yolo_tpu_torch/engine/predictor.py",
            "sar_yolo_tpu_torch/trackers/byte_tracker.py", "sar_yolo_tpu_torch/trackers/bot_sort.py",
            "sar_yolo_tpu_torch/trackers/matching.py", "sar_yolo_tpu_torch/utils/callbacks.py",
            "sar_yolo_tpu_torch/ops/slicing.py", "sar_yolo_tpu_torch/cfg/models.py",
            "sar_yolo_tpu_torch/__main__.py", "sar_yolo_tpu_torch/cfg/__init__.py",
            "sar_yolo_tpu_torch/utils/settings.py", "sar_yolo_tpu_torch/ops/tta.py",
            "sar_yolo_tpu_torch/utils/benchmarks.py", "sar_yolo_tpu_torch/utils/mfu.py",
            "sar_yolo_tpu_torch/engine/tuner.py", "sar_yolo_tpu_torch/utils/tuner.py",
            "sar_yolo_tpu_torch/utils/autobatch.py"} <= names
    assert len(files) > 30
    assert not found


def test_entry_point_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        YOLO("tinyjde.yaml")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        YOLO("tinyjde.yaml", device="cuda")
    assert YOLO("tinyjde.yaml", device="cpu").device.type == "cpu"
