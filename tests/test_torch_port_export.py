"""Export of the PyTorch port against the JAX package's (`YOLO.export`, `AutoBackend`).

Each model (tinydet, tinyjde, tinyseg, tinypose, tinyobb, tinycls and yolov13n-JDE at 64 px)
is built once per module with the same numpy-seeded weights in both packages
(`jax_and_port_yolo`) and exported once per format; the inputs are seeded uint8 RGB
batches, the artifacts' input.

(a) ONNX: the port's artifact (`export/onnx_export.py`), run by the port's numpy runtime and
    by the JAX package's `OnnxReferenceRuntime`, against the JAX exporter's raw serving graph
    (`Exporter._build_infer_fn(..., with_nms=False)`): atol 2e-3, rtol 1e-3, the tolerance of
    `tests/test_onnx.py`'s model-level tests. The JAX runtime raising on no op is the check
    that the artifact holds no op it does not know.
(b) pt2 against stablehlo: the port's `.pt2` program (raw, and with NMS at batch 1 and 3 from
    one `dynamic=True` artifact) against the JAX package's `.stablehlo` of the same weights,
    called with `jax.export.deserialize(...).call`: raw predictions at atol 2e-3, rtol 1e-3;
    detections the same rows (classes equal; boxes, scores, embeddings and keypoints within
    1e-3 of each column's largest magnitude, or of 1), a segment artifact's masks equal on
    the kept rows wherever the pixel's probability in float64 is 1e-4 or more from 0.5
    (chip_smoke's MASK_MARGIN). An artifact serves only on the device it was traced on.
(c) yolov13n-JDE's program holds exactly 8 `sar_yolo_tpu_torch::flash_area_attention` nodes.
(d) The round trip: `YOLO(path).predict(img)` of the pt2 and ONNX artifacts against
    `YOLO.predict`, to the tolerances of `tests/test_exports.py::_roundtrip`, on an image
    that both letterboxes only pad; each task's NMS artifact serves its Results.
(e) The sidecar equals the JAX package's for the same arguments, apart from `device`.
(f) Refusals: ONNX with nms=True, the TF formats, stablehlo, an artifact asked for another
    device than it was traced on, a model's other modes on an artifact.
(g) `AutoBackend` of a checkpoint folder serves the raw program of its model; the export
    modules import no JAX.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.export.onnx_runtime import OnnxReferenceRuntime as JaxRuntime
from sar_yolo_tpu_torch import YOLO
from sar_yolo_tpu_torch.export.onnx_runtime import OnnxReferenceRuntime
from sar_yolo_tpu_torch.nn.autobackend import AutoBackend
from sar_yolo_tpu_torch.utils.errors import ExportError
from torch_port_common import jax_and_port_yolo, one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
IMGSZ = 64
# numpy-seeded weights; gains and BN calibration keep scores apart and boxes near their
# anchors, so that NMS decides nothing by float32 rounding
PAIRS = {
    "tinydet.yaml": dict(seed=7, cls_gain=0.2, box_gain=0.1, calibrate=64),
    "tinyjde.yaml": dict(seed=3, box_gain=0.1, calibrate=64),
    "tinyseg.yaml": dict(seed=4, cls_gain=0.3, box_gain=0.1, calibrate=64),
    "tinypose.yaml": dict(seed=4, cls_gain=0.3, box_gain=0.1, calibrate=64),
    "tinyobb.yaml": dict(seed=4, cls_gain=0.3, box_gain=0.1, calibrate=64),
    "tinycls.yaml": dict(seed=3),
    "yolov13n-JDE.yaml": dict(seed=7, box_gain=0.1, calibrate=64),
}
MODELS = list(PAIRS)


@functools.cache
def _pair(name: str):
    kw = dict(PAIRS[name])
    return jax_and_port_yolo(name, kw.pop("seed"), **kw)


@functools.cache
def _exports(name: str, root: str) -> dict:
    """The port's pt2 (raw; NMS, dynamic batch) and ONNX artifacts and the JAX package's
    stablehlo (raw; NMS, dynamic batch) of `name`, each in a folder of its own."""
    jyolo, pyolo = _pair(name)
    out = {}
    for key, fmt, kw in (("pt2", "pt2", {}), ("pt2_nms", "pt2", dict(nms=True, dynamic=True)),
                         ("onnx", "onnx", {}),
                         ("stablehlo", "stablehlo", {}),
                         ("stablehlo_nms", "stablehlo", dict(nms=True, dynamic=True))):
        package = jyolo if fmt == "stablehlo" else pyolo
        out[key] = package.export(format=fmt, imgsz=IMGSZ, project=f"{root}/{key}", **kw)
    return out


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("exports"))


def _images(b: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (b, IMGSZ, IMGSZ, 3), np.uint8)


def _jax_raw(name: str, x: np.ndarray):
    """The JAX exporter's raw serving graph on x, as a list of numpy outputs."""
    from sar_yolo_tpu.cfg import get_cfg
    from sar_yolo_tpu.engine.exporter import Exporter
    jyolo, _ = _pair(name)
    args = get_cfg(overrides={"mode": "export", "format": "onnx", "imgsz": IMGSZ, "nms": False,
                              "task": jyolo.task})
    infer = Exporter(args)._build_infer_fn(jyolo.model, jyolo.variables, jyolo.meta,
                                           with_nms=False)
    out = jax.jit(infer)(jnp.asarray(x))
    return [np.asarray(o) for o in (out if isinstance(out, (tuple, list)) else [out])]


def _stablehlo(path: str, x: np.ndarray):
    out = jax.export.deserialize(Path(path).read_bytes()).call(x)
    return [np.asarray(o) for o in (out if isinstance(out, (tuple, list)) else [out])]


def _numpy(out):
    return [o.numpy() for o in (out if isinstance(out, tuple) else [out])]


@pytest.mark.parametrize("name", MODELS)
def test_onnx_matches_jax_raw_graph(name, root):
    x = _images(1, seed=1)
    want = _jax_raw(name, x)
    path = _exports(name, root)["onnx"]
    for runtime in (OnnxReferenceRuntime, JaxRuntime):
        got = runtime(path)(x)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_allclose(g, w, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("name", MODELS)
def test_pt2_raw_matches_stablehlo(name, root):
    paths = _exports(name, root)
    x = _images(1, seed=2)
    got = _numpy(AutoBackend(paths["pt2"], device="cpu")(x))
    want = _stablehlo(paths["stablehlo"], x)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=2e-3, rtol=1e-3)


def _same_rows(got, want, task: str):
    """The same kept rows (score > 0) in the same order: classes equal, every other column
    (box, score, embedding, states, keypoints, angle) within 1e-3 of its largest magnitude
    over the kept rows, or of 1 where that is smaller: these seeded weights give boxes of
    hundreds of pixels and embeddings of up to ~1e3, which the two frameworks round ~1e-5 of
    their size apart."""
    score, cls = (5, 6) if task == "obb" else (4, 5)
    for g, w in zip(got, want):
        keep = w[:, score] > 0
        assert np.array_equal(g[:, score] > 0, keep) and keep.any()
        g, w = g[keep], w[keep]
        np.testing.assert_array_equal(g[:, cls], w[:, cls])
        g, w = np.delete(g, cls, 1), np.delete(w, cls, 1)
        tol = 1e-3 * np.maximum(1.0, np.abs(w).max(0))
        assert (np.abs(g - w) <= tol).all(), np.abs(g - w).max(0) / tol


@pytest.mark.parametrize("name", [m for m in MODELS if m != "tinycls.yaml"])
def test_pt2_nms_matches_stablehlo_at_batch_1_and_3(name, root):
    _, pyolo = _pair(name)
    paths = _exports(name, root)
    backend = AutoBackend(paths["pt2_nms"], device="cpu")
    assert backend.with_nms and backend.meta["input_shape"][0] is None
    task = pyolo.task
    for b in (1, 3):
        x = _images(b, seed=3)
        got = _numpy(backend(x))
        want = _stablehlo(paths["stablehlo_nms"], x)
        assert [g.shape for g in got] == [w.shape for w in want]
        _same_rows(got[0], want[0], task)
        if task == "segment":  # the kept rows' masks, where float32 rounding decides nothing
            sel = (want[0][..., 4] > 0)[..., None, None] & _decided_mask_pixels(pyolo, x)
            assert sel.sum() > 0.99 * (want[0][..., 4] > 0).sum() * np.prod(want[1].shape[2:])
            np.testing.assert_array_equal(got[1][sel], want[1][sel])


def _decided_mask_pixels(pyolo, x):
    """Mask pixels whose probability in float64 (the port's raw program, its NMS rows'
    coefficients and prototypes) lies 1e-4 or more from 0.5, as chip_smoke's MASK_MARGIN."""
    from sar_yolo_tpu_torch.engine.exporter import ServingProgram
    from sar_yolo_tpu_torch.ops.nms import non_max_suppression
    program = ServingProgram(pyolo._fused_for_serving(), pyolo.meta, "segment", False, 0.7, 300)
    with torch.no_grad():
        preds, protos = program.eval()(torch.from_numpy(x))
        dets = non_max_suppression(preds, 0.25, 0.7, 300, nc=pyolo.meta["nc"])
        prob = torch.einsum("bnc,bhwc->bnhw", dets[..., 6:].double(), protos.double()).sigmoid()
    return (prob - 0.5).abs().numpy() >= 1e-4


def test_yolov13_program_holds_the_area_attention_op(root):
    ep = torch.export.load(_exports("yolov13n-JDE.yaml", root)["pt2_nms"])
    op = torch.ops.sar_yolo_tpu_torch.flash_area_attention.default
    assert sum(n.target is op for n in ep.graph.nodes) == 8
    assert not any(n.target is torch.ops.aten.einsum.default and "attn" in str(n.meta.get(
        "nn_module_stack", "")) for n in ep.graph.nodes)


def test_program_holds_no_identity_casts(root):
    """The layers, decode and NMS cast only a tensor of another dtype, so that the program
    holds no identity cast (each is two host-dispatched nodes a call)."""
    ep = torch.export.load(_exports("yolov13n-JDE.yaml", root)["pt2_nms"])
    casts = [n for n in ep.graph.nodes if n.target is torch.ops.aten.to.dtype]
    assert casts  # the uint8 input's cast, at least
    assert all(n.args[0].meta["val"].dtype != n.args[1] for n in casts)


def _roundtrip_image():
    """`tests/test_exports.py`'s 72x96 image, resized on the host to 48x64, the size its
    letterbox at 64 gives it: both letterboxes then only pad. (The artifact's host letterbox
    rounds a resized frame to uint8 where `YOLO.predict`'s keeps float32 on the device, a
    difference these seeded weights turn into different rows.)"""
    from sar_yolo_tpu_torch.data import cv
    img = np.full((72, 96, 3), 30, np.uint8)
    img[20:50, 30:70] = (210, 60, 40)
    return cv.resize(img, (64, 48))


@pytest.mark.parametrize("key", ["pt2", "onnx"])
def test_artifact_predict_round_trip(key, root):
    """`YOLO(path).predict` (host letterbox, NMS in the port) reproduces `YOLO.predict`."""
    _, pyolo = _pair("tinydet.yaml")
    img = _roundtrip_image()
    ref = pyolo.predict(img, imgsz=IMGSZ, conf=0.01)[0].boxes.data[:, :6]
    artifact = YOLO(_exports("tinydet.yaml", root)[key], device="cpu")
    assert artifact.backend is not None and artifact.task == "detect"
    got = artifact.predict(img, conf=0.01)[0].boxes.data[:, :6]
    assert got.shape[0] == ref.shape[0] > 0
    a, b = ref[np.argsort(-ref[:, 4])], got[np.argsort(-got[:, 4])]
    np.testing.assert_allclose(a[:, :4], b[:, :4], atol=1.5)
    np.testing.assert_allclose(a[:, 4], b[:, 4], atol=5e-3)
    np.testing.assert_array_equal(a[:, 5], b[:, 5])


@pytest.mark.parametrize("name", ["tinyjde.yaml", "tinyseg.yaml", "tinypose.yaml",
                                  "tinyobb.yaml", "tinycls.yaml"])
def test_artifact_predict_serves_each_task(name, root):
    """The NMS artifact's Results carry what the native predictor's do (JDE embeddings and
    states, keypoints, masks, rotated rows, probabilities), to the round trip's tolerances."""
    _, pyolo = _pair(name)
    img = _images(1, seed=4)[0]
    want = pyolo.predict(img, imgsz=IMGSZ, conf=0.25)[0]
    got = YOLO(_exports(name, root)["pt2_nms" if name != "tinycls.yaml" else "pt2"],
               device="cpu").predict(img, conf=0.25)[0]
    if name == "tinycls.yaml":
        np.testing.assert_allclose(got.probs.data, want.probs.data, atol=5e-3)
        return
    rows = (lambda r: r.obb.data) if name == "tinyobb.yaml" else (lambda r: r.boxes.data)
    assert len(rows(got)) == len(rows(want)) > 0
    np.testing.assert_allclose(rows(got), rows(want), atol=1.5)
    if name == "tinyjde.yaml":
        np.testing.assert_allclose(got.embeds, want.embeds, atol=1e-3)
        np.testing.assert_array_equal(got.person_states, want.person_states)
    if name == "tinypose.yaml":
        np.testing.assert_allclose(got.keypoints.data, want.keypoints.data, atol=1.5)
    if name == "tinyseg.yaml":
        assert got.masks.data.shape == want.masks.data.shape


@pytest.mark.parametrize("nms,dynamic", [(False, False), (True, True)])
def test_sidecar_equals_jax(nms, dynamic, root, tmp_path):
    jyolo, pyolo = _pair("tinyjde.yaml")
    want = json.loads(Path(jyolo.export(format="stablehlo", imgsz=IMGSZ, nms=nms,
                                        dynamic=dynamic, project=str(tmp_path / "j")) +
                           ".json").read_text())
    got = json.loads(Path(pyolo.export(format="pt2", imgsz=IMGSZ, nms=nms, dynamic=dynamic,
                                       project=str(tmp_path / "p")) + ".json").read_text())
    assert got.pop("device") == "cpu"
    assert got == want


def test_refusals(root, tmp_path):
    _, pyolo = _pair("tinydet.yaml")
    with pytest.raises(ExportError, match="nms=False"):
        pyolo.export(format="onnx", imgsz=IMGSZ, nms=True, project=str(tmp_path))
    for fmt in ("saved_model", "tflite", "pb"):
        with pytest.raises(NotImplementedError, match="jax2tf"):
            pyolo.export(format=fmt, imgsz=IMGSZ, project=str(tmp_path))
    with pytest.raises(ValueError, match="pt2"):
        pyolo.export(format="stablehlo", imgsz=IMGSZ, project=str(tmp_path))
    with pytest.raises(NotImplementedError, match="int8"):
        pyolo.export(format="pt2", imgsz=IMGSZ, int8=True, project=str(tmp_path))
    # export keys of the JAX package that the port does not read raise unless at the default
    for key, value in (("keras", True), ("optimize", True), ("simplify", False),
                       ("workspace", 4.0)):
        with pytest.raises(NotImplementedError, match=key):
            pyolo.export(imgsz=IMGSZ, project=str(tmp_path), **{key: value})
    # a program traced on one device serves there only
    path = _exports("tinydet.yaml", root)["pt2"]
    side = json.loads(Path(f"{path}.json").read_text())
    moved = tmp_path / "moved.pt2"
    moved.write_bytes(Path(path).read_bytes())
    Path(f"{moved}.json").write_text(json.dumps({**side, "device": "cuda:0"}))
    with pytest.raises(ValueError, match="traced on cuda:0"):
        AutoBackend(moved, device="cpu")
    artifact = YOLO(path, device="cpu")
    for call in (lambda: artifact.train(data="synthetic"), lambda: artifact.val(),
                 lambda: artifact.export(), lambda: artifact.predict_batched(_images(1))):
        with pytest.raises(NotImplementedError, match="exported artifact"):
            call()
    with pytest.raises(NotImplementedError, match="imgsz"):
        artifact.predict(_roundtrip_image(), imgsz=96)


def test_export_defaults_to_pt2(tmp_path):
    _, pyolo = _pair("tinydet.yaml")
    path = pyolo.export(imgsz=IMGSZ, keras=False, simplify=True, project=str(tmp_path))
    assert path.endswith(".pt2") and Path(path).is_file()


def test_autobackend_serves_a_checkpoint_raw(root, tmp_path):
    """`AutoBackend(<checkpoint folder>)`: the native path, the raw serving program of the
    checkpoint's BN-folded model, equal to the raw pt2 artifact of the same weights."""
    _, pyolo = _pair("tinyjde.yaml")
    backend = AutoBackend(pyolo.save(str(tmp_path / "ckpt")), device="cpu")
    assert backend.kind == "native" and not backend.with_nms and backend.meta["task"] == "jde"
    x = _images(1, seed=5)
    want = AutoBackend(_exports("tinyjde.yaml", root)["pt2"], device="cpu")(x)
    torch.testing.assert_close(backend(x), want, rtol=0, atol=0)


def test_export_modules_import_no_jax():
    """The new export modules fall under the port's AST rule (no JAX, no JAX package)."""
    import ast
    files = sorted((REPO / "sar_yolo_tpu_torch" / "export").glob("*.py")) + [
        REPO / "sar_yolo_tpu_torch" / "engine" / "exporter.py",
        REPO / "sar_yolo_tpu_torch" / "nn" / "autobackend.py"]
    assert len(files) == 6
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            mods = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            assert not [m for m in mods if m.split(".")[0] in ("jax", "sar_yolo_tpu")], path
