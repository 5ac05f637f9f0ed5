"""`YOLO.predict` of the PyTorch port against the JAX package's, on the CPU.

The same numpy-filled weights (`fill_variables`, with the head's bias init on tinyjde so
that scores spread) serve JPEG frames of four shapes through both packages. Every
source kind (a folder, a glob, a list of paths, a uint8 array, a torch and a numpy NCHW
float tensor) gives the same paths and the same kept rows: classes and posture states
equal, boxes within 1e-4 px, scores and embeddings within 1e-4. Also `summary()`,
`verbose()` and the `save_txt` files (numbers within the same tolerance plus one printed
digit), the callbacks in JAX's order, `stream=True` lazily, yolov13n-JDE at 96 px, and
the labels folder once a call, `save_dir` and absolute globs (where JAX differs).
The repair: a checkpoint trained at a non-default imgsz, iou and max_det serves with them,
as the JAX package serves it (the port served every checkpoint at 640).
"""

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from sar_yolo_tpu.engine.model import YOLO as JaxYOLO
from sar_yolo_tpu_torch import YOLO
from sar_yolo_tpu_torch.data.imageio import encode_jpeg
from torch_port_common import (convert_jax_checkpoint, jax_and_port_yolo,  # noqa: F401
                               one_torch_thread, write_jax_checkpoint)

TOL = 1e-4  # px for boxes; absolute for scores and embeddings
SHAPES = [(72, 128), (96, 64), (64, 64), (50, 90)]


@pytest.fixture(scope="module")
def tiny():
    return jax_and_port_yolo("tinyjde.yaml", 3, bias_init=True)


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """Four JPEG frames (4:2:0, quality 90) of smooth colour cells in a folder."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(SHAPES):
        cells = rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8)
        img = cv2.resize(cells, (w, h), interpolation=cv2.INTER_NEAREST)
        cv2.imwrite(str(root / f"f{i}.jpg"), img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    return root


def assert_same_results(got: list, want: list, n_emb: int):
    assert len(got) == len(want) > 0
    kept = 0
    for g, w in zip(got, want):
        assert str(g.path) == str(w.path) and g.orig_shape == w.orig_shape
        assert len(g) == len(w)
        kept += len(w)
        gb, wb = g.boxes.data, w.boxes.data
        np.testing.assert_array_equal(gb[:, 5], wb[:, 5])
        np.testing.assert_allclose(gb[:, :5], wb[:, :5], rtol=0, atol=TOL)
        np.testing.assert_allclose(g.embeds, w.embeds, rtol=0, atol=TOL)
        assert g.embeds.shape == (len(w), n_emb)
        np.testing.assert_array_equal(g.person_states, w.person_states)
        assert g.frame == w.frame and set(g.speed) == set(w.speed)
    assert kept > 0


SOURCES = ["folder", "glob", "paths", "array", "torch_tensor", "numpy_tensor"]


def _sources(kind: str, frames_dir: Path):
    """(port source, JAX source) of one kind; the tensors hold RGB floats in [0, 1]."""
    files = sorted(frames_dir.glob("*.jpg"))
    if kind == "folder":
        return str(frames_dir), str(frames_dir)
    if kind == "glob":
        pattern = f"{frames_dir.name}/f*.jpg"  # relative: JAX's Path().glob takes no other
        return pattern, pattern
    if kind == "paths":
        return [str(f) for f in files[::-1]], [str(f) for f in files[::-1]]
    img = cv2.imread(str(files[0]))
    if kind == "array":
        return img, img
    batch = np.stack([cv2.resize(cv2.imread(str(f)), (64, 48)) for f in files])
    nchw = np.ascontiguousarray(batch[..., ::-1].transpose(0, 3, 1, 2)).astype(np.float32) / 255
    return (torch.from_numpy(nchw) if kind == "torch_tensor" else nchw), nchw


@pytest.mark.parametrize("kind", SOURCES)
def test_predict_sources_match_jax(kind, tiny, frames_dir, monkeypatch):
    jyolo, pyolo = tiny
    monkeypatch.chdir(frames_dir.parent)
    got_src, want_src = _sources(kind, frames_dir)
    kw = dict(imgsz=64, conf=0.01, max_det=40)
    want = jyolo.predict(want_src, **kw)
    got = pyolo.predict(got_src, **kw)
    assert_same_results(got, want, 32)
    if kind in ("folder", "glob"):
        assert [Path(r.path).name for r in got] == ["f0.jpg", "f1.jpg", "f2.jpg", "f3.jpg"]


def test_summary_verbose_and_save_txt_match_jax(tiny, frames_dir, tmp_path):
    jyolo, pyolo = tiny
    kw = dict(imgsz=64, conf=0.01, max_det=40, save_txt=True, name="p", exist_ok=True)
    want = jyolo.predict(str(frames_dir), project=str(tmp_path / "jax"), **kw)
    got = pyolo.predict(str(frames_dir), project=str(tmp_path / "port"), **kw)
    for g, w in zip(got, want):
        assert g.verbose() == w.verbose() and g.verbose() != "(no detections)"
        gs, ws = g.summary(normalize=True), w.summary(normalize=True)
        assert len(gs) == len(ws)
        for a, b in zip(gs, ws):
            assert {k: a[k] for k in ("name", "class", "person_state")} == \
                {k: b[k] for k in ("name", "class", "person_state")}
            np.testing.assert_allclose(a["confidence"], b["confidence"], rtol=0, atol=TOL)
            np.testing.assert_allclose(list(a["box"].values()), list(b["box"].values()), rtol=0,
                                       atol=TOL)
        assert g.to_json() == g.tojson() and len(g.to_json()) > 2
        empty = g.new()
        assert len(empty) == 0 and empty.path == g.path and empty.names == g.names
        assert len(empty.update(boxes=g.boxes.data[:1])) == 1 and empty.boxes.orig_shape == g.orig_shape
    jax_txt = sorted((tmp_path / "jax" / "jde" / "p" / "labels").glob("*.txt"))
    port_txt = sorted((tmp_path / "port" / "jde" / "p" / "labels").glob("*.txt"))
    assert [p.name for p in port_txt] == [p.name for p in jax_txt] == \
        ["f0.txt", "f1.txt", "f2.txt", "f3.txt"]
    for p, j in zip(port_txt, jax_txt):
        a = np.loadtxt(p, ndmin=2)
        b = np.loadtxt(j, ndmin=2)
        assert a.shape == b.shape and len(a) > 0
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(a[:, 1:5], b[:, 1:5], rtol=0, atol=TOL / 50 + 1e-6)
        np.testing.assert_allclose(a[:, 5], b[:, 5], rtol=0, atol=TOL + 1e-4)


def test_save_dir_once_a_call_and_absolute_globs(tiny, frames_dir, tmp_path):
    """Where the port parts from the JAX package on purpose (ROADMAP Queue C): the labels
    of one call share one folder (JAX numbers a new one for every frame unless
    `exist_ok`), a given `save_dir` is used, and an absolute glob is read."""
    _, pyolo = tiny
    kw = dict(imgsz=64, conf=0.01, save_txt=True)
    pyolo.predict(str(frames_dir), project=str(tmp_path / "p"), **kw)
    assert sorted(str(f.relative_to(tmp_path)) for f in tmp_path.rglob("*.txt")) == \
        [f"p/jde/jde/labels/f{i}.txt" for i in range(len(SHAPES))]
    pyolo.predict(str(frames_dir / "f0.jpg"), save_dir=str(tmp_path / "mine"), **kw)
    assert (tmp_path / "mine" / "labels" / "f0.txt").is_file()
    got = pyolo.predict(str(frames_dir / "f*.jpg"), imgsz=64, conf=0.01)
    assert [Path(r.path).name for r in got] == [f"f{i}.jpg" for i in range(len(SHAPES))]


def test_callbacks_fire_in_jax_order_and_stream_is_lazy(frames_dir):
    jyolo, pyolo = jax_and_port_yolo("tinyjde.yaml", 3, bias_init=True)
    logs = {}
    for label, yolo in (("jax", jyolo), ("port", pyolo)):
        log = logs[label] = []
        for event in ("on_predict_start", "on_predict_batch_start",
                      "on_predict_postprocess_end", "on_predict_end"):
            yolo.add_callback(event, lambda pred, e=event, log=log:
                              log.append((e, None if pred.batch is None else Path(pred.batch[0]).name,
                                          None if pred.results is None or e != "on_predict_postprocess_end"
                                          else len(pred.results[0]))))
    kw = dict(imgsz=64, conf=0.02)
    jyolo.predict(str(frames_dir), **kw)
    gen = pyolo.predict(str(frames_dir), stream=True, **kw)
    assert not logs["port"]  # nothing runs before the first result is asked for
    first = next(gen)
    assert [e for e, _, _ in logs["port"]] == ["on_predict_start", "on_predict_batch_start",
                                              "on_predict_postprocess_end"]
    assert Path(first.path).name == "f0.jpg"
    rest = list(gen)
    assert len(rest) == 3
    assert logs["port"] == logs["jax"]
    assert logs["port"][-1][0] == "on_predict_end" and len(logs["port"]) == 2 + 2 * len(SHAPES)


def test_yolov13n_predict_matches_jax(frames_dir):
    """conf 0.49 lies in a wide gap of this model's scores (0.477 to 0.509): under it, tens
    of rows tie within 1e-5 and NMS picks among them by float32 rounding."""
    jyolo, pyolo = jax_and_port_yolo("yolov13n-JDE.yaml", 7)
    kw = dict(imgsz=96, conf=0.49, max_det=50)
    want = jyolo.predict(str(frames_dir), **kw)
    scores = np.concatenate([np.asarray(jyolo.predict(str(frames_dir), **{**kw, "conf": 0.4})[i]
                                        .boxes.conf) for i in range(len(SHAPES))])
    assert np.abs(scores - kw["conf"]).min() > 1e-3
    got = pyolo.predict(str(frames_dir), **kw)
    assert_same_results(got, want, 256)


def test_unported_options_and_sources_raise(tiny, frames_dir, tmp_path):
    """Sources and the pandas tables that are not ported raise; save=True writes each
    frame's plot() (`test_torch_port_annotate.py` holds the files to JAX's)."""
    _, pyolo = tiny
    res = pyolo.predict(str(frames_dir), imgsz=64, save=True, project=str(tmp_path / "runs"))
    out = tmp_path / "runs" / "jde" / "jde"
    assert sorted(p.name for p in out.iterdir()) == [f"f{i}.jpg" for i in range(len(SHAPES))]
    for r in res:
        assert (out / Path(str(r.path)).name).read_bytes() == encode_jpeg(r.plot())
    with pytest.raises(TypeError, match="unsupported predict arguments"):
        pyolo.predict(str(frames_dir), imgsz=64, visualize=True)
    (tmp_path / "clip.mp4").write_bytes(b"\0" * 16)
    for source in (str(tmp_path / "clip.mp4"), "rtsp://localhost/cam", "screen 0", "0"):
        with pytest.raises(NotImplementedError, match="not part of this port"):
            pyolo.predict(source, imgsz=64)
    res = pyolo.predict(str(frames_dir / "f0.jpg"), imgsz=64)[0]
    for method in ("to_df", "to_csv", "to_xml"):
        with pytest.raises(NotImplementedError, match=f"Results.{method}"):
            getattr(res, method)()
    assert res.save(tmp_path / "plot.png") == tmp_path / "plot.png"
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "plot.png")), res.plot())
    res.save_crop(tmp_path / "crops")
    assert len(list((tmp_path / "crops").rglob("f0_*.jpg"))) == \
        sum(int(b[2]) > int(b[0]) and int(b[3]) > int(b[1]) for b in res.boxes.data)


def test_checkpoint_serves_with_its_train_args(frames_dir, tmp_path):
    """The repair: a checkpoint trained at imgsz 96 with iou 0.5 and max_det 7 serves with
    them, as `YOLO(ckpt)` of the JAX package does (`engine/model.py:93-97, 219-224`)."""
    write_jax_checkpoint(tmp_path / "jax_ckpt", {"imgsz": 96, "iou": 0.5, "max_det": 7,
                                                 "epochs": 3})
    convert_jax_checkpoint(tmp_path / "jax_ckpt", tmp_path / "port_ckpt")
    jyolo = JaxYOLO(str(tmp_path / "jax_ckpt"))
    pyolo = YOLO(str(tmp_path / "port_ckpt"), device="cpu")
    frames = np.stack([cv2.resize(cv2.imread(str(f)), (128, 72))
                       for f in sorted(frames_dir.glob("*.jpg"))])
    want = np.asarray(jyolo.predict_batched(frames, conf=0.003))
    got = pyolo.predict_batched(frames, conf=0.003)
    assert got.shape == want.shape == (len(frames), 7, 6 + 32 + 6)
    assert ((got[..., 4] > 0).sum(1) > 0).all()
    for b in range(len(frames)):
        np.testing.assert_array_equal(got[b, :, 5], want[b, :, 5])
        np.testing.assert_allclose(got[b, :, :5], want[b, :, :5], rtol=0, atol=TOL)
        np.testing.assert_allclose(got[b, :, 6:], want[b, :, 6:], rtol=0, atol=TOL)
    # conf 0.003: above two rows 4e-8 apart, whose order float32 rounding decides
    assert_same_results(pyolo.predict(str(frames_dir), conf=0.003),
                        jyolo.predict(str(frames_dir), conf=0.003), 32)
