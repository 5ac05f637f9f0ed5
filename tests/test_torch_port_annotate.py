"""Annotated output of the PyTorch port against the JAX package, on the CPU.

While the two packages are compared, the label text is recorded instead of drawn on both
sides (`cv2.putText` for JAX, `data/cv.py::put_text` for the port): OpenCV 5.0 draws
putText as antialiased TrueType, the port OpenCV 4.x's Hershey strokes, which
`test_torch_port_draw.py` holds to OpenCV 4.13's renderings. The recorded calls (text,
origin, scale, colour, thickness) must be equal, and everything else bit for bit.

(a) `Results.plot` of the same rows in both packages: boxes over the image's edges and of
    zero area, track ids and posture states, masks at the prototypes' and at the frame's
    resolution, keypoints with and without confidences, rotated boxes, probabilities,
    1080p frames (line width 3, text thickness 2), `line_width` and `font_scale`.
(b) `save` (JPEG bytes equal, PNG pixels) and `save_crop` (the same files, bytes equal).
(c) `YOLO.predict(save=True)` of JPEG frames: JAX's files byte for byte, `save_txt` in the
    same folder; `YOLO.track(save=True)` of an AVI: the plotted frames equal JAX's, the
    port's AVI holds their JPEG encodes, and both files have the same frame count, fps and
    size, their decoded frames within MJPEG_MEAN_ABS of each other (FFmpeg's mjpeg encoder
    writes JAX's frames, libjpeg-turbo's quality 95 the port's).
(d) `Masks.xy` / `xyn` of a segment model's masks equal JAX's.
(e) `auto_annotate`: the label files of JAX's, with the detector and SAM of the same weights.
(f) The command line's `save=True` for predict and track; `save=True` with an exported
    artifact writes nothing, as JAX's artifact predictor.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest

import sar_yolo_tpu.engine.model as jax_model_module
import sar_yolo_tpu.models.sam as jax_sam_module
import sar_yolo_tpu_torch.engine.predictor as port_predictor
from sar_yolo_tpu.engine.results import Masks as JaxMasks
from sar_yolo_tpu.engine.results import Results as JaxResults
from sar_yolo_tpu.trackers.byte_tracker import STrack as JaxSTrack
from sar_yolo_tpu_torch import cfg as port_cfg
from sar_yolo_tpu_torch.data import cv as port_cv
from sar_yolo_tpu_torch.data.annotator import auto_annotate
from sar_yolo_tpu_torch.data.avi import AviReader, AviWriter
from sar_yolo_tpu_torch.data.imageio import encode_jpeg
from sar_yolo_tpu_torch.engine.results import Results
from sar_yolo_tpu_torch.trackers.byte_tracker import STrack
from torch_port_common import jax_and_port_yolo, one_torch_thread  # noqa: F401

TOL = 1e-4            # px for boxes, as the predict tests
MJPEG_MEAN_ABS = 8.0  # grey levels: FFmpeg's mjpeg against libjpeg-turbo's quality 95
NAMES = {0: "person", 1: "car"}
SHAPES = [(72, 128), (96, 64), (64, 64), (50, 90)]


@pytest.fixture
def text_calls(monkeypatch):
    """Each package's label calls, recorded and not drawn."""
    calls = {"jax": [], "port": []}

    def jax_put(img, text, org, font, scale, color, thickness=1, *args):
        assert font == cv2.FONT_HERSHEY_SIMPLEX and not args
        calls["jax"].append((text, tuple(org), scale, tuple(color), thickness))
        return img

    def port_put(img, text, org, font_scale, color, thickness=1):
        calls["port"].append((text, tuple(org), font_scale, tuple(color), thickness))
        return img
    monkeypatch.setattr(cv2, "putText", jax_put)
    monkeypatch.setattr(port_cv, "put_text", port_put)
    return calls


def _natural(h, w, seed=0):
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 256, (max(h // 8, 1), max(w // 8, 1), 3), dtype=np.uint8)
    return cv2.resize(cells, (w, h), interpolation=cv2.INTER_NEAREST)


def _rows(h, w, n, seed):
    """n rows [x1, y1, x2, y2, conf, cls] around and over the frame, one of zero area."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.1, 1.1, (n, 2)) * [w, h]
    wh = rng.uniform(0, 0.5, (n, 2)) * [w, h]
    rows = np.concatenate([xy, xy + wh, rng.uniform(0.2, 1, (n, 1)),
                           rng.integers(0, 3, (n, 1))], 1).astype(np.float32)
    rows[0, :4] = [-0.5, -0.5, w * 0.3, h * 0.4]  # int() truncates toward zero: drawn at 0
    rows[1, 2:4] = rows[1, :2]                    # zero area
    return rows


def _plot_case(name):
    """(image, Results kwargs, plot kwargs)."""
    h, w = (1080, 1920) if name == "hd" else (48, 64) if name != "frame_720p" else (720, 1280)
    img = _natural(h, w, seed=len(name))
    rng = np.random.default_rng(len(name))
    rows = _rows(h, w, 6, seed=len(name))
    kw, pk = {"boxes": rows}, {}
    if name == "tracked":
        kw["boxes"] = np.concatenate([rows, np.arange(3, 9, dtype=np.float32)[:, None]], 1)
        kw["person_states"] = rng.integers(0, 4, len(rows))
        kw["embeds"] = rng.standard_normal((len(rows), 8)).astype(np.float32)
    elif name in ("masks_low", "masks_full"):
        side = (16, 16) if name == "masks_low" else (h, w)
        kw["masks"] = rng.random((4, *side)) < 0.3
        kw["boxes"] = rows[:4]
    elif name in ("keypoints", "keypoints_xy"):
        k = np.concatenate([rng.uniform(-5, 70, (3, 5, 2)), rng.random((3, 5, 1))], -1)
        kw["keypoints"] = (k if name == "keypoints" else k[..., :2]).astype(np.float32)
        kw["boxes"] = rows[:3]
    elif name == "obb":
        kw = {"obb": np.concatenate([rng.uniform(0, 60, (3, 2)), rng.uniform(2, 30, (3, 2)),
                                     rng.uniform(-1.5, 1.5, (3, 1)), rng.random((3, 1)),
                                     rng.integers(0, 2, (3, 1))], 1).astype(np.float32)}
    elif name == "probs":
        kw = {"probs": rng.dirichlet(np.ones(3)).astype(np.float32)}
    elif name == "thin_large_text":
        pk = {"line_width": 1, "font_scale": 0.8}
    elif name == "thick":
        pk = {"line_width": 4}
    return img, kw, pk


PLOT_CASES = ["boxes", "tracked", "masks_low", "masks_full", "keypoints", "keypoints_xy",
              "obb", "probs", "frame_720p", "hd", "thin_large_text", "thick", "empty"]


def _pair(img, kw):
    return JaxResults(img.copy(), "f.jpg", NAMES, **kw), Results(img.copy(), "f.jpg", NAMES, **kw)


# ---- (a) Results.plot -------------------------------------------------------------------------

@pytest.mark.parametrize("name", PLOT_CASES)
def test_plot_matches_jax(name, text_calls):
    img, kw, pk = _plot_case(name)
    if name == "empty":
        kw = {"boxes": np.zeros((0, 6), np.float32)}
    jr, pr = _pair(img, kw)
    want, got = jr.plot(**pk), pr.plot(**pk)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, want)
    assert text_calls["port"] == text_calls["jax"]
    n_labels = len(kw.get("boxes", ())) + ("probs" in kw)
    assert len(text_calls["port"]) == n_labels
    if name not in ("empty", "probs"):  # probs: only a label
        assert (got != img).any()
    np.testing.assert_array_equal(pr.orig_img, img)  # drawn on a copy


def test_plot_draws_the_hershey_labels(monkeypatch):
    """Unrecorded, the labels are the port's put_text strokes, drawn after each box."""
    img, kw, _ = _plot_case("tracked")
    got = Results(img.copy(), "f.jpg", NAMES, **kw).plot()
    calls, draw = [], port_cv.put_text
    monkeypatch.setattr(port_cv, "put_text", lambda im, *a: calls.append(a) or draw(im, *a))
    np.testing.assert_array_equal(Results(img.copy(), "f.jpg", NAMES, **kw).plot(), got)
    assert [c[0] for c in calls] == [f"id:{k} {NAMES.get(int(r[5]), int(r[5]))} {r[4]:.2f} s{s}"
                                     for k, r, s in zip(range(3, 9), kw["boxes"],
                                                        kw["person_states"])]
    monkeypatch.setattr(port_cv, "put_text", lambda im, *a: im)
    assert (Results(img.copy(), "f.jpg", NAMES, **kw).plot() != got).any()


# ---- (b) save and save_crop -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["boxes", "hd", "masks_low"])
def test_save_and_save_crop_match_jax(name, text_calls, tmp_path):
    img, kw, _ = _plot_case(name)
    jr, pr = _pair(img, kw)
    for ext in (".jpg", ".png"):
        assert jr.save(tmp_path / "jax" / f"a{ext}") == tmp_path / "jax" / f"a{ext}"
        assert pr.save(tmp_path / "port" / f"a{ext}") == tmp_path / "port" / f"a{ext}"
    assert (tmp_path / "port/a.jpg").read_bytes() == (tmp_path / "jax/a.jpg").read_bytes()
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port/a.png")),
                                  cv2.imread(str(tmp_path / "jax/a.png")))
    jr.save_crop(tmp_path / "jax_crops", "s")
    pr.save_crop(tmp_path / "port_crops", "s")
    want = sorted(p.relative_to(tmp_path / "jax_crops")
                  for p in (tmp_path / "jax_crops").rglob("*.jpg"))
    got = sorted(p.relative_to(tmp_path / "port_crops")
                 for p in (tmp_path / "port_crops").rglob("*.jpg"))
    assert got == want and len(got) >= 2  # the zero-area box is skipped
    for rel in got:
        assert (tmp_path / "port_crops" / rel).read_bytes() == \
            (tmp_path / "jax_crops" / rel).read_bytes()
    assert {p.parts[0] for p in got} <= {"person", "car", "2"}


def test_save_refuses_other_formats(tmp_path):
    img, kw, _ = _plot_case("boxes")
    with pytest.raises(NotImplementedError, match=".bmp"):
        Results(img, "f.jpg", NAMES, **kw).save(tmp_path / "a.bmp")


# ---- (c) predict and track with save=True -----------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """tinyjde pairs whose boxes sit inside the frames: the box logits' kernels scaled by
    0.05 and their biases falling 0.9 a distance bin, so the distances stay near 1 stride."""
    jyolo, pyolo = jax_and_port_yolo("tinyjde.yaml", 3, cls_gain=40.0)
    params = jyolo.variables["params"]
    head = params[max(params, key=lambda k: int(k.split("_")[1]))]
    for name, sub in head.items():
        if name.startswith("cv2_") and name.endswith("_pred"):
            sub["kernel"] = sub["kernel"] * np.float32(0.05)
            bins = sub["bias"].shape[0] // 4
            sub["bias"] = np.tile(-0.9 * np.arange(bins, dtype=np.float32), 4)
    pyolo.load_jax_variables(jyolo.variables)
    return jyolo, pyolo


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    for i, (h, w) in enumerate(SHAPES):
        cv2.imwrite(str(root / f"f{i}.jpg"), _natural(h, w, seed=i), [cv2.IMWRITE_JPEG_QUALITY, 90])
    return root


def _same_ints(g, w) -> bool:
    """The rows of two results agree within TOL, and plot() truncates and labels them alike
    (a coordinate within TOL of an integer may not)."""
    gb, wb = g.boxes.data, np.asarray(w.boxes.data)
    assert gb.shape == wb.shape
    np.testing.assert_allclose(gb[:, :5], wb[:, :5], rtol=0, atol=TOL)
    np.testing.assert_array_equal(gb[:, 5:], wb[:, 5:])
    return (np.array_equal(gb[:, :4].astype(int), wb[:, :4].astype(int))
            and [f"{c:.2f}" for c in gb[:, 4]] == [f"{c:.2f}" for c in wb[:, 4]])


def _jax_plot(g):
    """JAX's Results.plot of the port's rows."""
    return JaxResults(g.orig_img, g.path, g.names, boxes=g.boxes.data, embeds=g.embeds,
                      person_states=g.person_states).plot()


def test_predict_save_matches_jax(tiny, frames_dir, tmp_path, text_calls):
    jyolo, pyolo = tiny
    jyolo._predictor_cache = pyolo._predictor_cache = None
    kw = dict(imgsz=64, conf=0.3, max_det=8, save=True, name="pred", exist_ok=True)
    want = jyolo.predict(str(frames_dir), project=str(tmp_path / "jax"), **kw)
    got = pyolo.predict(str(frames_dir), project=str(tmp_path / "port"), save_txt=True, **kw)
    jdir, pdir = tmp_path / "jax/jde/pred", tmp_path / "port/jde/pred"
    names = sorted(p.name for p in jdir.glob("*.jpg"))
    assert names == sorted(p.name for p in pdir.glob("*.jpg")) == [f"f{i}.jpg" for i in range(4)]
    excluded = 0
    for g, w in zip(got, want):
        name = Path(str(g.path)).name
        written = (pdir / name).read_bytes()
        assert written == encode_jpeg(_jax_plot(g)) == encode_jpeg(g.plot()), name
        if _same_ints(g, w):
            assert written == (jdir / name).read_bytes(), name
        else:
            excluded += 1
    print(f"predict(save=True): {excluded} of {len(got)} frames excluded from the file check")
    assert excluded < len(got) and sum(len(r) for r in got) > 0
    n = len(text_calls["port"]) // 2  # the stream's labels, then the checks' re-plots
    assert text_calls["port"][:n] == text_calls["jax"][:n] == text_calls["jax"][n:2 * n]
    # save_txt shares the folder (JAX numbers a new folder per frame for its labels)
    assert sorted(p.name for p in (pdir / "labels").glob("*.txt")) == \
        [f"f{i}.txt" for i in range(4)]


@pytest.fixture(scope="module")
def scene_avi(tmp_path_factory):
    from test_torch_port_video import _scene, _write
    return _write(tmp_path_factory.mktemp("scene") / "scene.avi", _scene(), fps=25.0)


def test_track_save_matches_jax(tiny, scene_avi, tmp_path, monkeypatch, text_calls):
    jyolo, pyolo = tiny
    jax_frames, port_frames = [], []
    real_writer = cv2.VideoWriter

    class RecordingVideoWriter:
        def __init__(self, *args):
            self.writer = real_writer(*args)

        def write(self, img):
            jax_frames.append(img.copy())
            self.writer.write(img)

        def release(self):
            self.writer.release()

    class RecordingAviWriter(AviWriter):
        def write(self, frame):
            port_frames.append(frame.copy())
            super().write(frame)
    monkeypatch.setattr(cv2, "VideoWriter", RecordingVideoWriter)
    monkeypatch.setattr(port_predictor, "AviWriter", RecordingAviWriter)
    jyolo._predictor_cache = pyolo._predictor_cache = None
    kw = dict(imgsz=128, max_det=4, save=True, name="trk", exist_ok=True)
    JaxSTrack._count = STrack._count = 0
    want = jyolo.track(str(scene_avi), project=str(tmp_path / "jax"), **kw)
    JaxSTrack._count = STrack._count = 0
    got = pyolo.track(str(scene_avi), project=str(tmp_path / "port"), **kw)
    assert len(jax_frames) == len(port_frames) == len(got) == 8
    stream_calls = list(text_calls["port"])
    assert stream_calls == text_calls["jax"]  # rows agree, labels too
    text_calls["jax"].clear()
    excluded, tracked = 0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(port_frames[i], _jax_plot(g), err_msg=f"frame {i}")
        tracked += len(g.boxes.data) if g.boxes.id is not None else 0
        if _same_ints(g, w):
            np.testing.assert_array_equal(port_frames[i], jax_frames[i], err_msg=f"frame {i}")
        else:
            excluded += 1
    print(f"track(save=True): {excluded} of {len(got)} frames excluded from JAX's frames")
    assert tracked > 0 and excluded <= 2 and text_calls["jax"] == stream_calls
    jpath, ppath = tmp_path / "jax/jde/trk/scene.avi", tmp_path / "port/jde/trk/scene.avi"
    assert list(AviReader(ppath).packets()) == [encode_jpeg(f) for f in port_frames]
    caps = [cv2.VideoCapture(str(p)) for p in (jpath, ppath)]
    for prop in (cv2.CAP_PROP_FRAME_COUNT, cv2.CAP_PROP_FPS, cv2.CAP_PROP_FRAME_WIDTH,
                 cv2.CAP_PROP_FRAME_HEIGHT):
        assert caps[0].get(prop) == caps[1].get(prop)
    assert caps[1].get(cv2.CAP_PROP_FPS) == 25 and caps[1].get(cv2.CAP_PROP_FRAME_COUNT) == 8
    for i in range(8):
        (ok_j, fj), (ok_p, fp) = caps[0].read(), caps[1].read()
        assert ok_j and ok_p
        assert np.abs(fj.astype(int) - fp.astype(int)).mean() <= MJPEG_MEAN_ABS
        # each file's frame against the plotted one: quality 95 is the closer
        err_j, err_p = (np.abs(f.astype(int) - port_frames[i].astype(int)).mean() for f in (fj, fp))
        print(f"frame {i}: mean abs {np.abs(fj.astype(int) - fp.astype(int)).mean():.3f}, "
              f"to the plotted frame FFmpeg {err_j:.3f}, port {err_p:.3f}")
        assert err_p < err_j


# ---- (d) Masks.xy -----------------------------------------------------------------------------

def test_masks_xy_of_a_segment_model_match_jax(frames_dir):
    jyolo, pyolo = jax_and_port_yolo("tinyseg.yaml", 3, cls_gain=40.0)
    got = pyolo.predict(str(frames_dir), imgsz=64, conf=0.3, max_det=6)
    want = jyolo.predict(str(frames_dir), imgsz=64, conf=0.3, max_det=6)
    checked = 0
    for g, w in zip(got, want):
        assert g.masks is not None and len(g.masks)
        jm = JaxMasks(g.masks.data, g.orig_shape)  # JAX's contours of the same masks
        for a, b in zip(g.masks.xy, jm.xy):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        for a, b in zip(g.masks.xyn, jm.xyn):
            np.testing.assert_array_equal(a, b)
        same = [k for k in range(len(g.masks)) if k < len(w.masks)
                and np.array_equal(g.masks.data[k], np.asarray(w.masks.data[k]))]
        for k in same:  # and JAX's own masks, where the masks agree
            np.testing.assert_array_equal(g.masks.xy[k], w.masks.xy[k])
        checked += len(same)
    assert checked > 0
    empty = Results(np.zeros((8, 8, 3), np.uint8), "e.jpg", NAMES,
                    masks=np.zeros((1, 8, 8), bool))
    assert empty.masks.xy[0].shape == (0, 2) and empty.masks.xy[0].dtype == np.float32


# ---- (e) auto_annotate ------------------------------------------------------------------------

def test_auto_annotate_matches_jax(tiny, tmp_path, monkeypatch):
    from sar_yolo_tpu.models.sam.build import SAM_CONFIGS as JAX_SAM_CONFIGS
    from sar_yolo_tpu.models.sam.predict import SAMPredictor as JaxSAMPredictor
    from test_torch_port_sam import MASK_GAIN, jax_sam, port_sam
    jyolo, pyolo = tiny
    jyolo._predictor_cache = pyolo._predictor_cache = None
    module, variables = jax_sam("sam_test", JAX_SAM_CONFIGS, seed=2)
    for i in range(3):
        layer = variables["params"]["mask_decoder"][f"hyper_mlp_{i}"]["l2"]
        layer["kernel"] = layer["kernel"] * MASK_GAIN
        layer["bias"] = layer["bias"] * MASK_GAIN
    jax_predictor = JaxSAMPredictor(module, variables, imgsz=128)

    class JaxSam:  # JAX's SAM facade over these weights
        def __call__(self, source, bboxes=None):
            return jax_predictor(source, bboxes=bboxes)
    monkeypatch.setattr(jax_model_module, "YOLO", lambda *a, **k: jyolo)
    monkeypatch.setattr(jax_sam_module, "SAM", lambda *a, **k: JaxSam())
    data = tmp_path / "images"
    data.mkdir()
    for i, (h, w) in enumerate([(96, 160), (120, 90), (64, 64)]):
        cv2.imwrite(str(data / f"im{i}.jpg"), _natural(h, w, seed=10 + i))
    from sar_yolo_tpu.data.annotator import auto_annotate as jax_auto_annotate
    kw = dict(conf=0.5, imgsz=64, max_det=3)
    jout = jax_auto_annotate(data, output_dir=tmp_path / "jax_labels", **kw)
    pout = auto_annotate(data, det_model=pyolo, sam_model=port_sam("sam_test", variables),
                         output_dir=tmp_path / "port_labels", **kw)
    assert pout == tmp_path / "port_labels"
    files = sorted(p.name for p in Path(jout).glob("*.txt"))
    assert files == sorted(p.name for p in pout.glob("*.txt")) and len(files) == 3
    points = 0
    for name in files:
        jl = (Path(jout) / name).read_text().splitlines()
        pl = (pout / name).read_text().splitlines()
        assert len(pl) == len(jl) > 0
        for a, b in zip(pl, jl):
            va, vb = a.split(), b.split()
            assert va[0] == vb[0] and len(va) == len(vb) and len(va) % 2 == 1
            assert all(len(v.split(".")[1]) == 6 for v in va[1:])
            np.testing.assert_allclose(np.float64(va[1:]), np.float64(vb[1:]), rtol=0,
                                       atol=TOL / 64 + 1e-6)
            points += (len(va) - 1) // 2
    assert points > 0


# ---- (f) the command line, and an exported artifact -------------------------------------------

def test_cli_predict_and_track_save(frames_dir, scene_avi, tmp_path):
    argv = ["jde", "predict", "model=tinyjde.yaml", f"source={frames_dir}", "imgsz=64",
            "conf=0.05", "max_det=5", "save=True", f"project={tmp_path}", "name=cli",
            "device=cpu"]
    got = port_cfg.entrypoint(argv)
    out = tmp_path / "jde" / "cli"
    assert sorted(p.name for p in out.glob("*.jpg")) == [f"f{i}.jpg" for i in range(4)]
    for r in got:
        assert (out / Path(str(r.path)).name).read_bytes() == encode_jpeg(r.plot())
    argv = ["jde", "track", "model=tinyjde.yaml", f"source={scene_avi}", "imgsz=64",
            "save=True", f"project={tmp_path}", "name=cli_track", "device=cpu"]
    got = port_cfg.entrypoint(argv)
    reader = AviReader(tmp_path / "jde" / "cli_track" / "scene.avi")
    assert (reader.frame_count, reader.fps) == (len(got), 25.0) == (8, 25.0)
    assert list(reader.packets()) == [encode_jpeg(r.plot()) for r in got]


def test_save_with_an_exported_artifact_writes_nothing(tiny, frames_dir, tmp_path):
    """The JAX package's artifact predictor never reads `save`: no file, no error."""
    from sar_yolo_tpu_torch import YOLO
    _, pyolo = tiny
    path = pyolo.export(format="pt2", imgsz=64, project=str(tmp_path / "exports"))
    art = YOLO(path, device="cpu")
    res = art.predict(str(frames_dir), conf=0.3, save=True, project=str(tmp_path / "runs"))
    assert len(res) == 4
    assert not (tmp_path / "runs").exists()
