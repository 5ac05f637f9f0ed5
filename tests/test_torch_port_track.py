"""The trackers and `YOLO.track` of the PyTorch port against the JAX package's, on the CPU.

ByteTrack and BoT-SORT (ReID on the JDE embeddings, `gmc_method: none`) fed one scripted
sequence of detections and embeddings (two persons crossing, one occluded for longer
than `track_buffer` and one for less, one seen at low confidence only, a late arrival,
clutter) give the JAX package's track rows exactly: both run the same float64 numpy.

`YOLO.track` over a folder of frames gives the ids (and the rows, within 1e-4) of the JAX
package's tracker run over JAX's `YOLO.predict` results of the same frames
(`trackers.track_results`), with the same weights (tinyjde, its class logits scaled so
that scores spread). The port keys trackers as Ultralytics does, one for all the frames
of an image source; the JAX package's `YOLO.track` keys them by frame path, so on a
folder every frame gets a tracker of its own. `persist=True` carries identities across
calls; without it the second call starts new tracks. BoT-SORT's camera-motion
compensation methods other than sparseOptFlow and none (orb, sift, ecc) raise
NotImplementedError; sparseOptFlow is held to the JAX package in
test_torch_port_gmc.py and test_torch_port_video.py.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest

from sar_yolo_tpu.trackers import make_tracker as jax_make_tracker
from sar_yolo_tpu.trackers import track_results as jax_track_results
from sar_yolo_tpu.trackers.byte_tracker import STrack as JaxSTrack
from sar_yolo_tpu_torch.trackers import BOTSORT, make_tracker, track_results
from sar_yolo_tpu_torch.trackers.byte_tracker import STrack
from torch_port_common import jax_and_port_yolo, one_torch_thread  # noqa: F401

TOL = 1e-4
COMMON = ("track_high_thresh: 0.5\ntrack_low_thresh: 0.1\nnew_track_thresh: 0.6\n"
          "track_buffer: {buffer}\nmatch_thresh: 0.8\nfuse_score: True\n")
CONFIGS = {
    "bytetrack": "tracker_type: bytetrack\n" + COMMON,
    "botsort_no_gmc": "tracker_type: botsort\n" + COMMON + "gmc_method: none\n"
                      "proximity_thresh: 0.5\nappearance_thresh: 0.25\nwith_reid: True\n",
}


def _config(tmp_path, kind: str, buffer: int = 30) -> str:
    path = tmp_path / f"{kind}_{buffer}.yaml"
    path.write_text(CONFIGS[kind].format(buffer=buffer))
    return str(path)


def _reset_ids():
    JaxSTrack._count = STrack._count = 0


def _scripted_sequence(n_frames: int = 40, seed: int = 0):
    """Per frame, (detections (n, 6) float32, embeddings (n, 32) float32) in shuffled order.

    Persons 0 and 1 walk towards each other and cross at frame ~15; person 2 is hidden in
    frames 10-17 (8 frames, over a track_buffer of 4), person 3 in frames 20-22 (3
    frames); person 4 is seen at confidence 0.2-0.45 in frames 5-12 (ByteTrack's second
    association); person 5 arrives at frame 8; three clutter boxes a frame at 0.02-0.3.
    """
    rng = np.random.default_rng(seed)
    start = np.array([[20, 100], [320, 104], [60, 220], [200, 40], [150, 300], [300, 250]], float)
    vel = np.array([[10, 0.5], [-10, 0], [4, -1], [-3, 3], [2, -2], [-4, -1]], float)
    size = np.array([[30, 60], [28, 58], [34, 64], [26, 52], [30, 62], [32, 60]], float)
    base = rng.normal(size=(6, 32))
    seq = []
    for t in range(n_frames):
        dets, embs = [], []
        for k in range(6):
            if (k == 2 and 10 <= t <= 17) or (k == 3 and 20 <= t <= 22) or (k == 5 and t < 8):
                continue
            cx, cy = start[k] + vel[k] * t + rng.normal(0, 1.0, 2)
            w, h = size[k] + rng.normal(0, 0.5, 2)
            conf = rng.uniform(0.2, 0.45) if (k == 4 and 5 <= t <= 12) else rng.uniform(0.62, 0.95)
            dets.append([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2, conf, 0])
            embs.append(base[k] + rng.normal(0, 0.15, 32))
        for _ in range(3):
            x, y = rng.uniform(0, 400, 2)
            dets.append([x, y, x + rng.uniform(10, 40), y + rng.uniform(10, 40),
                         rng.uniform(0.02, 0.3), 0])
            embs.append(rng.normal(size=32))
        order = rng.permutation(len(dets))
        seq.append((np.asarray(dets, np.float32)[order], np.asarray(embs, np.float32)[order]))
    return seq


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_trackers_match_jax_on_a_scripted_sequence(kind, tmp_path):
    cfg = _config(tmp_path, kind, buffer=4)
    _reset_ids()
    got_trk, want_trk = make_tracker(cfg), jax_make_tracker(cfg)
    assert type(got_trk).__name__ == type(want_trk).__name__
    ids, low_conf_kept = set(), 0
    for t, (dets, embs) in enumerate(_scripted_sequence()):
        got = got_trk.update(dets, embs)
        want = want_trk.update(dets, embs)
        assert got.shape == want.shape, f"frame {t}"
        np.testing.assert_array_equal(got, want, err_msg=f"frame {t}")
        ids |= set(got[:, 6].astype(int).tolist())
        low_conf_kept += int(((got[:, 4] > 0.1) & (got[:, 4] < 0.5)).sum())
    assert STrack._count == JaxSTrack._count
    assert 6 < len(ids) < 20  # new ids after the long occlusion, but no churn
    assert low_conf_kept > 0  # the second association keeps low-confidence matches


@pytest.fixture
def tiny(tiny_weights):
    """The pair with no predictor kept from an earlier test (nor its trackers)."""
    tiny_weights[1]._predictor_cache = None
    return tiny_weights


@pytest.fixture(scope="module")
def tiny_weights():
    return jax_and_port_yolo("tinyjde.yaml", 3, cls_gain=40.0)


@pytest.fixture(scope="module")
def sequence_dir(tmp_path_factory):
    """10 JPEG frames of 96x128: a window moving 2 px down and 3 px right a frame over a
    scene of colour cells."""
    root = tmp_path_factory.mktemp("sequence")
    rng = np.random.default_rng(4)
    cells = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    scene = cv2.resize(cells, (320, 240), interpolation=cv2.INTER_NEAREST)
    for t in range(10):
        frame = scene[20 + 2 * t:116 + 2 * t, 30 + 3 * t:158 + 3 * t]
        cv2.imwrite(str(root / f"s{t:02d}.jpg"), frame, [cv2.IMWRITE_JPEG_QUALITY, 90])
    return root


def _assert_same_tracks(got: list, want: list):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.boxes.is_track and w.boxes.is_track and len(g) == len(w) > 0
        np.testing.assert_array_equal(g.boxes.id, w.boxes.id)
        np.testing.assert_array_equal(g.boxes.cls, w.boxes.cls)
        np.testing.assert_allclose(g.boxes.data[:, :5], w.boxes.data[:, :5], rtol=0, atol=TOL)


KW = dict(imgsz=128)  # track's conf defaults to 0.1 in both packages


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_yolo_track_matches_jax_tracker_over_the_frames(kind, tiny, sequence_dir, tmp_path):
    jyolo, pyolo = tiny
    cfg = "bytetrack.yaml" if kind == "bytetrack" else _config(tmp_path, kind)
    _reset_ids()
    want = jax_track_results(jyolo.predict(str(sequence_dir), conf=0.1, **KW), cfg)
    untracked = pyolo.predict(str(sequence_dir), conf=0.1, **KW)  # before track's callbacks
    _reset_ids()
    got = pyolo.track(str(sequence_dir), tracker=cfg, **KW)
    _assert_same_tracks(got, want)
    _reset_ids()
    _assert_same_tracks(track_results(untracked, cfg), want)
    assert len({int(i) for r in got for i in r.boxes.id}) < sum(len(r) for r in got)  # ids recur
    assert [s["track_id"] for s in got[-1].summary()] == got[-1].boxes.id.astype(int).tolist()


@pytest.mark.parametrize("persist", [True, False])
def test_persist_carries_ids_across_calls(persist, tiny, sequence_dir):
    jyolo, pyolo = tiny
    paths = [str(p) for p in sorted(sequence_dir.glob("*.jpg"))]
    _reset_ids()
    first = jax_track_results(jyolo.predict(paths[:5], conf=0.1, **KW))
    rest = jyolo.predict(paths[5:], conf=0.1, **KW)
    if persist:  # one tracker over all the frames
        _reset_ids()
        want = jax_track_results(jyolo.predict(paths[:5], conf=0.1, **KW) + rest)[5:]
    else:
        want = jax_track_results(rest)
    _reset_ids()
    got_first = pyolo.track(paths[:5], persist=persist, **KW)
    got = pyolo.track(paths[5:], persist=persist, **KW)
    _assert_same_tracks(got_first, first)
    _assert_same_tracks(got, want)
    before = {int(i) for r in got_first for i in r.boxes.id}
    after = {int(i) for r in got for i in r.boxes.id}
    if persist:
        assert after <= before
    else:
        assert min(after) > max(before)


def test_botsort_with_camera_motion_compensation_raises(tiny, sequence_dir, tmp_path):
    _, pyolo = tiny
    orb = tmp_path / "botsort_orb.yaml"
    orb.write_text(CONFIGS["botsort_no_gmc"].format(buffer=30).replace("none", "orb"))
    with pytest.raises(NotImplementedError, match="GMC method 'orb'.*ROADMAP"):
        pyolo.track(str(sequence_dir), tracker=str(orb), **KW)
    with pytest.raises(NotImplementedError, match="GMC method 'orb'"):
        make_tracker(str(orb))
    assert make_tracker("botsort.yaml").gmc.method == "sparseOptFlow"
    # a tracker config changed between calls makes new trackers, persist or not
    pyolo.track(str(sequence_dir), **KW)
    predictor = pyolo._predictor_cache[1]
    pyolo.track(str(sequence_dir), persist=True, tracker=_config(tmp_path, "botsort_no_gmc"), **KW)
    assert len(predictor.trackers) == 1 and isinstance(predictor.trackers[0], BOTSORT)


def test_tracker_configs_are_the_jax_packages():
    root = Path(__file__).resolve().parents[1]
    for name in ("bytetrack.yaml", "botsort.yaml"):
        assert (root / "sar_yolo_tpu_torch" / "cfg" / "trackers" / name).read_text() == \
            (root / "sar_yolo_tpu" / "cfg" / "trackers" / name).read_text()
