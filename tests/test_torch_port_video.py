"""Video sources of the PyTorch port against OpenCV's FFmpeg reader and the JAX package, on
the CPU.

(a) `data/avi.py`: the packets equal `cv2.VideoCapture`'s raw packets (`CAP_PROP_FORMAT =
-1`) byte for byte, fps and frame count equal `CAP_PROP_FPS` / `CAP_PROP_FRAME_COUNT`, on the
fixture flight and on clips written here (odd sizes, qualities 10 and 95, 12.5 fps, a
zero-length chunk); OpenDML files and codecs other than MJPG raise NotImplementedError
naming ROADMAP.
(b) `imageio.decode_mjpeg_frame`: every frame equals `cv2.VideoCapture`'s bit for bit
(FFmpeg's simple IDCT and swscale's yuvj420p conversion, not libjpeg's pixels), and the
fixture's frames their digests.
(c) The loaders: a folder of images and a video gives the JAX package's frames and meta;
`LoadStreams(buffer=True)` over a `.streams` file of two copies gives the JAX package's
frames (JAX's buffered reader skips each source's first frame; the port serves it), and
every frame once and in order with more reader threads than cores; webcam indices and URLs
raise without touching the network.
(d) `YOLO.track` over an AVI with ByteTrack and with BoT-SORT + sparseOptFlow gives the JAX
package's `YOLO.track` ids, rows within 1e-4 (tinyjde, 96x128 frames of a panning scene),
one tracker a video at the file's frame rate; `SAM.track` over an AVI at `sam2_test` size
gives the JAX package's `SAM2VideoPredictor` results.
"""

import hashlib
import json
import socket
import struct
import time
from pathlib import Path

import cv2
import numpy as np
import pytest

from sar_yolo_tpu.data.loaders import LoadImagesAndVideos as JaxLoadImagesAndVideos
from sar_yolo_tpu.data.loaders import LoadStreams as JaxLoadStreams
from sar_yolo_tpu.trackers.byte_tracker import STrack as JaxSTrack
from sar_yolo_tpu_torch.data.avi import AviReader
from sar_yolo_tpu_torch.data.imageio import decode_mjpeg_frame
from sar_yolo_tpu_torch.data.loaders import (LoadImagesAndVideos, LoadStreams,
                                             load_inference_source)
from sar_yolo_tpu_torch.trackers.byte_tracker import STrack
from torch_port_common import jax_and_port_yolo, one_torch_thread  # noqa: F401

VIDEO = Path(__file__).parent / "data" / "video"
TOL = 1e-4


def _write(path, frames, fps=25.0, quality=None, fourcc="MJPG"):
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert vw.isOpened() and vw.getBackendName() == "FFMPEG"
    if quality is not None:
        vw.set(cv2.VIDEOWRITER_PROP_QUALITY, quality)
    for f in frames:
        vw.write(f)
    vw.release()
    return path


def _capture(path, raw: bool = False):
    cap = cv2.VideoCapture(str(path))
    if raw:
        cap.set(cv2.CAP_PROP_FORMAT, -1)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f.tobytes() if raw else f)
    fps, count = cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)
    cap.release()
    return out, fps, count


def _noise_frames(n, h, w, seed):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (max(h // 4, 1), max(w // 4, 1), 3), dtype=np.uint8)
    return [np.clip(cv2.resize(np.roll(small, t, 1), (w, h), interpolation=cv2.INTER_LINEAR)
                    .astype(int) + rng.integers(-25, 26, (h, w, 3)), 0, 255).astype(np.uint8)
            for t in range(n)]


def _scene(n=8, h=96, w=128, seed=2):
    """A window panning 3 px right and 2 px down a frame over colour cells with two blobs
    walking across: corners for GMC, shapes for the detector."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    ground = cv2.resize(cells, (320, 240), interpolation=cv2.INTER_NEAREST)
    frames = []
    for t in range(n):
        img = ground.copy()
        cv2.ellipse(img, (80 + 4 * t, 70), (7, 14), 0, 0, 360, (30, 30, 210), -1)
        cv2.ellipse(img, (140 - 3 * t, 90), (7, 14), 0, 0, 360, (210, 40, 40), -1)
        frames.append(np.ascontiguousarray(img[20 + 2 * t:20 + 2 * t + h, 30 + 3 * t:30 + 3 * t + w]))
    return frames


CLIPS = {"odd_97x131": dict(size=(97, 131)), "q10": dict(size=(64, 96), quality=10),
         "q95": dict(size=(64, 96), quality=95), "fps12.5": dict(size=(48, 64), fps=12.5),
         "odd_35x17": dict(size=(35, 17))}


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    out = {"flight": VIDEO / "flight.avi"}
    for i, (name, kw) in enumerate(CLIPS.items()):
        out[name] = _write(root / f"{name}.avi", _noise_frames(5, *kw["size"], seed=i),
                           fps=kw.get("fps", 25.0), quality=kw.get("quality"))
    return out


# ---- (a) the demuxer ------------------------------------------------------------------------

def test_demuxer_packets_equal_videocaptures(clips):
    for name, path in clips.items():
        want, fps, count = _capture(path, raw=True)
        reader = AviReader(path)
        assert reader.fourcc == "MJPG" and reader.fps == fps and reader.frame_count == count
        assert list(reader.packets()) == want, name
        assert len(reader) == len(want) > 0


def _edited(path, out, edit):
    data = bytearray(Path(path).read_bytes())
    edit(data)
    out.write_bytes(bytes(data))
    return out


def _zero_length_chunk(data):
    """A zero-length 00dc chunk first in movi; idx1 renamed away, so FFmpeg reads movi."""
    i = data.index(b"movi")
    data[i + 4:i + 4] = b"00dc" + struct.pack("<I", 0)
    struct.pack_into("<I", data, i - 4, struct.unpack_from("<I", data, i - 4)[0] + 8)
    struct.pack_into("<I", data, 4, struct.unpack_from("<I", data, 4)[0] + 8)
    j = data.index(b"idx1")
    data[j:j + 4] = b"JUNK"


def test_demuxer_skips_zero_length_chunks_and_refuses_opendml(clips, tmp_path):
    path = _edited(clips["q10"], tmp_path / "zero.avi", _zero_length_chunk)
    want, fps, count = _capture(path, raw=True)
    assert list(AviReader(path).packets()) == want and len(want) == count == 5

    def indx(data):  # the JUNK placeholder of the stream's super index, made one
        i = data.index(b"JUNK", data.index(b"strf"))
        data[i:i + 4] = b"indx"

    def ix(data):
        i = data.index(b"00dc", data.index(b"movi"))
        data[i:i + 4] = b"ix00"

    for name, edit in (("indx", indx), ("ix##", ix)):
        with pytest.raises(NotImplementedError, match=f"OpenDML.*{name[:2]}.*ROADMAP"):
            AviReader(_edited(clips["q10"], tmp_path / f"{name[:2]}.avi", edit))
    avix = tmp_path / "avix.avi"
    avix.write_bytes(Path(clips["q10"]).read_bytes() + b"RIFF" + struct.pack("<I", 4) + b"AVIX")
    with pytest.raises(NotImplementedError, match="AVIX.*ROADMAP"):
        AviReader(avix)
    with pytest.raises(ValueError, match="not a RIFF/AVI"):
        AviReader(_edited(clips["q10"], tmp_path / "bad.avi", lambda d: d.__setitem__(0, 0)))


@pytest.mark.parametrize("fourcc", ["XVID", "FFV1"])
def test_other_codecs_and_containers_raise(tmp_path, fourcc):
    frames = _noise_frames(3, 48, 64, 9)
    path = _write(tmp_path / f"{fourcc}.avi", frames, fourcc=fourcc)
    with pytest.raises(NotImplementedError, match=f"codec '{fourcc}'.*ROADMAP"):
        AviReader(path)
    mp4 = _write(tmp_path / "clip.mp4", frames, fourcc="mp4v")
    with pytest.raises(NotImplementedError, match=r"\.mp4 video.*ROADMAP"):
        list(LoadImagesAndVideos(mp4))


# ---- (b) the decoder ------------------------------------------------------------------------

def test_decoded_frames_equal_videocaptures(clips):
    for name, path in clips.items():
        want, _, _ = _capture(path)
        got = [decode_mjpeg_frame(p) for p in AviReader(path).packets()]
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape and g.dtype == np.uint8
            np.testing.assert_array_equal(g, w, err_msg=f"{name} frame {i}")


def test_fixture_digests_and_the_image_decoders_difference():
    digests = json.loads((VIDEO / "digests.json").read_text())
    reader = AviReader(VIDEO / "flight.avi")
    assert (reader.fps, reader.frame_count) == (digests["fps"], digests["frame_count"]) == (25.0, 24)
    for i, packet in enumerate(reader.packets()):
        f = digests["frames"][i]
        assert hashlib.sha256(packet).hexdigest() == f["packet_sha256"]
        frame = decode_mjpeg_frame(packet)
        assert list(frame.shape) == digests["shape"]
        assert hashlib.sha256(frame.tobytes()).hexdigest() == f["bgr_sha256"]
    # libjpeg-turbo (cv2.imdecode, the image reader) gives other pixels for the same bytes
    assert (cv2.imdecode(np.frombuffer(packet, np.uint8), 1) != frame).mean() > 0.1


def test_decoder_refusals():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    for sampling in ("444", "422"):
        data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, getattr(
            cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")])[1].tobytes()
        with pytest.raises(NotImplementedError, match="4:2:0"):
            decode_mjpeg_frame(data)
    with pytest.raises(NotImplementedError, match="4:2:0"):
        decode_mjpeg_frame(cv2.imencode(".jpg", img[:1])[1].tobytes())
    with pytest.raises(NotImplementedError, match="progressive"):
        decode_mjpeg_frame(cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes())
    with pytest.raises(ValueError, match="corrupt"):
        decode_mjpeg_frame(b"\xff\xd8\xff\xd9")


# ---- (c) the loaders ------------------------------------------------------------------------

def test_images_and_videos_loader_matches_jax(tmp_path):
    frames = _noise_frames(4, 48, 64, 3)
    _write(tmp_path / "b_clip.avi", frames, fps=12.5)
    cv2.imwrite(str(tmp_path / "a_image.png"), frames[0])
    cv2.imwrite(str(tmp_path / "c_image.jpg"), frames[1])
    got, want = list(LoadImagesAndVideos(tmp_path)), list(JaxLoadImagesAndVideos(tmp_path))
    assert len(got) == len(want) == 6
    for (gp, gi, gm), (wp, wi, wm) in zip(got, want):
        assert gp == wp and gm == wm
        np.testing.assert_array_equal(gi, wi)
    assert got[1][2] == {"video": True, "frame": 0, "frames": 4, "fps": 12.5}


def _join_jax(loader):
    for t in loader.threads:
        t.join(timeout=30)


def test_load_streams_buffered_matches_jax(tmp_path):
    a = _write(tmp_path / "a.avi", _noise_frames(5, 48, 64, 4))
    b = _write(tmp_path / "b.avi", _noise_frames(4, 48, 64, 5))
    streams = tmp_path / "two.streams"
    streams.write_text(f"{a}\n{b}\n")
    jax_loader = JaxLoadStreams(str(streams), buffer=True)
    _join_jax(jax_loader)  # JAX's buffered order is then fixed: readers done, queues full
    want = list(jax_loader)
    loader, st = load_inference_source(str(streams), buffer=True)
    assert st.stream and isinstance(loader, LoadStreams)
    got = list(loader)
    # the port serves each source's first frame; JAX's buffered reader skips it
    assert [(p, m["source_i"]) for p, _, m in got[:2]] == [(str(a), 0), (str(b), 1)]
    first = [_capture(a)[0][0], _capture(b)[0][0]]
    for (_, img, _), ref in zip(got[:2], first):
        np.testing.assert_array_equal(img, ref)
    rest = got[2:]
    assert len(rest) == len(want) == 7
    for (gp, gi, gm), (wp, wi, wm) in zip(rest, want):
        assert gp == wp and gm["source_i"] == wm["source_i"] and gm["stream"]
        assert gm["frame"] == wm["frame"] + 1
        np.testing.assert_array_equal(gi, wi)
    # latest-frame mode: frames in order, each a frame of its source, ending on its last
    # (the first is whatever the slot holds when the consumer comes: see the stress test)
    frames_a = _capture(a)[0]
    seen = [img for _, img, m in LoadStreams(str(a)) if m["source_i"] == 0]
    assert 1 <= len(seen) <= len(frames_a)
    idx = [next(i for i, f in enumerate(frames_a) if np.array_equal(f, s)) for s in seen]
    assert idx == sorted(set(idx)) and idx[-1] == len(frames_a) - 1


def test_load_streams_buffered_under_thread_stress(tmp_path):
    """More reader threads than cores, switching every few microseconds: every frame of
    every source arrives once, in order, and every reader has ended."""
    import os
    import sys
    clip = _write(tmp_path / "c.avi", _noise_frames(6, 16, 24, 7))
    want = _capture(clip)[0]
    n = 2 * (os.cpu_count() or 4) + 1
    streams = tmp_path / "many.streams"
    streams.write_text(f"{clip}\n" * n)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        loader = LoadStreams(str(streams), buffer=True)
        got = list(loader)
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == n * len(want)
    for i in range(n):
        mine = [(m["frame"], img) for _, img, m in got if m["source_i"] == i]
        assert [f for f, _ in mine] == list(range(len(want)))
        for (_, img), ref in zip(mine, want):
            np.testing.assert_array_equal(img, ref)
    for t in loader.threads:
        t.join(timeout=10)
        assert not t.is_alive()


def test_load_streams_latest_frame_under_thread_stress(tmp_path):
    """Latest-frame mode keeps only the newest frame a source's reader has decoded, as the
    JAX package's reader does, so the consumer's first frame is not always the source's
    first: a consumer that comes after the readers have ended gets each source's last frame
    alone. Under many readers switching every few microseconds and a slow consumer, each
    source's frames still arrive in order, each once, ending on its last."""
    import os
    import sys
    clip = _write(tmp_path / "c.avi", _noise_frames(6, 16, 24, 8))
    want = _capture(clip)[0]
    n = 2 * (os.cpu_count() or 4) + 1
    streams = tmp_path / "many.streams"
    streams.write_text(f"{clip}\n" * n)

    late = LoadStreams(str(streams))
    for t in late.threads:
        t.join(timeout=10)
    got = list(late)
    assert [m["source_i"] for _, _, m in got] == list(range(n))
    for _, img, _ in got:
        np.testing.assert_array_equal(img, want[-1])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for rep in range(3):
            loader = LoadStreams(str(streams))
            got = []
            for item in loader:
                got.append(item)
                time.sleep(1e-4 * (len(got) % 3))
            for i in range(n):
                mine = [img for _, img, m in got if m["source_i"] == i]
                idx = [next(k for k, f in enumerate(want) if np.array_equal(f, s)) for s in mine]
                assert idx and idx == sorted(set(idx)) and idx[-1] == len(want) - 1, (rep, i, idx)
            for t in loader.threads:
                t.join(timeout=10)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)


def test_cameras_and_urls_raise_without_the_network(tmp_path, monkeypatch):
    def no_network(*a, **k):
        raise AssertionError("a network connection was attempted")

    monkeypatch.setattr(socket, "socket", no_network)
    monkeypatch.setattr(socket, "create_connection", no_network)
    streams = tmp_path / "cams.streams"
    streams.write_text("rtsp://192.0.2.1/live\n")
    for source in ("0", "rtsp://192.0.2.1/live", "http://192.0.2.1/cam.mjpg", str(streams)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            load_inference_source(source)
    with pytest.raises(NotImplementedError, match="screen"):
        load_inference_source("screen 0")


# ---- (d) YOLO.track and SAM.track over a video ----------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    return jax_and_port_yolo("tinyjde.yaml", 3, cls_gain=40.0)


@pytest.fixture(scope="module")
def scene_avi(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("scene") / "scene.avi", _scene(), fps=25.0)


def _assert_same_tracks(got, want):
    assert len(got) == len(want) == 8
    tracked = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.frame == i
        assert g.boxes.data.shape == w.boxes.data.shape, f"frame {i}"
        if len(w.boxes.data):
            np.testing.assert_array_equal(g.boxes.id, w.boxes.id, err_msg=f"frame {i}")
            np.testing.assert_allclose(g.boxes.data[:, :6], w.boxes.data[:, :6], rtol=0,
                                       atol=TOL, err_msg=f"frame {i}")
            tracked += len(w.boxes.data)
    assert tracked > 0


@pytest.mark.parametrize("tracker", ["bytetrack.yaml", "botsort.yaml"])
def test_yolo_track_over_a_video_matches_jax(tiny, scene_avi, tracker):
    jyolo, pyolo = tiny
    # JAX's predictor keeps the tracker config it was first registered with: a fresh one
    jyolo._predictor_cache = pyolo._predictor_cache = None
    JaxSTrack._count = STrack._count = 0
    want = jyolo.track(str(scene_avi), tracker=tracker, imgsz=128)
    JaxSTrack._count = STrack._count = 0
    got = pyolo.track(str(scene_avi), tracker=tracker, imgsz=128)
    _assert_same_tracks(got, want)
    predictor = pyolo._predictor_cache[1]
    trk = predictor.trackers[str(scene_avi)]
    assert trk.max_time_lost == int(25 / 30.0 * 30)  # the file's 25 fps
    assert (getattr(trk, "gmc", None) is not None) == (tracker == "botsort.yaml")


def test_sam_track_over_a_video_matches_jax(tmp_path):
    from sar_yolo_tpu.models.sam.predict import SAM2VideoPredictor as JaxVideoPredictor
    from test_torch_port_sam import IOU_TOL, port_sam
    from test_torch_port_sam2 import jax_sam2
    module, variables = jax_sam2(seed=1)
    sam = port_sam("sam2_test", variables)
    frames = []
    for t in range(3):
        f = np.full((96, 160, 3), 40, np.uint8)
        f[20:70, 40 + 6 * t:120 + 6 * t] = (200, 60, 60)
        frames.append(f)
    avi = _write(tmp_path / "box.avi", frames)
    want = JaxVideoPredictor(module, variables, imgsz=128)(str(avi), points=[[80, 45]])
    got = sam.track(str(avi), points=[[80, 45]])
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        n = len(w.boxes.data)
        assert g.frame == w.frame == i and g.path == w.path == str(avi)
        np.testing.assert_array_equal(g.orig_img, w.orig_img)
        assert g.masks.data.shape == w.masks.data.shape == (n, 96, 160)
        assert (g.masks.data != w.masks.data).mean() < 1e-2
        np.testing.assert_allclose(g.boxes.data[:, :4], w.boxes.data[:, :4], atol=1.0)
        np.testing.assert_allclose(g.boxes.data[:, 4], w.boxes.data[:, 4], atol=IOU_TOL)
        np.testing.assert_array_equal(g.boxes.data[:, 5:], w.boxes.data[:, 5:])
