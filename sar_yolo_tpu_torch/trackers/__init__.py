"""Multi-object tracking over the predictor's results: ByteTrack and BoT-SORT (port of
`sar_yolo_tpu/trackers/__init__.py`). A tracker config is a YAML file, or the name of one
of `cfg/trackers/` (bytetrack.yaml, botsort.yaml)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from sar_yolo_tpu_torch.utils import ROOT
from sar_yolo_tpu_torch.utils.dataset_yaml import load_yaml
from .bot_sort import BOTSORT
from .byte_tracker import BYTETracker

TRACKER_MAP = {"bytetrack": BYTETracker, "botsort": BOTSORT}


def make_tracker(tracker="bytetrack.yaml", frame_rate=30):
    """A tracker from a config YAML's path or name."""
    name = Path(tracker).stem
    cfg_path = Path(tracker)
    if not cfg_path.exists():
        cfg_path = ROOT / "cfg" / "trackers" / f"{name}.yaml"
    cfg = load_yaml(cfg_path) if cfg_path.exists() else {}
    cls = TRACKER_MAP[cfg.get("tracker_type", name)]
    kwargs = dict(
        track_high_thresh=cfg.get("track_high_thresh", 0.5),
        track_low_thresh=cfg.get("track_low_thresh", 0.1),
        new_track_thresh=cfg.get("new_track_thresh", 0.6),
        track_buffer=cfg.get("track_buffer", 30),
        match_thresh=cfg.get("match_thresh", 0.8),
        fuse_score_flag=cfg.get("fuse_score", True),
        frame_rate=frame_rate,
    )
    if cls is BOTSORT:
        kwargs.update(proximity_thresh=cfg.get("proximity_thresh", 0.5),
                      appearance_thresh=cfg.get("appearance_thresh", 0.25),
                      with_reid=cfg.get("with_reid", True),
                      gmc_method=cfg.get("gmc_method", "sparseOptFlow"))
    return cls(**kwargs)


def track_results(results, tracker="bytetrack.yaml"):
    """Run a tracker over a sequence of Results; writes the track ids into boxes column 6."""
    trk = make_tracker(tracker)
    for res in results:
        if res.boxes is None or len(res.boxes) == 0:
            continue
        tracks = trk.update(res.boxes.data[:, :6], res.embeds, img=res.orig_img)
        if len(tracks):
            res.boxes.data = tracks  # [x1, y1, x2, y2, conf, cls, track_id]
    return results


def register_tracker(predictor, tracker="bytetrack.yaml", persist: bool = False):
    """Attach per-frame tracking to a predictor through its callbacks: one tracker per
    stream (`meta["source_i"]`), one per video file (its path, at its frame rate), and one
    for all the frames of an image source (files, arrays, tensors) in their order, as
    Ultralytics keys them (the JAX package keys them by frame path, so each image file got
    a tracker of its own and no identity crossed frames). `predictor._tracker` and
    `predictor._tracker_persist`, read at each call's start, name the config and whether
    the trackers of earlier calls go on (True) or start again (False, and on a change of
    config)."""
    predictor._tracker, predictor._tracker_persist = tracker, persist

    def on_predict_start(pred):
        if not pred._tracker_persist or getattr(pred, "_tracker_made", None) != pred._tracker:
            pred.trackers.clear()
        pred._tracker_made = pred._tracker

    def on_predict_postprocess_end(pred):
        path, _, meta = pred.batch
        key = meta["source_i"] if "source_i" in meta else (str(path) if meta.get("video") else 0)
        trk = pred.trackers.get(key)
        if trk is None:
            trk = make_tracker(pred._tracker, frame_rate=int(meta.get("fps") or 30))
            pred.trackers[key] = trk
        res = pred.results[0]
        if res.boxes is None:
            return
        dets = res.boxes.data[:, :6]
        tracks = trk.update(dets, res.embeds, img=res.orig_img)
        res.boxes.data = tracks if len(tracks) else np.zeros((0, 7), dets.dtype)

    predictor.add_callback("on_predict_start", on_predict_start)
    predictor.add_callback("on_predict_postprocess_end", on_predict_postprocess_end)
    return predictor
