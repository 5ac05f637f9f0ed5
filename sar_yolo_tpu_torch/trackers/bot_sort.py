"""BoT-SORT: ByteTrack with ReID embedding fusion (port of
`sar_yolo_tpu/trackers/bot_sort.py`), the JDE head's embeddings as the ReID features. A
detect model's Results carry no embeddings: its tracks then match by IoU alone.

Camera-motion compensation (`trackers/gmc.py`, `gmc_method`: sparseOptFlow, the default,
or none) warps the predicted tracks by the camera's motion before they are matched;
orb, sift and ecc raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np

from .byte_tracker import BYTETracker, STrack
from .gmc import GMC
from .kalman_filter import KalmanFilterXYWH
from .matching import embedding_distance, iou_distance


class BOTrack(STrack):
    shared_kalman = KalmanFilterXYWH()

    def __init__(self, xyxy, score, cls, feat=None, feat_history=50):
        super().__init__(xyxy, score, cls)
        self.smooth_feat = None
        self.curr_feat = None
        if feat is not None:
            self.update_features(feat)
        self.alpha = 0.9

    def update_features(self, feat):
        feat = feat / (np.linalg.norm(feat) + 1e-9)
        self.curr_feat = feat
        self.smooth_feat = feat if self.smooth_feat is None else \
            self.alpha * self.smooth_feat + (1 - self.alpha) * feat
        self.smooth_feat /= np.linalg.norm(self.smooth_feat) + 1e-9

    def update(self, new_track, frame_id):
        if new_track.curr_feat is not None:
            self.update_features(new_track.curr_feat)
        super().update(new_track, frame_id)

    def re_activate(self, new_track, frame_id, new_id=False):
        if new_track.curr_feat is not None:
            self.update_features(new_track.curr_feat)
        super().re_activate(new_track, frame_id, new_id)

    def _to_xyah(self, tlwh):  # XYWH filter: measurement is (cx, cy, w, h)
        return np.array([tlwh[0] + tlwh[2] / 2, tlwh[1] + tlwh[3] / 2, tlwh[2], tlwh[3]])

    @property
    def tlwh(self):
        if self.mean is None:
            return self._tlwh.copy()
        x, y, w, h = self.mean[:4]
        return np.array([x - w / 2, y - h / 2, w, h])


class BOTSORT(BYTETracker):
    """IoU and embedding distance fused in the association."""

    def __init__(self, proximity_thresh=0.5, appearance_thresh=0.25, with_reid=True,
                 gmc_method="sparseOptFlow", **kw):
        super().__init__(**kw)
        self.proximity_thresh = proximity_thresh
        self.appearance_thresh = appearance_thresh
        self.with_reid = with_reid
        self.kalman_filter = KalmanFilterXYWH()
        self.gmc = GMC(method=gmc_method) if gmc_method not in (None, "none") else None

    def make_track(self, xyxy, score, cls, extra=None):
        return BOTrack(xyxy, score, cls, feat=extra if self.with_reid else None)

    def get_dists(self, tracks, detections):
        dists = iou_distance(tracks, detections)
        dists_mask = dists > (1 - self.proximity_thresh)
        if self.with_reid and len(tracks) and len(detections) and \
                all(getattr(t, "smooth_feat", None) is not None for t in tracks) and \
                all(getattr(d, "curr_feat", None) is not None for d in detections):
            emb = embedding_distance(tracks, detections) / 2.0
            emb[emb > self.appearance_thresh] = 1.0
            emb[dists_mask] = 1.0
            dists = np.minimum(dists, emb)
        return dists
