"""ByteTrack: two-stage (high, then low confidence) association (port of
`sar_yolo_tpu/trackers/byte_tracker.py`). Host numpy; takes each frame's detection rows
[x1, y1, x2, y2, conf, cls] and returns the tracked rows with a track id appended.

Track ids come from one counter shared by every tracker of the process (`STrack._count`),
as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from .kalman_filter import KalmanFilterXYAH
from .matching import fuse_score, iou_distance, linear_assignment


class TrackState:
    New = 0
    Tracked = 1
    Lost = 2
    Removed = 3


class STrack:
    shared_kalman = KalmanFilterXYAH()
    _count = 0

    def __init__(self, xyxy, score, cls):
        x1, y1, x2, y2 = xyxy
        self._tlwh = np.array([x1, y1, x2 - x1, y2 - y1], np.float32)
        self.score = float(score)
        self.cls = cls
        self.kalman_filter = None
        self.mean, self.covariance = None, None
        self.state = TrackState.New
        self.is_activated = False
        self.track_id = 0
        self.frame_id = 0
        self.start_frame = 0
        self.tracklet_len = 0

    @staticmethod
    def next_id():
        STrack._count += 1
        return STrack._count

    @staticmethod
    def multi_gmc(stracks, H=np.eye(2, 3)):
        """Warp the tracks' Kalman states by the camera's motion H (2x3): its rotation
        block over all four (x, y) pairs of the state and the covariance, its translation
        on the position only."""
        if not len(stracks):
            return
        R8x8 = np.kron(np.eye(4), H[:2, :2])
        t = H[:2, 2]
        for st in stracks:
            if st.mean is None:
                continue
            mean = R8x8.dot(st.mean)
            mean[:2] += t
            st.mean = mean
            st.covariance = R8x8.dot(st.covariance).dot(R8x8.T)

    @property
    def tlwh(self):
        if self.mean is None:
            return self._tlwh.copy()
        x, y, a, h = self.mean[:4]
        w = a * h
        return np.array([x - w / 2, y - h / 2, w, h])

    @property
    def xyxy(self):
        t = self.tlwh
        return np.array([t[0], t[1], t[0] + t[2], t[1] + t[3]])

    def _to_xyah(self, tlwh):
        return np.array([tlwh[0] + tlwh[2] / 2, tlwh[1] + tlwh[3] / 2,
                         tlwh[2] / max(tlwh[3], 1e-6), tlwh[3]])

    def activate(self, kalman_filter, frame_id):
        self.kalman_filter = kalman_filter
        self.track_id = self.next_id()
        self.mean, self.covariance = kalman_filter.initiate(self._to_xyah(self._tlwh))
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = frame_id == 1
        self.frame_id = frame_id
        self.start_frame = frame_id

    def re_activate(self, new_track, frame_id, new_id=False):
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self._to_xyah(new_track._tlwh))
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        if new_id:
            self.track_id = self.next_id()
        self.score = new_track.score
        self.cls = new_track.cls

    def update(self, new_track, frame_id):
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self._to_xyah(new_track._tlwh))
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = new_track.score
        self.cls = new_track.cls

    def predict(self):
        mean_state = self.mean.copy()
        if self.state != TrackState.Tracked:
            mean_state[7] = 0
        self.mean, self.covariance = self.kalman_filter.predict(mean_state, self.covariance)

    def mark_lost(self):
        self.state = TrackState.Lost

    def mark_removed(self):
        self.state = TrackState.Removed


class BYTETracker:
    """Two-stage association: high-conf dets to tracks, then low-conf remainder."""

    def __init__(self, track_high_thresh=0.5, track_low_thresh=0.1, new_track_thresh=0.6,
                 track_buffer=30, match_thresh=0.8, fuse_score_flag=True, frame_rate=30):
        self.tracked_stracks: list[STrack] = []
        self.lost_stracks: list[STrack] = []
        self.removed_stracks: list[STrack] = []
        self.frame_id = 0
        self.track_high_thresh = track_high_thresh
        self.track_low_thresh = track_low_thresh
        self.new_track_thresh = new_track_thresh
        self.match_thresh = match_thresh
        self.fuse = fuse_score_flag
        self.max_time_lost = int(frame_rate / 30.0 * track_buffer)
        self.kalman_filter = KalmanFilterXYAH()

    def make_track(self, xyxy, score, cls, extra=None):
        return STrack(xyxy, score, cls)

    def update(self, dets: np.ndarray, extras: np.ndarray | None = None,
               img: np.ndarray | None = None) -> np.ndarray:
        """dets: (n, 6) [x1, y1, x2, y2, conf, cls]; returns (m, 7) rows with the track id.
        `img`: the BGR frame, which camera-motion compensation reads (a tracker with a
        `gmc`, BoT-SORT) to warp the predicted tracks by the camera's motion."""
        self.frame_id += 1
        scores = dets[:, 4]
        high = scores >= self.track_high_thresh
        low = (scores > self.track_low_thresh) & ~high
        det_high = [self.make_track(d[:4], d[4], d[5], extras[i] if extras is not None else None)
                    for i, d in enumerate(dets) if high[i]]
        det_low = [self.make_track(d[:4], d[4], d[5], extras[i] if extras is not None else None)
                   for i, d in enumerate(dets) if low[i]]

        activated, refind, lost, removed = [], [], [], []
        unconfirmed = [t for t in self.tracked_stracks if not t.is_activated]
        tracked = [t for t in self.tracked_stracks if t.is_activated]
        pool = joint_stracks(tracked, self.lost_stracks)
        for t in pool:
            t.predict()
        if getattr(self, "gmc", None) is not None and img is not None:
            warp = self.gmc.apply(img)
            STrack.multi_gmc(pool, warp)
            STrack.multi_gmc(unconfirmed, warp)

        # stage 1: high-conf
        dists = self.get_dists(pool, det_high)
        matches, u_track, u_det = linear_assignment(dists, self.match_thresh)
        for it, idet in matches:
            t, d = pool[it], det_high[idet]
            if t.state == TrackState.Tracked:
                t.update(d, self.frame_id)
                activated.append(t)
            else:
                t.re_activate(d, self.frame_id)
                refind.append(t)

        # stage 2: low-conf vs remaining tracked
        r_tracked = [pool[i] for i in u_track if pool[i].state == TrackState.Tracked]
        dists = iou_distance(r_tracked, det_low)
        matches, u_track2, _ = linear_assignment(dists, 0.5)
        for it, idet in matches:
            t, d = r_tracked[it], det_low[idet]
            if t.state == TrackState.Tracked:
                t.update(d, self.frame_id)
                activated.append(t)
            else:
                t.re_activate(d, self.frame_id)
                refind.append(t)
        for i in u_track2:
            t = r_tracked[i]
            if t.state != TrackState.Lost:
                t.mark_lost()
                lost.append(t)

        # unconfirmed tracks get one shot at remaining high-conf dets
        det_left = [det_high[i] for i in u_det]
        dists = iou_distance(unconfirmed, det_left)
        if self.fuse:
            dists = fuse_score(dists, det_left)
        matches, u_unconf, u_det2 = linear_assignment(dists, 0.7)
        for it, idet in matches:
            unconfirmed[it].update(det_left[idet], self.frame_id)
            activated.append(unconfirmed[it])
        for i in u_unconf:
            unconfirmed[i].mark_removed()
            removed.append(unconfirmed[i])

        # new tracks
        for i in u_det2:
            d = det_left[i]
            if d.score >= self.new_track_thresh:
                d.activate(self.kalman_filter, self.frame_id)
                activated.append(d)

        # expire lost
        for t in self.lost_stracks:
            if self.frame_id - t.frame_id > self.max_time_lost:
                t.mark_removed()
                removed.append(t)

        self.tracked_stracks = [t for t in self.tracked_stracks if t.state == TrackState.Tracked]
        self.tracked_stracks = joint_stracks(self.tracked_stracks, activated)
        self.tracked_stracks = joint_stracks(self.tracked_stracks, refind)
        self.lost_stracks = sub_stracks(self.lost_stracks, self.tracked_stracks)
        self.lost_stracks.extend(lost)
        # subtract the cumulative removed list (this frame's removals prune the next
        # frame), drop tracked-vs-lost duplicates keeping the older track, then
        # extend and cap the removals
        self.lost_stracks = sub_stracks(self.lost_stracks, self.removed_stracks)
        self.tracked_stracks, self.lost_stracks = remove_duplicate_stracks(
            self.tracked_stracks, self.lost_stracks)
        self.removed_stracks.extend(removed)
        if len(self.removed_stracks) > 1000:
            self.removed_stracks = self.removed_stracks[-999:]

        out = [np.concatenate([t.xyxy, [t.score, t.cls, t.track_id]])
               for t in self.tracked_stracks if t.is_activated]
        return np.asarray(out).reshape(-1, 7)

    def get_dists(self, tracks, detections):
        dists = iou_distance(tracks, detections)
        if self.fuse:
            dists = fuse_score(dists, detections)
        return dists


def joint_stracks(a, b):
    seen = {t.track_id for t in a}
    return a + [t for t in b if t.track_id not in seen]


def sub_stracks(a, b):
    ids = {t.track_id for t in b}
    return [t for t in a if t.track_id not in ids]


def remove_duplicate_stracks(a, b):
    """Drop tracks that overlap a track in the other list at IoU > 0.85, keeping
    whichever has the longer history."""
    pdist = iou_distance(a, b)
    dup_a, dup_b = set(), set()
    for p, q in zip(*np.where(pdist < 0.15)):
        time_a = a[p].frame_id - a[p].start_frame
        time_b = b[q].frame_id - b[q].start_frame
        if time_a > time_b:
            dup_b.add(q)
        else:
            dup_a.add(p)
    return ([t for i, t in enumerate(a) if i not in dup_a],
            [t for i, t in enumerate(b) if i not in dup_b])
