"""Association costs and linear assignment of the trackers (port of
`sar_yolo_tpu/trackers/matching.py`; Hungarian assignment by scipy)."""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

from sar_yolo_tpu_torch.utils.metrics import box_iou_np


def iou_distance(atracks, btracks) -> np.ndarray:
    """1 - IoU between two track/box lists (xyxy)."""
    a = np.asarray([t.xyxy for t in atracks]) if len(atracks) else np.zeros((0, 4))
    b = np.asarray([t.xyxy for t in btracks]) if len(btracks) else np.zeros((0, 4))
    if len(a) == 0 or len(b) == 0:
        return np.ones((len(a), len(b)), np.float32)
    return 1.0 - box_iou_np(a, b).astype(np.float32)


def embedding_distance(tracks, detections) -> np.ndarray:
    """Cosine distance between track smooth features and detection embeddings."""
    if len(tracks) == 0 or len(detections) == 0:
        return np.ones((len(tracks), len(detections)), np.float32)
    tf = np.stack([t.smooth_feat for t in tracks])
    df = np.stack([d.curr_feat for d in detections])
    tf = tf / (np.linalg.norm(tf, axis=1, keepdims=True) + 1e-9)
    df = df / (np.linalg.norm(df, axis=1, keepdims=True) + 1e-9)
    return np.maximum(0.0, 1.0 - tf @ df.T).astype(np.float32)


def fuse_score(cost_matrix, detections) -> np.ndarray:
    """Fuse detection confidence into the IoU cost (reference matching.py fuse_score)."""
    if cost_matrix.size == 0:
        return cost_matrix
    iou_sim = 1 - cost_matrix
    det_scores = np.array([d.score for d in detections])
    fused = iou_sim * det_scores[None, :]
    return 1 - fused


def linear_assignment(cost_matrix: np.ndarray, thresh: float):
    """Hungarian assignment with cost gating. Returns (matches, unmatched_a, unmatched_b)."""
    if cost_matrix.size == 0:
        return (np.empty((0, 2), int), tuple(range(cost_matrix.shape[0])),
                tuple(range(cost_matrix.shape[1])))
    cost = cost_matrix.copy()
    cost[cost > thresh] = thresh + 1e-4
    rows, cols = linear_sum_assignment(cost)
    matches = [[r, c] for r, c in zip(rows, cols) if cost_matrix[r, c] <= thresh]
    matched_a = {m[0] for m in matches}
    matched_b = {m[1] for m in matches}
    unmatched_a = tuple(i for i in range(cost_matrix.shape[0]) if i not in matched_a)
    unmatched_b = tuple(i for i in range(cost_matrix.shape[1]) if i not in matched_b)
    return np.asarray(matches, int).reshape(-1, 2), unmatched_a, unmatched_b
