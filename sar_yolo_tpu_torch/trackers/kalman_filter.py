"""Constant-velocity Kalman filters of the trackers (port of
`sar_yolo_tpu/trackers/kalman_filter.py`): KalmanFilterXYAH for ByteTrack and
KalmanFilterXYWH for BoT-SORT. Host numpy: tracking is sequential per-frame logic.
"""

from __future__ import annotations

import numpy as np


class KalmanFilterXYAH:
    """State: [x, y, a, h, vx, vy, va, vh] — center, aspect ratio, height."""

    ndim = 4

    def __init__(self):
        dt = 1.0
        self._motion_mat = np.eye(8)
        for i in range(4):
            self._motion_mat[i, 4 + i] = dt
        self._update_mat = np.eye(4, 8)
        self._std_weight_position = 1.0 / 20
        self._std_weight_velocity = 1.0 / 160

    def initiate(self, measurement):
        mean = np.zeros(8)
        mean[:4] = measurement
        h = measurement[3]
        std = [2 * self._std_weight_position * h, 2 * self._std_weight_position * h,
               1e-2, 2 * self._std_weight_position * h,
               10 * self._std_weight_velocity * h, 10 * self._std_weight_velocity * h,
               1e-5, 10 * self._std_weight_velocity * h]
        covariance = np.diag(np.square(std))
        return mean, covariance

    def predict(self, mean, covariance):
        h = mean[3]
        std_pos = [self._std_weight_position * h] * 2 + [1e-2, self._std_weight_position * h]
        std_vel = [self._std_weight_velocity * h] * 2 + [1e-5, self._std_weight_velocity * h]
        motion_cov = np.diag(np.square(np.r_[std_pos, std_vel]))
        mean = self._motion_mat @ mean
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + motion_cov
        return mean, covariance

    def project(self, mean, covariance):
        h = mean[3]
        std = [self._std_weight_position * h] * 2 + [1e-1, self._std_weight_position * h]
        innovation_cov = np.diag(np.square(std))
        mean_p = self._update_mat @ mean
        cov_p = self._update_mat @ covariance @ self._update_mat.T
        return mean_p, cov_p + innovation_cov

    def update(self, mean, covariance, measurement):
        proj_mean, proj_cov = self.project(mean, covariance)
        chol = np.linalg.cholesky(proj_cov)
        kalman_gain = np.linalg.solve(
            chol.T, np.linalg.solve(chol, (covariance @ self._update_mat.T).T)).T
        innovation = measurement - proj_mean
        new_mean = mean + kalman_gain @ innovation
        new_cov = covariance - kalman_gain @ proj_cov @ kalman_gain.T
        return new_mean, new_cov


class KalmanFilterXYWH(KalmanFilterXYAH):
    """State: [x, y, w, h, ...] — BoT-SORT variant (w instead of aspect)."""

    def initiate(self, measurement):
        mean = np.zeros(8)
        mean[:4] = measurement
        w, h = measurement[2], measurement[3]
        std = [2 * self._std_weight_position * w, 2 * self._std_weight_position * h,
               2 * self._std_weight_position * w, 2 * self._std_weight_position * h,
               10 * self._std_weight_velocity * w, 10 * self._std_weight_velocity * h,
               10 * self._std_weight_velocity * w, 10 * self._std_weight_velocity * h]
        return mean, np.diag(np.square(std))

    def predict(self, mean, covariance):
        w, h = mean[2], mean[3]
        std_pos = [self._std_weight_position * w, self._std_weight_position * h,
                   self._std_weight_position * w, self._std_weight_position * h]
        std_vel = [self._std_weight_velocity * w, self._std_weight_velocity * h,
                   self._std_weight_velocity * w, self._std_weight_velocity * h]
        motion_cov = np.diag(np.square(np.r_[std_pos, std_vel]))
        mean = self._motion_mat @ mean
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + motion_cov
        return mean, covariance

    def project(self, mean, covariance):
        w, h = mean[2], mean[3]
        std = [self._std_weight_position * w, self._std_weight_position * h,
               self._std_weight_position * w, self._std_weight_position * h]
        innovation_cov = np.diag(np.square(std))
        mean_p = self._update_mat @ mean
        cov_p = self._update_mat @ covariance @ self._update_mat.T
        return mean_p, cov_p + innovation_cov
