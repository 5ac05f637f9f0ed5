"""Global motion compensation for BoT-SORT: the camera's motion between two frames as a
2x3 similarity (port of `sar_yolo_tpu/trackers/gmc.py`). Host numpy, as the JAX
package's is host OpenCV: the frame is turned grey, halved, and `sparseOptFlow` tracks
the previous frame's corners into it with pyramidal Lucas-Kanade, then fits the warp by
RANSAC (`trackers/gmc_cv.py`, OpenCV's arithmetic).

`orb`, `sift` and `ecc` raise NotImplementedError (ROADMAP Queue A item 1). The JAX
package swallows `cv2.error` and returns the identity; the one such error this method
meets is two frames of different sizes (calcOpticalFlowPyrLK's assertion), which gives
the identity here too.
"""

from __future__ import annotations

import numpy as np

from sar_yolo_tpu_torch.data.cv import resize
from . import gmc_cv

PORTED = ("sparseOptFlow", "none", None)


class GMC:
    def __init__(self, method: str | None = "sparseOptFlow", downscale: int = 2):
        if method not in PORTED:
            raise NotImplementedError(
                f"GMC method '{method}' is not part of this port yet (ROADMAP Queue A item "
                "1: orb, sift and ecc); use sparseOptFlow or none")
        self.method = method
        self.downscale = max(1, downscale)
        self.prev_frame = None
        self.initialized = False

    def apply(self, frame: np.ndarray) -> np.ndarray:
        """The 2x3 float64 warp from the previous frame to this one (the identity on the
        first frame)."""
        if self.method in {"none", None}:
            return np.eye(2, 3)
        gray = gmc_cv.bgr2gray(frame) if frame.ndim == 3 else frame
        if self.downscale > 1:
            gray = resize(gray, (gray.shape[1] // self.downscale,
                                 gray.shape[0] // self.downscale))
        H = np.eye(2, 3)
        if not self.initialized:
            self.prev_frame = gray.copy()
            self.initialized = True
            return H
        if gray.shape == self.prev_frame.shape:
            p0 = gmc_cv.good_features_to_track(self.prev_frame)
            if p0 is not None and len(p0) >= 4:
                p1, st = gmc_cv.calc_optical_flow_pyr_lk(self.prev_frame, gray, p0)
                keep = st.ravel() == 1
                if keep.sum() >= 4:
                    M = gmc_cv.estimate_affine_partial_2d(p0[keep], p1[keep])
                    if M is not None:
                        H = M
        self.prev_frame = gray.copy()
        if self.downscale > 1:
            H = H.copy()
            H[:, 2] *= self.downscale
        return H
