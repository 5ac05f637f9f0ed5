"""Letterbox on the device (port of `sar_yolo_tpu/ops/preprocess.py::letterbox_device`).

The resize is cv2's INTER_LINEAR map (no antialiasing on downscale), built as
two dense 2-tap weight matrices from float64 coordinates and applied as two
matmuls; `F.interpolate` is not the same map.
"""

from __future__ import annotations

import numpy as np
import torch


def _resize_weights(n_out: int, n_in: int) -> np.ndarray:
    """Dense (n_out, n_in) 2-tap bilinear weight matrix, cv2 coordinate map."""
    x = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    x = np.clip(x, 0.0, n_in - 1.0)
    lo = np.floor(x).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    f = (x - lo).astype(np.float32)
    w = np.zeros((n_out, n_in), np.float32)
    w[np.arange(n_out), lo] += 1.0 - f
    w[np.arange(n_out), hi] += f
    return w


def letterbox_params(h: int, w: int, imgsz: int, scaleup: bool = True):
    """(r, (new_h, new_w), (left, top)) of the letterbox of an h x w image into imgsz.

    new_h/new_w use Python's round() (round half to even), as the JAX package does.
    """
    r = min(imgsz / h, imgsz / w)
    if not scaleup:
        r = min(r, 1.0)
    new_h, new_w = round(h * r), round(w * r)
    return r, (new_h, new_w), ((imgsz - new_w) // 2, (imgsz - new_h) // 2)


def letterbox_device(img, imgsz: int, pad_value: int = 114, scaleup: bool = True,
                     dtype=torch.float32):
    """Letterbox uint8 (..., H, W, 3) image(s) to (..., imgsz, imgsz, 3) on img's device.

    Returns (out, r, (left, top)); out is `dtype` in the 0..255 range. When the
    image already fits (r leaves H, W unchanged) the resize is skipped and the
    pad happens in uint8, with one cast at the end.
    """
    H, W = img.shape[-3:-1]
    r, (new_h, new_w), (left, top) = letterbox_params(H, W, imgsz, scaleup)
    lead = img.shape[:-3]
    if (new_h, new_w) == (H, W):
        out = torch.full((*lead, imgsz, imgsz, 3), pad_value, dtype=img.dtype, device=img.device)
        out[..., top:top + H, left:left + W, :] = img
        return out.to(dtype), r, (left, top)
    wh = torch.from_numpy(_resize_weights(new_h, H)).to(img.device, dtype)
    ww = torch.from_numpy(_resize_weights(new_w, W)).to(img.device, dtype)
    t = torch.einsum("hH,...HWc->...hWc", wh, img.to(dtype))
    resized = torch.einsum("wW,...hWc->...hwc", ww, t)
    out = torch.full((*lead, imgsz, imgsz, 3), float(pad_value), dtype=dtype, device=img.device)
    out[..., top:top + new_h, left:left + new_w, :] = resized
    return out, r, (left, top)
