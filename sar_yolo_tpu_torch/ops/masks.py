"""Instance masks from prototypes (port of `sar_yolo_tpu/ops/masks.py`: `crop_mask`,
`process_mask`). Torch ops on the device, batched over any leading dims: the mask
product is one einsum, as in the JAX package (no kernel of its own there either).
`resize_weights` / `resize_linear`: `jax.image.resize(..., "linear")` as dense
interpolation matrices, antialiased when shrinking (SAM's masks, tables and embeddings)."""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F


def crop_mask(masks, boxes):
    """Zero mask values outside boxes: masks (..., n, H, W), boxes (..., n, 4) xyxy in mask
    pixels; a pixel (r, c) stays where x1 <= c < x2 and y1 <= r < y2."""
    H, W = masks.shape[-2:]
    x1, y1, x2, y2 = boxes[..., None, None].unbind(-3)  # each (..., n, 1, 1)
    c = torch.arange(W, dtype=torch.float32, device=masks.device)[None, :]
    r = torch.arange(H, dtype=torch.float32, device=masks.device)[:, None]
    return masks * ((c >= x1) & (c < x2) & (r >= y1) & (r < y2))


def process_mask(protos, coeffs, boxes, img_hw, upsample: bool = False):
    """Boolean instance masks of detections: sigmoid(coeffs @ protos), cropped to the boxes
    (xyxy in input pixels of the network input `img_hw`), > 0.5.

    protos (..., nm, mh, mw); coeffs (..., n, nm); boxes (..., n, 4). Returns (..., n, mh,
    mw), or (..., n, H, W) with `upsample` (a bilinear resize of the cropped probabilities
    with half-pixel centres, `jax.image.resize`'s rule when enlarging). Computed in float32.
    """
    mh, mw = protos.shape[-2:]
    H, W = img_hw
    masks = torch.einsum("...nc,...chw->...nhw", coeffs.float(), protos.float()).sigmoid()
    scale = torch.tensor([mw / W, mh / H, mw / W, mh / H], dtype=torch.float32,
                         device=masks.device)
    masks = crop_mask(masks, boxes.float() * scale)
    if upsample:
        lead = masks.shape[:-2]
        masks = F.interpolate(masks.reshape(-1, 1, mh, mw), size=(H, W), mode="bilinear",
                              align_corners=False).reshape(*lead, H, W)
    return masks > 0.5


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of `jax.image.resize(..., "linear")` along one axis, in
    JAX's float32 arithmetic (`jax._src.image.scale.compute_weight_mat`): half-pixel centres,
    the triangle kernel stretched by n_in / n_out when shrinking (JAX's antialias), each
    output's weights divided by their sum, outputs whose sample falls outside the input
    zeroed. An axis that keeps its size is the identity, as JAX skips it."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / max(inv_scale, f32(1))
    w = np.maximum(f32(0), f32(1) - x)
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= f32(-0.5)) & (sample <= f32(n_in - 0.5))
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def resize_linear(x, size, dims=(-2, -1)):
    """`jax.image.resize(x, ..., "linear")` of torch tensor `x` to `size` along `dims` (the
    other axes keep theirs): one dense product per axis, in x's dtype, on x's device."""
    for d, n in zip(dims, size):
        n_in = x.shape[d]
        if n_in == n:
            continue
        w = torch.as_tensor(resize_weights(n_in, n), dtype=x.dtype, device=x.device)
        x = torch.tensordot(x.movedim(d, -1), w, dims=1).movedim(-1, d)
    return x
