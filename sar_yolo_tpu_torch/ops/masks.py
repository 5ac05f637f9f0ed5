"""Instance masks from prototypes (port of `sar_yolo_tpu/ops/masks.py`: `crop_mask`,
`process_mask`). Torch ops on the device, batched over any leading dims: the mask
product is one einsum, as in the JAX package (no kernel of its own there either)."""

from __future__ import annotations

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
