"""Train augmentation on the device: mosaic4, scale/translate affine, HSV, flips and mixup
on the uint8 batch, inside the train step (port of `sar_yolo_tpu/data/device_augment.py`).

The host only decodes and letterboxes (`YOLODataset(device_augment=True)`); this
module does the rest with torch ops on the batch's device. Mosaic placement and the
affine warp are two batched products per tile (out = Wy @ tile @ Wx^T): Wy and Wx are
per-sample bilinear weight matrices, two nonzeros a row, with the mosaic quadrant
masks folded in; the gray 114 fill is 1 - coverage. Labels are moved, clipped,
filtered as the reference's box_candidates, and compacted to the first rows.

The random draws come in as an argument (`AugParams`): `draw_params` makes them on
the host from a numpy generator with the JAX package's distributions (it does not
reproduce JAX's threefry stream), and tests can hand in JAX's own draws. The
semantics, including the deviations from the host path that the JAX module lists
(no rotation, shear or perspective; float HSV; mosaic seams blend with gray), are
the JAX package's. Pose keypoints move with the boxes, lose their visibility outside
the canvas, and a horizontal flip permutes them by `hyp["flip_idx"]`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

GRAY = 114.0
AUG_KEYS = ("scale", "translate", "fliplr", "flipud", "hsv_h", "hsv_s", "hsv_v", "mixup")


class AugParams(NamedTuple):
    """Random draws for one batch; shapes (B,) unless noted."""
    sel: torch.Tensor        # (B, 3) int64 partner indices of mosaic tiles 1..3
    yc: torch.Tensor         # mosaic centre rows in the 2S canvas
    xc: torch.Tensor         # mosaic centre cols
    scale: torch.Tensor      # affine scale
    ty: torch.Tensor         # affine translation (output px)
    tx: torch.Tensor
    fliplr: torch.Tensor     # bool
    flipud: torch.Tensor     # bool
    hsv_gains: torch.Tensor  # (B, 3) multiplicative h, s, v gains
    mix: torch.Tensor        # bool: blend with the span-rolled partner (mixup)
    mix_r: torch.Tensor      # Beta(32, 32) blend ratio
    shuf_u: torch.Tensor     # (B, P) uniforms ordering the label slots before the cut

    def to(self, device) -> "AugParams":
        return AugParams(*(t.to(device, non_blocking=True) for t in self))


def label_slots(M: int, hyp: dict, mosaic: bool) -> int:
    """P, the label slots of a sample before the cut: M per tile, doubled by mixup."""
    return (4 if mosaic else 1) * M * (2 if mosaic and float(hyp.get("mixup", 0.0)) > 0 else 1)


def draw_params(rng: np.random.Generator, B: int, S: int, hyp: dict, mosaic: bool,
                partner_span: int | None = None, M: int = 0) -> AugParams:
    """Every random draw of a batch of B tiles of side S with M label rows each (CPU tensors).

    hyp keys: scale, translate, fliplr, flipud, hsv_h, hsv_s, hsv_v, mixup (the JAX
    package's distributions). Mosaic partners stay within contiguous groups of
    `partner_span` samples (default B).
    """
    span = int(partner_span or B)
    i = np.arange(B)[:, None]
    base = (i // span) * span
    sel = base + (i - base + rng.integers(0, span, (B, 3))) % span
    c = rng.uniform(0.5 * S, 1.5 * S, (B, 2)) if mosaic else np.full((B, 2), 0.5 * S)
    sc, tr = float(hyp.get("scale", 0.5)), float(hyp.get("translate", 0.1))
    scale = rng.uniform(1.0 - sc, 1.0 + sc, B)
    t = rng.uniform(0.5 - tr, 0.5 + tr, (B, 2)) * S
    u = rng.random((B, 2))
    g = rng.uniform(-1.0, 1.0, (B, 3))
    gains = 1.0 + g * np.array([float(hyp.get(k, d)) for k, d in
                                (("hsv_h", 0.015), ("hsv_s", 0.7), ("hsv_v", 0.4))])
    mix = rng.random(B) < (float(hyp.get("mixup", 0.0)) if mosaic else 0.0)
    mix_r = rng.beta(32.0, 32.0, B)
    shuf_u = rng.random((B, label_slots(M, hyp, mosaic)))
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    return AugParams(torch.from_numpy(sel.astype(np.int64)), f32(c[:, 0]), f32(c[:, 1]),
                     f32(scale), f32(t[:, 0]), f32(t[:, 1]),
                     torch.from_numpy(u[:, 0] < float(hyp.get("fliplr", 0.5))),
                     torch.from_numpy(u[:, 1] < float(hyp.get("flipud", 0.0))),
                     f32(gains), torch.from_numpy(mix), f32(mix_r), f32(shuf_u))


def _axis_weights(pos: torch.Tensor, S: int, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(B, S_out, S) bilinear weights sampling tile coordinates `pos` (B, S_out), rows
    zeroed where pos lies outside [lo, hi): w[b, i, j] = max(0, 1 - |pos[b, i] - j|)."""
    j = torch.arange(S, dtype=pos.dtype, device=pos.device)
    w = torch.clamp(1.0 - (pos[:, :, None] - j).abs(), min=0.0)
    valid = (pos >= lo[:, None]) & (pos < hi[:, None])
    return w * valid[:, :, None]


def _hsv_jitter(x: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Float RGB in [0, 1] -> HSV scaled by per-image gains (B, 3) -> RGB."""
    mx, mn = x.amax(-1), x.amin(-1)
    diff = mx - mn + 1e-12
    r, g, b = x.unbind(-1)
    h = torch.where(mx == r, torch.remainder((g - b) / diff, 6.0),
                    torch.where(mx == g, (b - r) / diff + 2.0, (r - g) / diff + 4.0)) / 6.0
    s = torch.where(mx > 0, diff / (mx + 1e-12), 0.0)
    h = torch.remainder(h * gains[:, None, None, 0], 1.0)
    s = torch.clamp(s * gains[:, None, None, 1], 0, 1)
    v = torch.clamp(mx * gains[:, None, None, 2], 0, 1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):  # the branch of sextant i, as jnp.select
        out = vals[-1]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out
    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], -1)


def device_train_augment(batch: dict, params: AugParams, hyp: dict, *, mosaic: bool = True,
                         max_labels: int | None = None, partner_span: int | None = None,
                         dtype=torch.float32) -> dict:
    """Augment a batch of device tensors with the draws `params` (on the same device).

    batch: img (B, S, S, 3) uint8 letterboxed tiles; cls, mask, tags (B, M); bboxes
    (B, M, 4) normalized xywh; keypoints (B, M, K, D) normalized (pose). Returns the same keys with img `dtype` RGB in [0, 1]
    (B, S, S, 3) and the labels moved; the label count becomes max_labels (default
    M): where more survive, a random subset (ordered by params.shuf_u) is kept.
    Runs no host synchronization. As in the JAX package, the warp (tiles, weights,
    products, grey fill, mixup) runs in `dtype` and the HSV jitter in float32.
    """
    p = params
    img = batch["img"]
    B, S = img.shape[0], img.shape[1]
    M = batch["bboxes"].shape[1]
    Mout = max_labels or M
    dev = img.device
    ar = torch.arange(B, device=dev)
    idx = torch.cat([ar[:, None], p.sel], 1) if mosaic else ar[:, None]  # (B, T)
    T = idx.shape[1]
    tiles = img[idx].to(dtype)                                           # (B, T, S, S, 3)
    cls_t, box_t, msk_t = batch["cls"][idx], batch["bboxes"][idx], batch["mask"][idx]
    tag_t = batch["tags"][idx] if "tags" in batch else None
    kpt_t = batch["keypoints"][idx] if "keypoints" in batch else None

    # affine sampling grid: canvas -> output is y' = s (u - C) + t
    C = float(S) if mosaic else 0.5 * S
    yo = torch.arange(S, dtype=torch.float32, device=dev)
    u_y = (yo[None, :] - p.ty[:, None]) / p.scale[:, None] + C        # (B, S) canvas rows
    u_x = (yo[None, :] - p.tx[:, None]) / p.scale[:, None] + C
    if mosaic:
        # tile k's offset in the canvas: rows {yc - S, yc}, cols {xc - S, xc}; each
        # quadrant's bounds are expressed on tile-local coordinates pos = u - offset
        oy = torch.stack([p.yc - S, p.yc - S, p.yc, p.yc], 1)            # (B, 4)
        ox = torch.stack([p.xc - S, p.xc, p.xc - S, p.xc], 1)
        zero, full = torch.zeros_like(p.yc), torch.full_like(p.yc, float(S))
        Wy = torch.stack([
            _axis_weights(u_y - oy[:, 0:1], S, torch.clamp(-(p.yc - S), min=0.0), full),
            _axis_weights(u_y - oy[:, 2:3], S, zero, torch.clamp(2 * S - p.yc, max=S)),
        ], 1)                                                            # (B, 2, S, S) top, bottom
        Wx = torch.stack([
            _axis_weights(u_x - ox[:, 0:1], S, torch.clamp(-(p.xc - S), min=0.0), full),
            _axis_weights(u_x - ox[:, 1:2], S, zero, torch.clamp(2 * S - p.xc, max=S)),
        ], 1)                                                            # (B, 2, S, S) left, right
        Wy4, Wx4 = Wy[:, [0, 0, 1, 1]], Wx[:, [0, 1, 0, 1]]              # (B, 4, S, S)
        Wy4, Wx4 = Wy4.to(dtype), Wx4.to(dtype)
    else:
        oy = ox = torch.zeros(B, 1, device=dev)
        lo, hi = torch.full((B,), -1e9, device=dev), torch.full((B,), 1e9, device=dev)
        Wy4 = _axis_weights(u_y, S, lo, hi)[:, None].to(dtype)
        Wx4 = _axis_weights(u_x, S, lo, hi)[:, None].to(dtype)

    # warp and composite: two batched products, then the gray where nothing was sampled
    t = torch.einsum("bkij,bkjwc->bkiwc", Wy4, tiles)                   # rows resampled
    out = torch.einsum("bkxw,bkiwc->bixc", Wx4, t)                      # cols, sum over tiles
    del t, tiles
    cov = torch.einsum("bki,bkx->bix", Wy4.sum(-1), Wx4.sum(-1))
    out = out + GRAY * torch.clamp(1.0 - cov, min=0.0)[..., None]

    # labels: tile-normalized xywh -> canvas px -> output px, clipped, then filtered as
    # the reference's box_candidates (2 px, aspect < 100, area ratio > 0.1)
    cxy = box_t[..., :2] * S + torch.stack([ox, oy], -1)[:, :, None, :]  # (B, T, M, 2)
    wh0 = box_t[..., 2:] * S
    sca = p.scale[:, None, None, None]
    toff = torch.stack([p.tx, p.ty], -1)[:, None, None, :]
    x1y1 = torch.clamp(sca * (cxy - wh0 / 2 - C) + toff, 0, S)
    x2y2 = torch.clamp(sca * (cxy + wh0 / 2 - C) + toff, 0, S)
    wh2 = x2y2 - x1y1
    wh1 = wh0 * sca
    aspect = torch.maximum(wh2[..., 0] / (wh2[..., 1] + 1e-16), wh2[..., 1] / (wh2[..., 0] + 1e-16))
    keep = ((wh2 > 2).all(-1) & (aspect < 100) &
            (wh2[..., 0] * wh2[..., 1] / (wh1[..., 0] * wh1[..., 1] + 1e-16) > 0.1))
    valid = (msk_t > 0) & keep
    pool = {"bboxes": (torch.cat([(x1y1 + x2y2) / 2, wh2], -1) / S).reshape(B, T * M, 4),
            "cls": cls_t.reshape(B, T * M),
            "mask": valid.reshape(B, T * M).to(batch["mask"].dtype)}
    if tag_t is not None:
        pool["tags"] = tag_t.reshape(B, T * M)
    if kpt_t is not None:  # (B, T, M, K, D): as the boxes, visibility 0 off the canvas
        kxy = kpt_t[..., :2] * S + torch.stack([ox, oy], -1)[:, :, None, None, :]
        kxy = sca[..., None] * (kxy - C) + toff[..., None, :]
        parts = [kxy / S]
        if kpt_t.shape[-1] == 3:
            inside = ((kxy >= 0) & (kxy <= S)).all(-1)
            parts.append(torch.where(inside, kpt_t[..., 2], 0.0)[..., None])
        kk = torch.cat(parts, -1)
        pool["keypoints"] = kk.reshape(B, T * M, *kk.shape[3:])

    # mixup (reference MixUp): blend with the partner one place on within the span
    if mosaic and float(hyp.get("mixup", 0.0)) > 0:
        r = torch.where(p.mix, p.mix_r, 1.0).to(dtype)[:, None, None, None]
        span = int(partner_span or B)
        ridx = (ar // span) * span + (ar + 1) % span
        out = out * r + out[ridx] * (1.0 - r)
        rolled = {k: v[ridx] for k, v in pool.items()}
        rolled["mask"] = rolled["mask"] * p.mix[:, None]
        pool = {k: torch.cat([pool[k], rolled[k]], 1) for k in pool}

    # compact the valid labels into the first Mout slots; a random order first where
    # the cut can drop some, so that it does not always favour the sample's own tile
    P = pool["mask"].shape[1]

    def take(order):
        return {k: torch.gather(v, 1, order.reshape(B, -1, *([1] * (v.ndim - 2))).expand(
            -1, -1, *v.shape[2:])) for k, v in pool.items()}
    if P > Mout:
        pool = take(torch.argsort(p.shuf_u, dim=1))
    comp = take(torch.argsort((pool["mask"] <= 0).to(torch.uint8), dim=1, stable=True)[:, :min(Mout, P)])
    if Mout > P:
        comp = {k: torch.nn.functional.pad(v, [0, 0] * (v.ndim - 2) + [0, Mout - P])
                for k, v in comp.items()}

    # flips
    out = torch.where(p.fliplr[:, None, None, None], out.flip(2), out)
    out = torch.where(p.flipud[:, None, None, None], out.flip(1), out)
    bx = comp["bboxes"]
    comp["bboxes"] = torch.stack([torch.where(p.fliplr[:, None], 1.0 - bx[..., 0], bx[..., 0]),
                                  torch.where(p.flipud[:, None], 1.0 - bx[..., 1], bx[..., 1]),
                                  bx[..., 2], bx[..., 3]], -1)
    if "keypoints" in comp:
        kk, fl = comp["keypoints"], p.fliplr[:, None, None, None]
        kk = torch.cat([torch.where(fl, 1.0 - kk[..., :1], kk[..., :1]),
                        torch.where(p.flipud[:, None, None, None], 1.0 - kk[..., 1:2], kk[..., 1:2]),
                        kk[..., 2:]], -1)
        if hyp.get("flip_idx") is not None:
            kk = torch.where(fl, kk[:, :, list(hyp["flip_idx"])], kk)
        comp["keypoints"] = kk

    # HSV and normalization
    x01 = torch.clamp(out.float() / 255.0, 0.0, 1.0)
    if any(float(hyp.get(k, 0.0)) for k in ("hsv_h", "hsv_s", "hsv_v")):
        x01 = _hsv_jitter(x01, p.hsv_gains)
    return {**batch, "img": x01.to(dtype), **comp}
