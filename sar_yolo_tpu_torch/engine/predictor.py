"""Batched serving: uint8 frames -> letterbox -> forward -> decode -> NMS on the device
(port of the batched path of `sar_yolo_tpu/engine/predictor.py`)."""

from __future__ import annotations

import numpy as np
import torch

from sar_yolo_tpu_torch.engine.results import Results
from sar_yolo_tpu_torch.ops.decode import decode_detect
from sar_yolo_tpu_torch.ops.nms import non_max_suppression
from sar_yolo_tpu_torch.ops.preprocess import letterbox_device


class BasePredictor:
    """Serves a (fused) model on its device; `args` holds imgsz, conf (None: 0.25), iou,
    max_det, agnostic_nms."""

    def __init__(self, model, meta: dict, args, names=None):
        self.model = model
        self.meta = meta
        self.args = args
        self.names = names or {i: str(i) for i in range(meta["nc"])}
        self.imgsz = args.imgsz
        self.device = next(model.parameters()).device

    def _dets_in_orig_coords(self, x, r: float, pad):
        """Normalized letterboxed NCHW batch -> decode -> NMS -> boxes in original pixels."""
        meta, args = self.meta, self.args
        nc = meta["nc"]
        feats = self.model(x)
        # JDE: the wide raw embedding channels stay out of the (B, N)-sized
        # decode/NMS work; they are gathered per kept detection after NMS
        emb_dim = meta.get("embed_dim") or 0
        preds = decode_detect(feats, meta["strides"], nc, meta["reg_max"],
                              extra_sigmoid=meta.get("state_classes") or 0,
                              split_extras=emb_dim)
        bank = None
        if emb_dim:
            preds, bank = preds
        conf = args.conf if args.conf is not None else 0.25
        dets = non_max_suppression(preds, conf_thres=conf, iou_thres=args.iou,
                                   max_det=args.max_det, nc=nc, agnostic=args.agnostic_nms,
                                   extras_bank=bank)
        pad4 = torch.tensor([*pad, *pad], dtype=dets.dtype, device=dets.device)
        return torch.cat([(dets[..., :4] - pad4) / r, dets[..., 4:]], -1)

    def preprocess(self, frames_u8):
        """(B, H, W, 3) uint8 BGR -> (normalized letterboxed RGB NCHW batch on the device, r, pad)."""
        frames = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(self.device)
        x, r, pad = letterbox_device(frames.flip(-1), self.imgsz, scaleup=False)
        return x.permute(0, 3, 1, 2).contiguous() / 255.0, r, pad

    @torch.no_grad()
    def predict_batch(self, frames_u8) -> np.ndarray:
        """Serve a (B, H, W, 3) uint8 BGR batch; returns (B, max_det, 6 + E) detections
        in original-image pixels (rows with conf == 0 are padding)."""
        return self._dets_in_orig_coords(*self.preprocess(frames_u8)).cpu().numpy()


class JDEPredictor(BasePredictor):
    """Splits [box, conf, cls, emb, state] and exposes embeddings and the argmax state."""

    def postprocess(self, dets, path, orig_img, speed=None) -> Results:
        d = np.asarray(dets[0])
        d = d[d[:, 4] > 0]
        h, w = orig_img.shape[:2]
        d[:, [0, 2]] = d[:, [0, 2]].clip(0, w)
        d[:, [1, 3]] = d[:, [1, 3]].clip(0, h)
        ed = self.meta["embed_dim"]
        sc = self.meta.get("state_classes") or 0
        embeds = d[:, 6:6 + ed]
        states = d[:, 6 + ed:6 + ed + sc].argmax(-1) if sc else None
        return Results(orig_img, path, self.names, boxes=d[:, :6], embeds=embeds,
                       person_states=states, speed=speed)
