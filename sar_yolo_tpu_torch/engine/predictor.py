"""Serving on the device (port of `sar_yolo_tpu/engine/predictor.py`): uint8 frames ->
letterbox -> forward -> decode -> NMS (for a v10 head the NMS-free top-k,
`postprocess_end2end`) -> boxes in the frame's pixels, ending in one copy to the host
(a segment model: two, the rows and the boolean masks).

Pose rows carry the keypoints, un-letterboxed like the boxes (the boxes are clipped to
the frame in Results, the keypoints not). Segment rows are [box, conf, cls]; their masks
(B, max_det, mh, mw) stay at the prototypes' resolution in the letterboxed input's frame
(`process_mask` over the square (imgsz, imgsz) input), as the JAX package returns them.
OBB rows are [cx, cy, w, h, r, conf, cls]: the centres un-letterboxed, w and h over the
ratio, the angle as it is, nothing clipped. A classify model returns the softmax of its
logits over the letterboxed frame, (B, nc) float32. RT-DETR (`RTDETRPredictor`) takes the
last decoder layer's nq queries as they come: sigmoid, best class, the boxes
un-letterboxed, rows under conf zeroed, no NMS: (B, nq, 6). Like the JAX package it
letterboxes with padding, where Ultralytics' RT-DETR predictor stretches the frame.

Under `half` the letterboxed frame enters the model in bf16 and the head maps come out
in bf16; decode and NMS then run in the dtypes the JAX predictor gives them (boxes in
float32, class scores sigmoided in bf16, the rows promoted to float32).

Two routes share that tail (`_dets_in_orig_coords`): `predict_batch` serves a uniform
(B, H, W, 3) batch (split over a mesh of devices, each share on a replica of the model,
with `devices`), and `__call__` / `stream_inference` stream a source (files, folders,
globs, arrays, tensors) frame by frame with the callback bus that the trackers use. With
`augment` the frame-by-frame route of a Detect head serves test-time augmentation
(`serve_augmented`); `predict_batch` never reads the key, as the JAX package's batched
route does not. With `save` the stream writes each result's `plot()` (`_MediaWriter`:
images by name, videos and streams as Motion-JPEG AVI files) into the directory that
`save_txt` uses too.
"""

from __future__ import annotations

import copy
import time
from pathlib import Path

import numpy as np
import torch

from sar_yolo_tpu_torch.cfg.default import get_save_dir
from sar_yolo_tpu_torch.data.avi import AviWriter
from sar_yolo_tpu_torch.data.imageio import imwrite
from sar_yolo_tpu_torch.data.loaders import load_inference_source
from sar_yolo_tpu_torch.engine.results import Results
from sar_yolo_tpu_torch.ops.decode import decode_detect, decode_obb
from sar_yolo_tpu_torch.ops.masks import process_mask
from sar_yolo_tpu_torch.ops.nms import (non_max_suppression, non_max_suppression_rotated,
                                        postprocess_end2end)
from sar_yolo_tpu_torch.ops.preprocess import letterbox_device
from sar_yolo_tpu_torch.ops.tta import forward_tta
from sar_yolo_tpu_torch.utils import LOGGER
from sar_yolo_tpu_torch.utils.callbacks import HasCallbacks


class _MediaWriter:
    """The annotated outputs of `save=True` (the JAX package's `_MediaWriter`): each image
    result's `plot()` written as save_dir/<its file name> (JPEG at quality 95, or PNG), and
    each video or stream source's plotted frames as one Motion-JPEG AVI, save_dir/<its
    stem>.avi, at the source's fps (30 where it gives none)."""

    def __init__(self, save_dir: Path):
        self.dir = Path(save_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.writers: dict = {}

    def write(self, res, meta: dict):
        img = res.plot()
        path = Path(str(res.path))
        if meta.get("video") or meta.get("stream"):
            key = str(res.path)
            if key not in self.writers:
                h, w = img.shape[:2]
                self.writers[key] = AviWriter(self.dir / (path.stem + ".avi"),
                                              meta.get("fps") or 30, (w, h))
            self.writers[key].write(img)
        else:
            imwrite(self.dir / path.name, img)

    def close(self):
        for writer in self.writers.values():
            writer.close()
        self.writers.clear()


class BasePredictor(HasCallbacks):
    """Serves a (fused) model on its device; `args` holds imgsz, conf (None: 0.25), iou,
    max_det, agnostic_nms, save, save_txt, save_dir, project, name and exist_ok."""

    def __init__(self, model, meta: dict, args, names=None):
        self.model = model
        self.meta = meta
        self.args = args
        self.names = names or {i: str(i) for i in range(meta["nc"])}
        self.imgsz = args.imgsz if isinstance(args.imgsz, int) else args.imgsz[0]
        self.device = next(model.parameters()).device
        self.init_callbacks()
        self.batch = None         # (path, orig_img, meta) of the current frame
        self.results = None       # [Results] of the current frame (callbacks may edit it)
        self.source_types = None
        self.trackers = {}        # filled by trackers.register_tracker

    def decode(self, feats):
        """Head maps -> (rows (B, N, 4 + nc + states): xywh boxes in letterboxed pixels and
        sigmoided scores; the JDE embedding bank (B, N, E), or None)."""
        meta = self.meta
        # JDE: the wide raw embedding channels stay out of the (B, N)-sized
        # decode/NMS work; they are gathered per kept detection after NMS
        emb_dim = meta.get("embed_dim") or 0
        preds = decode_detect(feats, meta["strides"], meta["nc"], meta["reg_max"],
                              extra_sigmoid=meta.get("state_classes") or 0,
                              split_extras=emb_dim,
                              kpt_shape=meta["kpt_shape"] if meta.get("head") == "Pose" else None)
        return preds if emb_dim else (preds, None)

    def decode_nms(self, feats):
        """Head maps -> decode -> NMS (a v10 head: the NMS-free top-k): (B, max_det, 6 + E)
        detections in letterboxed pixels."""
        args = self.args
        preds, bank = self.decode(feats)
        conf = args.conf if args.conf is not None else 0.25
        if self.meta.get("head") == "v10Detect":
            return postprocess_end2end(preds, max_det=args.max_det, conf_thres=conf,
                                       nc=self.meta["nc"])
        return non_max_suppression(preds, conf_thres=conf, iou_thres=args.iou,
                                   max_det=args.max_det, nc=self.meta["nc"],
                                   agnostic=args.agnostic_nms, extras_bank=bank)

    def _dets_in_orig_coords(self, x, r: float, pad):
        """Normalized letterboxed NCHW batch -> forward, decode, NMS -> boxes in original
        pixels."""
        return _unletterbox(self.decode_nms(self.model(x)), r, pad)

    def uses_tta(self) -> bool:
        """Whether `augment` applies: to a Detect head only; any other head warns and serves
        one scale, as the JAX predictor does."""
        if not getattr(self.args, "augment", False):
            return False
        if self.meta.get("head") != "Detect":
            LOGGER.warning("augment=True is Detect-only; reverting to single-scale prediction")
            return False
        return True

    def serve_augmented(self, x, r: float, pad):
        """Test-time augmentation of a letterboxed batch (`ops/tta.py::forward_tta`: three
        passes resized in float32), then single-label NMS: (B, max_det, 6) rows in original
        pixels."""
        args, meta = self.args, self.meta
        preds = forward_tta(self.model, x.float(), meta["strides"], meta["nc"], meta["reg_max"])
        dets = non_max_suppression(preds, conf_thres=args.conf if args.conf is not None else 0.25,
                                   iou_thres=args.iou, max_det=args.max_det, nc=meta["nc"],
                                   agnostic=args.agnostic_nms)
        return _unletterbox(dets, r, pad)

    def serve(self, x, r: float, pad):
        """The task's outputs of a letterboxed batch, on the device (the rows here)."""
        return self._dets_in_orig_coords(x, r, pad)

    def preprocess(self, frames_u8):
        """(B, H, W, 3) uint8 BGR -> (normalized letterboxed RGB NCHW batch on the device in
        the model's compute dtype, r, pad)."""
        frames = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(self.device)
        x, r, pad = letterbox_device(frames.flip(-1), self.imgsz, scaleup=False)
        dtype = getattr(self.model, "compute_dtype", torch.float32)
        return (x.permute(0, 3, 1, 2).contiguous() / 255.0).to(dtype), r, pad

    @torch.no_grad()
    def predict_batch(self, frames_u8, devices=None):
        """Serve a (B, H, W, 3) uint8 BGR batch; returns (B, max_det, 6 + E) detections
        in original-image pixels (rows with conf == 0 are padding); pose: (B, max_det,
        6 + K D); segment: (rows (B, max_det, 6), masks (B, max_det, mh, mw) bool).
        `devices` (a mesh, `parallel.model_mesh`): the batch split into one share a device,
        each served by a replica of the model there, the outputs concatenated in order. Every
        share is launched before any result is copied to the host, so the devices' shares
        run at the same time."""
        if not devices:
            return _numpy(self.serve(*self.preprocess(frames_u8)))
        frames = np.asarray(frames_u8)
        if len(frames) % len(devices):
            raise ValueError(f"a batch of {len(frames)} does not split over {len(devices)} "
                             "devices")
        on_device = [self._serve_on(d, share)
                     for d, share in zip(devices, np.split(frames, len(devices)))]
        outs = [_numpy(out) for out in on_device]
        if isinstance(outs[0], tuple):
            return tuple(np.concatenate(parts) for parts in zip(*outs))
        return np.concatenate(outs)

    def _serve_on(self, device, frames):
        """`serve` of frames by the model's replica on `device` (made once per model), its
        outputs left on that device."""
        device = torch.device(device)
        if getattr(self, "_replicas", (None,))[0] is not self.model:
            self._replicas = (self.model, {})
        replicas = self._replicas[1]
        if device not in replicas:
            replicas[device] = self.model if device == self.device else \
                copy.deepcopy(self.model).to(device)
        model, home = self.model, self.device
        self.model, self.device = replicas[device], device
        try:
            return self.serve(*self.preprocess(frames))
        finally:
            self.model, self.device = model, home

    @staticmethod
    def _kept(dets, orig_img) -> np.ndarray:
        """The kept rows of the first image's detections, boxes clipped to the image."""
        d = np.asarray(dets[0])
        d = d[d[:, 4] > 0]
        h, w = orig_img.shape[:2]
        d[:, [0, 2]] = d[:, [0, 2]].clip(0, w)
        d[:, [1, 3]] = d[:, [1, 3]].clip(0, h)
        return d

    def __call__(self, source, stream: bool = False):
        gen = self.stream_inference(source)
        return gen if stream else list(gen)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def stream_inference(self, source):
        """Results of each frame of `source`, one at a time. `speed` (host ms, each part
        ended on the device): preprocess (the raw uint8 frame to the device and its
        letterbox), inference (forward, decode, NMS, rescale and the copy to the host),
        postprocess (Results and the on_predict_postprocess_end callbacks)."""
        loader, self.source_types = load_inference_source(
            source, buffer=bool(getattr(self.args, "stream_buffer", False)))
        serve = self.serve_augmented if self.uses_tta() else self.serve
        save_txt = bool(getattr(self.args, "save_txt", False))
        save_dir = writer = None
        if save_txt or getattr(self.args, "save", False):  # one directory for both
            save_dir = Path(self.args.save_dir or get_save_dir(self.args, self.meta["task"]))
        if getattr(self.args, "save", False):
            writer = _MediaWriter(save_dir)
        self.run_callbacks("on_predict_start")
        try:
            for path, img, meta in loader:
                self.batch = (path, img, meta)
                self.run_callbacks("on_predict_batch_start")
                t0 = time.perf_counter()
                x, r, pad = self.preprocess(img[None])
                self._sync()
                t1 = time.perf_counter()
                dets = _numpy(serve(x, r, pad))
                t2 = time.perf_counter()
                speed = {"preprocess": (t1 - t0) * 1e3, "inference": (t2 - t1) * 1e3}
                res = self.postprocess(dets, path, img, speed)
                res.frame = meta.get("frame")
                self.results = [res]
                self.run_callbacks("on_predict_postprocess_end")
                res = self.results[0]
                speed["postprocess"] = (time.perf_counter() - t2) * 1e3
                if writer is not None:
                    writer.write(res, meta)
                if save_txt:
                    n = f"_{meta['frame']}" if meta.get("frame") is not None else ""
                    res.save_txt(save_dir / "labels" / f"{Path(str(path)).stem}{n}.txt")
                yield res
        finally:
            if writer is not None:
                writer.close()
            self.run_callbacks("on_predict_end")


def _unletterbox(dets, r: float, pad):
    """Rows' boxes from letterboxed to original pixels."""
    pad4 = torch.tensor([*pad, *pad], dtype=dets.dtype, device=dets.device)
    return torch.cat([(dets[..., :4] - pad4) / r, dets[..., 4:]], -1)


def _numpy(out):
    """A device tensor, or a tuple of them, on the host as numpy."""
    return tuple(t.cpu().numpy() for t in out) if isinstance(out, tuple) else out.cpu().numpy()


class DetectionPredictor(BasePredictor):
    """Boxes only: [x1, y1, x2, y2, conf, cls] a row."""

    def postprocess(self, dets, path, orig_img, speed=None) -> Results:
        return Results(orig_img, path, self.names, boxes=self._kept(dets, orig_img)[:, :6],
                       speed=speed)


class JDEPredictor(BasePredictor):
    """Splits [box, conf, cls, emb, state] and exposes embeddings and the argmax state."""

    def postprocess(self, dets, path, orig_img, speed=None) -> Results:
        d = self._kept(dets, orig_img)
        ed = self.meta["embed_dim"]
        sc = self.meta.get("state_classes") or 0
        embeds = d[:, 6:6 + ed]
        states = d[:, 6 + ed:6 + ed + sc].argmax(-1) if sc else None
        return Results(orig_img, path, self.names, boxes=d[:, :6], embeds=embeds,
                       person_states=states, speed=speed)


class PosePredictor(BasePredictor):
    """Rows [box, conf, cls, K x (x, y[, visibility])], the keypoints un-letterboxed;
    Results.keypoints (n, K, D)."""

    def serve(self, x, r: float, pad):
        dets = self._dets_in_orig_coords(x, r, pad)
        K, D = self.meta["kpt_shape"]
        k = dets[..., 6:6 + K * D].reshape(*dets.shape[:2], K, D)
        pad2 = torch.tensor(pad, dtype=dets.dtype, device=dets.device)
        k = torch.cat([(k[..., :2] - pad2) / r, k[..., 2:]], -1)
        return torch.cat([dets[..., :6], k.reshape(*dets.shape[:2], K * D)], -1)

    def postprocess(self, dets, path, orig_img, speed=None) -> Results:
        d = self._kept(dets, orig_img)
        K, D = self.meta["kpt_shape"]
        return Results(orig_img, path, self.names, boxes=d[:, :6],
                       keypoints=d[:, 6:6 + K * D].reshape(-1, K, D), speed=speed)


class SegmentPredictor(BasePredictor):
    """(rows [box, conf, cls], masks at the prototypes' resolution of the letterboxed
    input); Results.masks (n, mh, mw) bool."""

    def serve(self, x, r: float, pad):
        feats, protos = self.model(x)
        dets = self.decode_nms(feats)
        H = x.shape[2]
        masks = process_mask(protos, dets[..., 6:], dets[..., :4], (H, H))
        pad4 = torch.tensor([*pad, *pad], dtype=dets.dtype, device=dets.device)
        return torch.cat([(dets[..., :4] - pad4) / r, dets[..., 4:6]], -1), masks

    def postprocess(self, out, path, orig_img, speed=None) -> Results:
        dets, masks = out
        keep = dets[0][:, 4] > 0
        return Results(orig_img, path, self.names, boxes=self._kept(dets, orig_img)[:, :6],
                       masks=masks[0][keep], speed=speed)


class OBBPredictor(BasePredictor):
    """Rotated rows [cx, cy, w, h, r, conf, cls] (rows with conf == 0 are padding);
    Results.obb."""

    def serve(self, x, r: float, pad):
        args, meta = self.args, self.meta
        preds = decode_obb(self.model(x), meta["strides"], meta["nc"], meta["reg_max"])
        dets = non_max_suppression_rotated(preds, conf_thres=args.conf if args.conf is not None
                                           else 0.25, iou_thres=args.iou,
                                           max_det=args.max_det, nc=meta["nc"])
        pad2 = torch.tensor(pad, dtype=dets.dtype, device=dets.device)
        return torch.cat([(dets[..., :2] - pad2) / r, dets[..., 2:4] / r, dets[..., 4:]], -1)

    def postprocess(self, dets, path, orig_img, speed=None) -> Results:
        d = np.asarray(dets[0])
        return Results(orig_img, path, self.names, obb=d[d[:, 5] > 0], speed=speed)


class RTDETRPredictor(DetectionPredictor):
    """RT-DETR: the last decoder layer's queries, their best class and its sigmoid score, the
    boxes in original pixels; a score under conf becomes 0 (the row stays, as padding). No
    NMS. Rows (B, nq, 6) [x1, y1, x2, y2, conf, cls] in query order."""

    def serve(self, x, r: float, pad):
        conf = self.args.conf if self.args.conf is not None else 0.25
        dec_b, dec_s = self.model(x)[:2]
        H, W = x.shape[2:]
        boxes = dec_b[-1] * torch.tensor([W, H, W, H], dtype=dec_b.dtype, device=x.device)
        scores = torch.sigmoid(dec_s[-1])
        cls_conf, cls = scores.max(-1)
        pad2 = torch.tensor(pad, dtype=x.dtype, device=x.device)
        xy = (boxes[..., :2] - pad2) / r
        wh = boxes[..., 2:4] / r
        conf_m = torch.where(cls_conf >= conf, cls_conf, 0.0)
        return torch.cat([xy - wh / 2, xy + wh / 2, conf_m[..., None].to(xy.dtype),
                          cls[..., None].to(xy.dtype)], -1)


class ClassificationPredictor(BasePredictor):
    """Class probabilities (B, nc): the softmax of the logits of the letterboxed frame;
    Results.probs."""

    def serve(self, x, r: float, pad):
        return self.model(x).softmax(-1).float()

    def postprocess(self, probs, path, orig_img, speed=None) -> Results:
        return Results(orig_img, path, self.names, probs=probs[0], speed=speed)


PREDICTORS = {"detect": DetectionPredictor, "jde": JDEPredictor, "pose": PosePredictor,
              "segment": SegmentPredictor, "obb": OBBPredictor,
              "classify": ClassificationPredictor}
