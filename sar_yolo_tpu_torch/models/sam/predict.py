"""SAM's promptable-segmentation predictor and SAM2's video predictor (port of
`sar_yolo_tpu/models/sam/predict.py`).

The image tower runs once per image (`set_image`); each prompt batch then costs the prompt
encoder and mask decoder only. Segment-everything (`generate`) scores the whole point grid on
the device at low resolution, runs greedy box NMS on the host in JAX's order, and decodes
full-size masks for the survivors only. Low-resolution logits go to the original frame
through one dense product per axis: JAX's two bilinear resizes (to imgsz x imgsz, then the
crop to the resized image, then to the frame's size; antialiased where that second one
shrinks) folded into one matrix each (`ops/masks.py::resize_weights`). JAX pads the query
batches to powers of two for its compile cache; the port decodes the queries as given, since
each query's outputs depend on it alone. A SAM2 model's decode gives (masks, iou, mask tokens,
object score): the predictor keeps the first two, as JAX's `_decode_fn` does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sar_yolo_tpu_torch.data.cv import resize
from sar_yolo_tpu_torch.engine.results import Results
from sar_yolo_tpu_torch.models.sam.amg import (batched_mask_to_box, build_point_grid,
                                               stability_score)
from sar_yolo_tpu_torch.ops.masks import resize_weights
from sar_yolo_tpu_torch.utils import LOGGER

GENERATE_KEYS = ("points_per_side", "points_per_batch", "max_det", "conf", "stability_thresh")


def greedy_box_nms(boxes: np.ndarray, iou_thres: float, max_det: int) -> list:
    """Indices kept by greedy NMS of float32 xyxy `boxes` in their given order (the JAX
    package's host loop, vectorized over the kept boxes with the same float32 arithmetic)."""
    keep: list = []
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    for i in range(len(boxes)):
        if keep:
            k = np.asarray(keep)
            iw = np.maximum(np.minimum(boxes[i, 2], boxes[k, 2]) -
                            np.maximum(boxes[i, 0], boxes[k, 0]), np.float32(0))
            ih = np.maximum(np.minimum(boxes[i, 3], boxes[k, 3]) -
                            np.maximum(boxes[i, 1], boxes[k, 1]), np.float32(0))
            inter = iw * ih
            union = np.maximum(areas[i] + areas[k] - inter, np.float32(1e-9))
            if (inter / union > iou_thres).any():
                continue
        keep.append(i)
        if len(keep) >= max_det:
            break
    return keep


class SAMPredictor:
    """Promptable segmentation over one cached image embedding, on the model's device."""

    def __init__(self, model, imgsz: int = 1024, conf: float = 0.88,
                 stability_thresh: float = 0.95, iou_thres: float = 0.7, names=None):
        self.model = model
        self.imgsz = imgsz
        self.conf = conf
        self.stability_thresh = stability_thresh
        self.iou_thres = iou_thres
        self.names = names or {0: "object"}
        self.prompts: dict = {}
        self._features = None
        self._im_meta = None      # (orig_h, orig_w, scaled_h, scaled_w)
        self._to_orig = None      # the two resize matrices of _im_meta
        self.generate_ms: dict = {}

    @property
    def device(self):
        return next(self.model.parameters()).device

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ image
    def _canvas(self, image: np.ndarray) -> np.ndarray:
        """(imgsz, imgsz, 3) RGB uint8 of a BGR frame: the longest side resized to imgsz
        (OpenCV's INTER_LINEAR), padded bottom-right; sets the frame's `_im_meta`."""
        h, w = image.shape[:2]
        r = self.imgsz / max(h, w)
        nh, nw = round(h * r), round(w * r)
        canvas = np.zeros((self.imgsz, self.imgsz, 3), np.uint8)
        canvas[:nh, :nw] = resize(np.ascontiguousarray(image[..., ::-1]), (nw, nh))
        if self._im_meta != (h, w, nh, nw):
            self._im_meta, self._to_orig = (h, w, nh, nw), None
        return canvas

    def set_image(self, image: np.ndarray):
        """image: (H, W, 3) BGR uint8. Caches the embeddings of its canvas: SAM's (1, 256,
        imgsz/16, imgsz/16), SAM2's dict of maps (`SAM2Model.encode`)."""
        canvas = self._canvas(image)
        with torch.no_grad():
            self._features = self.model.encode(torch.from_numpy(canvas[None]).to(self.device))
        return self._features

    def reset_image(self):
        self._features = None
        self._im_meta = None
        self._to_orig = None

    def set_prompts(self, prompts: dict):
        self.prompts = dict(prompts or {})

    # ---------------------------------------------------------------- prompts
    def _scale_coords(self, xy):
        """Original-image pixels -> model input pixels."""
        h, w, nh, nw = self._im_meta
        return np.asarray(xy, np.float32) * np.asarray([nw / w, nh / h], np.float32)

    def _tensor(self, a):
        return None if a is None else torch.as_tensor(a, device=self.device)

    def decode(self, points=None, labels=None, boxes=None):
        """Low-resolution mask logits (Q, 4, 4h, 4w) and IoU predictions (Q, 4) of prompts in
        model input pixels (numpy), on the device."""
        with torch.no_grad():
            return self.model.decode(self._features, points=self._tensor(points),
                                     labels=self._tensor(labels), boxes=self._tensor(boxes))[:2]

    def _prompt_arrays(self, bboxes, points, labels):
        """The JAX package's prompt handling: (points (Q, P, 2), labels (Q, P), boxes (Q, 4)) in
        model input pixels, each None where not given."""
        h, w, nh, nw = self._im_meta
        pts = lbl = box_arr = None
        if points is not None:
            pts = np.asarray(points, np.float32)
            if pts.ndim == 1:
                pts = pts[None]
            if pts.ndim == 2:
                pts = pts[:, None]                                        # (Q, 1, 2)
            lbl = (np.ones(pts.shape[:2], np.float32) if labels is None
                   else np.asarray(labels, np.float32).reshape(pts.shape[:2]))
            pts = self._scale_coords(pts)
        if bboxes is not None:
            box_arr = np.asarray(bboxes, np.float32).reshape(-1, 4)
            box_arr = box_arr * np.asarray([nw / w, nh / h, nw / w, nh / h], np.float32)
            if pts is not None and len(box_arr) != len(pts):
                raise ValueError(f"points ({len(pts)}) and boxes ({len(box_arr)}) must prompt "
                                 "the same queries; run separate calls for mixed prompt sets")
        return pts, lbl, box_arr

    def prompt_logits(self, bboxes=None, points=None, labels=None,
                      multimask_output: bool = False):
        """(mask logits (N, H, W) at the original size, scores (N,)), on the device, for
        prompts in original-image coordinates: bboxes (Q, 4) xyxy; points (Q, P, 2) or (Q, 2)
        with labels (default 1 = foreground). Multimask: each query's best of slots 1-3."""
        if self._features is None:
            raise RuntimeError("call set_image() first")
        masks, iou = self.decode(*self._prompt_arrays(bboxes, points, labels))
        if multimask_output:
            best = iou[:, 1:].argmax(1, keepdim=True) + 1
            masks = masks.gather(1, best[..., None, None].expand(-1, -1, *masks.shape[2:]))[:, 0]
            iou = iou.gather(1, best)[:, 0]
        else:
            masks, iou = masks[:, 0], iou[:, 0]
        return self.to_original(masks), iou

    def prompt_inference(self, bboxes=None, points=None, labels=None,
                         multimask_output: bool = False):
        """(masks (N, H, W) bool at the original size, scores (N,)) as numpy arrays."""
        logits, iou = self.prompt_logits(bboxes, points, labels, multimask_output)
        return (logits > 0).cpu().numpy(), iou.float().cpu().numpy()

    def to_original(self, low_res):
        """(N, h, w) low-resolution logits -> (N, H, W) logits at the original size."""
        h, w, nh, nw = self._im_meta
        if self._to_orig is None or self._to_orig[0].dtype != low_res.dtype:
            # JAX: resize to imgsz x imgsz, crop to (nh, nw), resize to (h, w)
            up = resize_weights(low_res.shape[-2], self.imgsz).astype(np.float64)
            mh = up[:, :nh] @ resize_weights(nh, h)
            mw = up[:, :nw] @ resize_weights(nw, w)
            self._to_orig = tuple(torch.as_tensor(m, dtype=low_res.dtype, device=low_res.device)
                                  for m in (mh, mw))
        mh, mw = self._to_orig
        return mh.T @ low_res @ mw

    # ------------------------------------------------------------ generate
    def score_grid(self, points_per_side: int = 32, points_per_batch: int = 64):
        """Segment-everything's device part: the point grid in model input pixels (n, 2), and
        for each of its n x 3 multimask candidates the IoU prediction, the stability score and
        the low-resolution box, as float32 numpy arrays (each point's slots 1-3 in a row)."""
        h, w, nh, nw = self._im_meta
        grid = build_point_grid(points_per_side) * np.asarray([nw, nh], np.float32)
        iou, stab, boxes = [], [], []
        with torch.no_grad():
            for i in range(0, len(grid), points_per_batch):
                pts = grid[i:i + points_per_batch, None]
                masks, q = self.decode(pts, np.ones(pts.shape[:2], np.float32))
                m3 = masks[:, 1:]
                iou.append(q[:, 1:])
                stab.append(stability_score(m3))
                boxes.append(batched_mask_to_box(m3 > 0))
        to_np = lambda parts: torch.cat(parts).float().cpu().numpy()  # noqa: E731
        return grid, to_np(iou).reshape(-1), to_np(stab).reshape(-1), to_np(boxes).reshape(-1, 4)

    def select(self, iou, stab, boxes, conf: float, stability_thresh: float, max_det: int):
        """Candidates (flat indices) that pass the filters and greedy box NMS, in JAX's order
        (np.argsort of -iou over the passing ones)."""
        keep = (iou > conf) & (stab > stability_thresh)
        keep &= (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        idx = np.flatnonzero(keep)
        order = idx[np.argsort(-iou[idx])]
        return order[greedy_box_nms(boxes[order], self.iou_thres, max_det)]

    def generate(self, points_per_side: int = 32, points_per_batch: int = 64, max_det: int = 300,
                 conf: float | None = None, stability_thresh: float | None = None):
        """Segment everything: (masks (K, H, W) bool, scores (K,), boxes (K, 4) xyxy in original
        pixels). `generate_ms` holds the split: device scoring, host NMS, second decode."""
        if self._features is None:
            raise RuntimeError("call set_image() first")
        conf = self.conf if conf is None else conf
        stability_thresh = self.stability_thresh if stability_thresh is None else stability_thresh
        h, w, nh, nw = self._im_meta
        t0 = time.perf_counter()
        grid, iou, stab, boxes = self.score_grid(points_per_side, points_per_batch)
        t1 = time.perf_counter()
        chosen = self.select(iou, stab, boxes, conf, stability_thresh, max_det)
        t2 = time.perf_counter()
        if len(chosen) == 0:
            masks = np.zeros((0, h, w), bool)
        else:
            slots = torch.as_tensor(chosen % 3 + 1, device=self.device)
            low, _ = self.decode(grid[chosen // 3][:, None],
                                 np.ones((len(chosen), 1), np.float32))
            low = low[torch.arange(len(chosen), device=self.device), slots]
            masks = (self.to_original(low) > 0).cpu().numpy()
        self.generate_ms = {"score": (t1 - t0) * 1e3, "nms": (t2 - t1) * 1e3,
                            "decode": (time.perf_counter() - t2) * 1e3}
        scale = np.asarray([w / nw * 4, h / nh * 4] * 2, np.float32)  # low-res grid -> original
        return masks, iou[chosen], boxes[chosen] * scale

    # ---------------------------------------------------------------- facade
    def __call__(self, source, bboxes=None, points=None, labels=None,
                 multimask_output: bool = False, **kwargs):
        """[Results] of each image of `source` (the port's inference sources): prompted masks,
        or segment-everything without prompts (kwargs: those of `generate`; others are
        ignored, as in the JAX package); the boxes derived from the masks."""
        from sar_yolo_tpu_torch.data.loaders import load_inference_source
        loader, _ = load_inference_source(source)
        out = []
        for path, img, _meta in loader:
            t0 = time.perf_counter()
            self.set_image(img)
            self._sync()
            t1 = time.perf_counter()
            if bboxes is None and points is None and not self.prompts:
                masks, scores, boxes = self.generate(
                    **{k: v for k, v in kwargs.items() if k in GENERATE_KEYS})
            else:
                logits, iou = self.prompt_logits(self.prompts.get("bboxes", bboxes),
                                                 self.prompts.get("points", points),
                                                 self.prompts.get("labels", labels),
                                                 multimask_output)
                on = logits > 0
                masks, scores = on.cpu().numpy(), iou.float().cpu().numpy()
                boxes = batched_mask_to_box(on).cpu().numpy()
            t2 = time.perf_counter()
            n = masks.shape[0]
            det = np.concatenate([np.asarray(boxes, np.float32).reshape(n, 4),
                                  np.asarray(scores, np.float32).reshape(n, 1),
                                  np.zeros((n, 1), np.float32)], 1)
            speed = {"preprocess": 0.0, "inference": (t1 - t0) * 1e3,
                     "postprocess": (t2 - t1) * 1e3}
            out.append(Results(img, path, self.names, boxes=det, masks=masks, speed=speed))
        if not out:
            LOGGER.warning("SAM: no images found in source")
        return out


class SAM2VideoPredictor(SAMPredictor):
    """Video object segmentation with SAM2's fixed-slot memory bank.

    The bank is a (Q, T, h, w, mem_dim) tensor and its (Q, T) validity on the device: slot 0
    holds the prompted frame forever, slots 1..T-1 are a ring over the recent frames (frame i
    of the track writes slot 1 + i % (T - 1)). Each step encodes the frame, conditions its
    stride-16 features on each object's bank, decodes each object with one not-a-point token
    (label -1) on its conditioned embedding (no `no_mem_embed`), keeps the single-mask slot 0
    and encodes it into the new memory. The Q objects go through each stage as one batch
    (JAX vmaps over them); the memory attention chunks them where its logits would outgrow
    `modules2.LOGITS_BUDGET`. `last_step` keeps the last step's device tensors and its ring
    bookkeeping.
    """

    def __init__(self, model, imgsz: int = 1024, **kw):
        super().__init__(model, imgsz=imgsz, **kw)
        self.last_step: dict = {}

    def _build_step(self, Q: int):
        """The step of Q objects: (canvas (1, S, S, 3) uint8, bank, valid, tpos (T,)) ->
        (mask logits (Q, 4h, 4w), scores (Q,), object logits (Q,), new memory (Q, h, w,
        mem_dim), conditioned embedding (Q, d, h, w))."""
        model = self.model

        def step(canvas, bank, valid, tpos):
            with torch.no_grad():
                feats = model.encode(canvas)
                cond = model.condition_on_memory(feats["raw_embed"], bank, valid, tpos)
                pts = torch.zeros(Q, 1, 2, dtype=cond.dtype, device=cond.device)
                lbl = -torch.ones(Q, 1, dtype=cond.dtype, device=cond.device)
                masks, iou, _tok, obj = model.decode(
                    {"image_embed": cond, "high_res_feats": feats["high_res_feats"]},
                    points=pts, labels=lbl)
                m0 = masks[:, 0]
                new_mem = model.encode_memory(feats["raw_embed"], m0[:, None])
            return m0, iou[:, 0], obj[:, 0], new_mem, cond

        return step

    def init_video(self, first_frame, bboxes=None, points=None, labels=None):
        """Prompt the objects on the first frame and start the bank: (mask logits (Q, 4h,
        4w), scores (Q,)) on the device."""
        self.set_image(first_frame)
        pts, lbl, box = self._prompt_arrays(bboxes, points, labels)
        Q = len(pts) if pts is not None else len(box) if box is not None else 0
        if Q == 0:
            raise ValueError("SAM2 video tracking needs first-frame prompts")
        feats = self._features
        with torch.no_grad():
            masks, iou, _tok, _obj = self.model.decode(
                feats, points=self._tensor(pts), labels=self._tensor(lbl),
                boxes=self._tensor(box))
            m0 = masks[:, 0]
            mem0 = self.model.encode_memory(feats["raw_embed"], m0[:, None])
        T = self.model.num_maskmem
        self._bank = mem0.new_zeros((Q, T, *mem0.shape[1:]))
        self._bank[:, 0] = mem0
        self._valid = mem0.new_zeros((Q, T))
        self._valid[:, 0] = 1.0
        self._frame_i = 0
        self._Q = Q
        self._slot_frame = np.full(T, -1, np.int64)  # the track step that wrote each slot
        self._step = self._build_step(Q)
        return m0, iou[:, 0]

    def ring_state(self):
        """(tpos (T,) frames back of each slot for the next step, the slot it writes): slot 0
        is 0 back; a written slot min(max(i - frame + 1, 1), T - 1); an empty one T - 1 (it is
        masked out)."""
        T = self.model.num_maskmem
        tpos = np.where(self._slot_frame >= 0,
                        np.clip(self._frame_i - self._slot_frame + 1, 1, T - 1), T - 1)
        tpos[0] = 0
        return tpos, 1 + self._frame_i % max(T - 1, 1)

    def _track(self, frame):
        """Carry every object one frame: (mask logits (Q, 4h, 4w), scores (Q,), object logits
        (Q,)) on the device; the step's new memory goes into the ring."""
        canvas = torch.from_numpy(self._canvas(frame)[None]).to(self.device)
        tpos, slot = self.ring_state()
        bank_in, valid_in = self._bank, self._valid
        m0, score, obj, new_mem, cond = self._step(
            canvas, bank_in, valid_in, torch.as_tensor(tpos, device=self.device))
        self.last_step = {"canvas": canvas, "bank": bank_in, "valid": valid_in, "tpos": tpos,
                          "slot": slot, "low_res": m0, "score": score, "obj": obj,
                          "new_mem": new_mem, "cond": cond}
        self._bank = bank_in.clone()
        self._bank[:, slot] = new_mem
        self._valid = valid_in.clone()
        self._valid[:, slot] = 1.0
        self._slot_frame[slot] = self._frame_i
        self._frame_i += 1
        return m0, score, obj

    def track_step(self, frame):
        """Carry every object one frame: (masks (Q, H, W) bool, scores (Q,), object logits
        (Q,)) as numpy arrays."""
        m0, score, obj = self._track(frame)
        return ((self.to_original(m0) > 0).cpu().numpy(), score.float().cpu().numpy(),
                obj.float().cpu().numpy())

    def __call__(self, source, bboxes=None, points=None, labels=None, **kwargs):
        """One Results a frame of `source` (a list of frames, a folder of images, a video
        file or a `.streams` list, through `load_inference_source`), the objects prompted
        on its first frame: masks, their boxes, the score, class 0 and the
        object's index in column 6; `frame` set."""
        from sar_yolo_tpu_torch.data.loaders import load_inference_source
        loader, _ = load_inference_source(source)
        out = []
        for i, (path, img, _meta) in enumerate(loader):
            t0 = time.perf_counter()
            if i == 0:
                m0, score = self.init_video(img, bboxes=bboxes, points=points, labels=labels)
            else:
                m0, score, _obj = self._track(img)
            on = self.to_original(m0) > 0
            masks, score = on.cpu().numpy(), score.float().cpu().numpy()
            t1 = time.perf_counter()
            boxes = batched_mask_to_box(on).cpu().numpy()  # on the device, as SAMPredictor's
            n = masks.shape[0]
            det = np.concatenate([boxes, score.reshape(n, 1).astype(np.float32),
                                  np.zeros((n, 1), np.float32),
                                  np.arange(n, dtype=np.float32).reshape(n, 1)], 1)
            res = Results(img, path, self.names, boxes=det, masks=masks,
                          speed={"inference": (t1 - t0) * 1e3})
            res.frame = i
            out.append(res)
        if not out:
            LOGGER.warning("SAM2: no frames found in source")
        return out
