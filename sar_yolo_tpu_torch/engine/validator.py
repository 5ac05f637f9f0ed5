"""Validators: the eval loop on the device, then mAP, posture-state, ReID, keypoint,
mask, rotated-box and top-k accuracy metrics on the host (port of `BaseValidator`,
`DetectionValidator`, `JDEValidator`, `PoseValidator`, `SegmentValidator`,
`OBBValidator` and `ClassificationValidator` of `sar_yolo_tpu/engine/validator.py`).

Per batch, the uint8 NHWC RGB images go to the device as NCHW / 255; the eval
forward, the decode and NMS (multi-label for nc > 1, the JDE embeddings gathered
after NMS, pose keypoints decoded to input pixels and segment mask coefficients
carried in the rows; for a v10 head the NMS-free top-k; for OBB the rotated decode and
NMS) run there, and one copy comes back: the (B, max_det, 6 + E + S) rows, with a
segment model's (B, nm, mh, mw) prototypes in the same buffer (16 x 32 x 160 x 160
float32 at 640: 52 MB a batch).

With `rect`, the dataset's images are batched by aspect ratio (`init_rect`). With
`save_json`, boxes go back to native image pixels through each image's `ratio_pad`,
image ids are the file stems, and an 80-class model validated on a COCO dataset
writes the COCO 91-index category ids.

`RTDETRValidator` scores RT-DETR's last decoder layer without NMS: the queries' best
class, rows under conf (0.001) dropped, the rest in score order cut at max_det, on the
host as the JAX validator does it (square batches, as the JAX validator loads them).

With `mesh_shape=[N]` each batch is split over N devices (the visible CUDA devices; a
CPU model runs its N shares on the CPU), each share through a replica of the model on its
device, the rows put back together in order; with fewer devices than N, or a batch that
does not split, it warns and runs on one device, as the JAX validator does.

With `augment` a Detect head is validated with test-time augmentation (`ops/tta.py`): the
three passes' decoded predictions go straight to single-label NMS at conf (0.001), as the
JAX validator does; any other head warns and validates one scale.

With `plots` (the default) the first batch's ground truth and predictions (rows at
max(conf, 0.25); pose keypoints, segment masks, rotated boxes) are drawn into
val_batch0_labels.jpg and val_batch0_pred.jpg, and the detection confusion matrix (conf 0.25,
IoU 0.45, with the background row and column) into confusion_matrix.png
(`utils/plotting.py`); the OBB and RT-DETR validators draw no confusion matrix, classify
draws nothing, as in the JAX package. A plotting error is logged and never fails a run.
"""

from __future__ import annotations

import copy
import csv
import json
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from sar_yolo_tpu_torch.data.build import DataLoader
from sar_yolo_tpu_torch.data.cv import resize_nearest_cv
from sar_yolo_tpu_torch.ops.boxes import probiou
from sar_yolo_tpu_torch.ops.decode import decode_detect, decode_obb
from sar_yolo_tpu_torch.ops.masks import process_mask
from sar_yolo_tpu_torch.ops.nms import (non_max_suppression, non_max_suppression_rotated,
                                        postprocess_end2end)
from sar_yolo_tpu_torch.ops.tta import forward_tta
from sar_yolo_tpu_torch.parallel.mesh import mesh_devices_count, model_mesh
from sar_yolo_tpu_torch.utils import LOGGER
from sar_yolo_tpu_torch.utils.loss import OKS_SIGMA
from sar_yolo_tpu_torch.utils.metrics import (IOU_THRESHOLDS, DetMetrics, box_iou_np,
                                              davies_bouldin, match_predictions,
                                              silhouette_cosine)
from sar_yolo_tpu_torch.utils.plotting import ConfusionMatrix, plot_images, plot_predictions

# COCO's 91-index category id of each of the 80 contiguous classes
COCO80_TO_91 = [i for i in range(1, 91) if i not in {12, 26, 29, 30, 45, 66, 68, 69, 71, 83}]


def mesh_replicas(model, args, bs: int, device) -> list | None:
    """[(device, the model's replica there)] of `args.mesh_shape` for batches of bs, or
    None (one device): the JAX validator's rule, which needs more than one mesh device, at
    least that many devices (any number for a CPU model) and a batch they split, and warns
    where the mesh asks for more than one device and one of the others fails."""
    dp = mesh_devices_count(args.mesh_shape) if getattr(args, "mesh_shape", None) else 1
    have = dp if device.type == "cpu" else torch.cuda.device_count()
    if dp > 1 and have >= dp and bs % dp == 0:
        return [(d, model if d == device else copy.deepcopy(model).to(d))
                for d in model_mesh(args.mesh_shape, device)]
    if dp > 1:
        LOGGER.warning(f"val: mesh_shape={args.mesh_shape} needs {dp} devices and batch "
                       f"divisible by {dp} (batch={bs}); running single-device")
    return None


def mesh_shares(mesh: list | None, model, device, img: np.ndarray) -> list:
    """(model, device, images) of each mesh device's share of a batch (the whole batch on
    `device` without a mesh)."""
    if mesh is None:
        return [(model, device, img)]
    return [(m, d, c) for (d, m), c in zip(mesh, np.split(img, len(mesh)))]


def _trim_batch(batch: dict, n: int) -> dict:
    """Drop trailing pad rows from every batch-dim leaf."""
    return {k: (v[:n] if isinstance(v, np.ndarray) and v.ndim >= 1 and
                len(v) >= n else v) for k, v in batch.items()}


class BaseValidator:
    """The eval loop; subclasses specialize the metrics.

    Examples:
        >>> metrics = JDEValidator()(model=model.eval(), meta=meta, dataset=val_set,
        ...                          args=get_cfg({"batch": 16}), data={"names": names})
    """

    rect_ok = True    # whether `rect` batches by aspect ratio
    confusion = True  # whether `plots` draws the detection confusion matrix
    ROTATED = False   # the rows are rotated boxes [cx cy w h r conf cls]

    def __call__(self, model, meta: dict, dataset, args, data: dict | None = None) -> dict:
        """Validate `model` (in eval mode, on its device) on `dataset`; args holds batch,
        workers, conf, iou, max_det, save_json, save_txt, save_conf, verbose, save_dir."""
        self.args, self.meta, self.data = args, meta, data or {}
        self.conf = args.conf if args.conf is not None else 0.001
        self.use_tta = bool(getattr(args, "augment", False))
        if self.use_tta and meta.get("head") != "Detect":
            LOGGER.warning("augment=True is Detect-only; reverting to single-scale eval")
            self.use_tta = False
        device = next(model.parameters()).device
        bs = min(args.batch, len(dataset))
        mesh = mesh_replicas(model, args, bs, device)
        if args.rect and self.rect_ok and getattr(dataset, "shapes", None) is not None:
            dataset.init_rect(bs)
        loader = DataLoader(dataset, bs, workers=args.workers, shuffle=False, drop_last=False,
                            pad_last=True)
        self.init_metrics()
        self.jdict, self.gt_anns = [], []  # COCO-style prediction and GT rows (save_json)
        is_coco = meta["nc"] == 80 and "coco" in Path(str(args.data or "")).stem.lower()
        self._cat_id = (lambda c: COCO80_TO_91[int(c)]) if is_coco else int
        n_img = 0
        t0 = time.perf_counter()
        for batch in loader:
            npad = int(batch.pop("_pad", 0))
            # every share launched before any is copied to the host
            on_device = [self.predict(m, self.preprocess(img, d))
                         for m, d, img in mesh_shares(mesh, model, device, batch["img"])]
            parts = [self._to_host(out) for out in on_device]
            dets = np.concatenate([p[0] for p in parts])
            self._protos = None if parts[0][1] is None else np.concatenate([p[1] for p in parts])
            n_eff = len(dets) - npad  # trailing pad rows are duplicate samples
            self._save_txt_batch(batch, dets, n_eff, n_img)
            if args.save_json:
                self._json_rows(batch, dets, n_eff, n_img)
            if args.plots and n_img == 0:
                self._plot_first_batch(batch, dets, n_eff)
            self.update_metrics(dets[:n_eff], _trim_batch(batch, n_eff), batch["img"].shape[1:3])
            n_img += n_eff
        results = self.finalize_metrics()
        if args.save_json and self.jdict:
            save_dir = Path(args.save_dir)
            save_dir.mkdir(parents=True, exist_ok=True)
            out_path = save_dir / "predictions.json"
            out_path.write_text(json.dumps(self.jdict))
            LOGGER.info(f"saved {len(self.jdict)} predictions to {out_path}")
            from sar_yolo_tpu_torch.utils.coco_eval import eval_json
            try:
                results.update(eval_json(self.jdict, {"annotations": self.gt_anns}))
            except Exception as e:  # noqa: BLE001 — the audit pass never fails a val run
                LOGGER.warning(f"COCO eval failed: {e}")
        if self.confusion_matrix is not None and n_img:
            try:
                save_dir = self._save_dir()
                self.confusion_matrix.plot(save_dir / "confusion_matrix.png",
                                           names=self.data.get("names"))
            except Exception as e:  # noqa: BLE001 — plots never fail a val run
                LOGGER.warning(f"confusion matrix plot failed: {e}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if n_img:
            results["speed/ms_per_image"] = (time.perf_counter() - t0) / n_img * 1000
        self.print_results(results, n_img)
        return results

    @staticmethod
    def preprocess(img_u8: np.ndarray, device) -> torch.Tensor:
        """(B, H, W, 3) uint8 RGB -> (B, 3, H, W) float32 / 255 on the device."""
        return torch.from_numpy(img_u8).to(device).permute(0, 3, 1, 2).float() / 255.0

    @staticmethod
    def _to_host(out):
        """The device result -> numpy (rows, prototypes or None), in one copy to the host."""
        if not isinstance(out, tuple):
            return out.cpu().numpy(), None
        dets, protos = out
        flat = torch.cat([dets.float().flatten(), protos.float().flatten()]).cpu().numpy()
        n = dets.numel()
        return flat[:n].reshape(dets.shape), flat[n:].reshape(protos.shape)

    @torch.no_grad()
    def predict(self, model, x: torch.Tensor):
        """Eval forward, then decode and NMS: (B, max_det, 6 + E + S) on the device; a segment
        model's (rows, prototypes); with `use_tta` the three passes' rows (B, max_det, 6)."""
        if self.use_tta:
            meta, args = self.meta, self.args
            preds = forward_tta(model, x, meta["strides"], meta["nc"], meta["reg_max"])
            return non_max_suppression(preds, conf_thres=self.conf, iou_thres=args.iou,
                                       max_det=args.max_det, nc=meta["nc"])
        out = model(x)
        if isinstance(out, tuple):
            return self.postprocess(out[0]), out[1]
        return self.postprocess(out)

    def postprocess(self, feats) -> torch.Tensor:
        """Decode and NMS of the head maps; multi-label for nc > 1, as the
        Ultralytics validator does, and the JDE embeddings gathered after NMS; a v10
        head's maps take the NMS-free top-k instead."""
        meta, args = self.meta, self.args
        nc, emb_dim = meta["nc"], meta.get("embed_dim") or 0
        preds = decode_detect(feats, meta["strides"], nc, meta["reg_max"],
                              extra_sigmoid=meta.get("state_classes") or 0,
                              split_extras=emb_dim,
                              kpt_shape=meta["kpt_shape"] if meta.get("head") == "Pose" else None)
        bank = None
        if emb_dim:
            preds, bank = preds
        if meta.get("head") == "v10Detect":
            return postprocess_end2end(preds, max_det=args.max_det, conf_thres=self.conf, nc=nc)
        return non_max_suppression(preds, conf_thres=self.conf, iou_thres=args.iou,
                                   max_det=args.max_det, nc=nc, extras_bank=bank,
                                   multi_label=nc > 1)

    # ---- hooks -----------------------------------------------------------
    def init_metrics(self):
        self.det_metrics = DetMetrics(self.data.get("names"))
        self.confusion_matrix = ConfusionMatrix(self.meta["nc"]) \
            if self.args.plots and self.confusion else None

    SCALE_DTYPE = np.float32  # of the gt boxes' pixel scale

    def update_metrics(self, dets, batch, hw):
        h, w = hw
        scale = np.array([w, h, w, h], self.SCALE_DTYPE)
        for bi in range(dets.shape[0]):
            d = dets[bi]
            d = d[d[:, 4] > 0]
            gt_mask = batch["mask"][bi] > 0
            gt_cls = batch["cls"][bi][gt_mask]
            gb = batch["bboxes"][bi][gt_mask] * scale  # xywh pixels
            gt_boxes = np.stack([gb[:, 0] - gb[:, 2] / 2, gb[:, 1] - gb[:, 3] / 2,
                                 gb[:, 0] + gb[:, 2] / 2, gb[:, 1] + gb[:, 3] / 2], 1) \
                if len(gb) else np.zeros((0, 4), np.float32)
            tp = match_predictions(d[:, :4], d[:, 5], gt_boxes, gt_cls)
            self.det_metrics.update(tp, d[:, 4], d[:, 5], gt_cls)
            if self.confusion_matrix is not None:
                self.confusion_matrix.process_batch(d, gt_boxes, gt_cls)
            self._extra_update(d, gt_boxes, gt_cls, batch, bi)

    def _extra_update(self, d, gt_boxes, gt_cls, batch, bi):
        pass

    def _save_dir(self) -> Path:
        save_dir = Path(getattr(self.args, "save_dir", None) or ".")
        save_dir.mkdir(parents=True, exist_ok=True)
        return save_dir

    def _plot_first_batch(self, batch, dets, n_eff):
        """val_batch0_labels.jpg (the whole batch's ground truth, padded rows too) and
        val_batch0_pred.jpg (the first n_eff images' rows at max(conf, 0.25) and the task's
        overlays)."""
        try:
            save_dir = self._save_dir()
            names = self.data.get("names")
            plot_images({k: v for k, v in batch.items()
                         if k in ("img", "bboxes", "mask", "cls", "masks", "keypoints")},
                        save_dir / "val_batch0_labels.jpg", names=names)
            plot_predictions(batch["img"], list(dets[:n_eff]), save_dir / "val_batch0_pred.jpg",
                             names=names, conf=max(self.conf, 0.25), rotated=self.ROTATED,
                             **self._plot_pred_extras(batch, dets, n_eff))
        except Exception as e:  # noqa: BLE001 — plots never fail a val run
            LOGGER.warning(f"val batch plotting failed: {e}")

    def _plot_pred_extras(self, batch, dets, n_eff) -> dict:
        """The task's plot_predictions overlays (keypoints, masks)."""
        return {}

    def _native_params(self, batch, bi, h, w, n_img):
        """(stem, ratio, padx, pady, ori_h, ori_w) for un-letterboxing one image, shared
        by save_txt and save_json."""
        if "im_file" in batch:
            stem = Path(str(batch["im_file"][bi])).stem
            rt, padx, pady = (float(v) for v in batch["ratio_pad"][bi])
            oh, ow = (float(v) for v in batch["ori_shape"][bi])
            return stem, rt, padx, pady, oh, ow
        return f"image{n_img + bi}", 1.0, 0.0, 0.0, float(h), float(w)

    def _json_rows(self, batch, dets, n_eff, n_img):
        """COCO-style prediction and GT rows of a batch: boxes in native image pixels,
        ids from the file stem (sequential ids and letterbox space on synthetic data)."""
        h, w = batch["img"].shape[1:3]
        scale = np.array([w, h, w, h], np.float32)
        for bi in range(n_eff):
            d = dets[bi]
            stem, rt, padx, pady, oh, ow = self._native_params(batch, bi, h, w, n_img)
            if "im_file" in batch:
                image_id = int(stem) if stem.isnumeric() else stem
            else:
                image_id = n_img + bi

            def to_native(x1, y1, x2, y2):
                x1, y1, x2, y2 = float(x1), float(y1), float(x2), float(y2)
                x1 = min(max((x1 - padx) / rt, 0.0), ow)
                x2 = min(max((x2 - padx) / rt, 0.0), ow)
                y1 = min(max((y1 - pady) / rt, 0.0), oh)
                y2 = min(max((y2 - pady) / rt, 0.0), oh)
                return [round(x1, 3), round(y1, 3), round(x2 - x1, 3), round(y2 - y1, 3)]

            for row in d[d[:, 4] > 0]:
                self.jdict.append({"image_id": image_id, "category_id": self._cat_id(row[5]),
                                   "bbox": to_native(*(float(v) for v in row[:4])),
                                   "score": round(float(row[4]), 5)})
            gmask = batch["mask"][bi] > 0
            gb = batch["bboxes"][bi][gmask] * scale  # xywh center, pixels
            for (cx, cy, bw, bh), c in zip(gb, batch["cls"][bi][gmask]):
                self.gt_anns.append({"image_id": image_id, "category_id": self._cat_id(c),
                                     "bbox": to_native(cx - bw / 2, cy - bh / 2,
                                                       cx + bw / 2, cy + bh / 2)})

    CONF = 4  # the rows' confidence column (the class follows it)

    def _save_txt_batch(self, batch, dets, n_eff, n_img):
        """Per-image YOLO-format label files in native normalized coordinates, the
        confidence appended with save_conf (`_txt_line` writes each row)."""
        args = self.args
        if not args.save_txt:
            return
        lbl_dir = Path(args.save_dir) / "labels"
        lbl_dir.mkdir(parents=True, exist_ok=True)
        h, w = batch["img"].shape[1:3]
        for bi in range(n_eff):
            d = dets[bi]
            stem, *native = self._native_params(batch, bi, h, w, n_img)
            lines = [self._txt_line(row, *native) + (f" {float(row[self.CONF]):.6f}"
                                                     if args.save_conf else "")
                     for row in d[d[:, self.CONF] > 0]]
            (lbl_dir / f"{stem}.txt").write_text("\n".join(lines) + ("\n" if lines else ""))

    @staticmethod
    def _txt_line(row, rt, padx, pady, oh, ow) -> str:
        """`cls cx cy w h` of a row [x1 y1 x2 y2 conf cls ...], the box clipped to the image."""
        x1 = min(max((float(row[0]) - padx) / rt, 0.0), ow)
        x2 = min(max((float(row[2]) - padx) / rt, 0.0), ow)
        y1 = min(max((float(row[1]) - pady) / rt, 0.0), oh)
        y2 = min(max((float(row[3]) - pady) / rt, 0.0), oh)
        return (f"{int(row[5])} {(x1 + x2) / 2 / ow:.6f} {(y1 + y2) / 2 / oh:.6f} "
                f"{(x2 - x1) / ow:.6f} {(y2 - y1) / oh:.6f}")

    def finalize_metrics(self) -> dict:
        return self.det_metrics.process()

    def print_results(self, results, n_img):
        if results:
            LOGGER.info("  ".join(f"{k.split('/')[-1]}={v:.4f}" for k, v in results.items()))
        # per-class table (verbose, more than one class)
        pc = getattr(self.det_metrics, "per_class", None)
        if pc is not None and self.args.verbose and len(pc["unique_classes"]) > 1:
            names = self.data.get("names") or {}
            LOGGER.info(f"{'class':>16} {'instances':>10} {'P':>8} {'R':>8} "
                        f"{'mAP50':>8} {'mAP50-95':>9}")
            for ci, c in enumerate(pc["unique_classes"]):
                LOGGER.info(f"{str(names.get(int(c), int(c))):>16} {pc['nt'][ci]:>10} "
                            f"{pc['p'][ci]:>8.3f} {pc['r'][ci]:>8.3f} "
                            f"{pc['ap'][ci, 0]:>8.3f} {pc['ap'][ci].mean():>9.3f}")


class DetectionValidator(BaseValidator):
    pass


class RTDETRValidator(BaseValidator):
    """RT-DETR: the last decoder layer's queries scored without NMS (the JAX package's
    `RTDETRValidator`). The boxes and sigmoided scores (B, nq, 4 + nc) come to the host in
    one copy; per image, as the JAX validator does in numpy: the best class, rows under conf
    dropped, boxes to the batch's pixels in float64, the rest in score order
    (`np.argsort(-conf)`) cut at max_det, zero rows after them. `rect` is not used: the
    JAX validator loads square batches."""

    rect_ok = False
    confusion = False       # the JAX RT-DETR validator updates and draws none
    SCALE_DTYPE = np.int64  # the JAX validator scales boxes by an integer array (float64)

    @torch.no_grad()
    def predict(self, model, x: torch.Tensor):
        dec_b, dec_s = model(x)[:2]
        self._hw = tuple(x.shape[2:])
        return torch.cat([dec_b[-1].float(), torch.sigmoid(dec_s[-1]).float()], -1)

    def _to_host(self, out):
        out = out.cpu().numpy()
        h, w = self._hw
        rows = np.zeros((len(out), self.args.max_det, 6))
        for bi, o in enumerate(out):
            s = o[:, 4:]
            cls_conf = s.max(-1)
            keep = cls_conf >= self.conf
            b = o[keep, :4] * np.array([w, h, w, h])
            d = np.concatenate([np.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
                                          b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2], 1),
                                cls_conf[keep, None], s[keep].argmax(-1)[:, None]], 1)
            d = d[np.argsort(-d[:, 4])][:self.args.max_det]
            rows[bi, :len(d)] = d
        return rows, None


class JDEValidator(BaseValidator):
    """Box mAP plus the posture-state and ReID metrics of the JDE fork.

    Detections carry [x1, y1, x2, y2, conf, cls, emb(E), state(S)]. Metrics:
      * state accuracy, the state confusion matrix, macro P/R/F1 and the per-state
        table, over detections matched one to one (greedy by IoU >= 0.5) to a GT;
      * the state-detection mAP, a second pass with the argmax state as the class,
        keyed (S);
      * ReID cosine and euclidean pos/neg means and separation, the cosine
        silhouette and the Davies-Bouldin index of the matched embeddings by tag;
      * one row per run appended to `jde_results.csv`, mirrored to `jde_results.xlsx`.
    State ground truth is clamp(tag, 0, state_classes - 1), as in the loss, not tag % S.
    """

    def init_metrics(self):
        super().init_metrics()
        self.state_correct = 0
        self.state_total = 0
        self.embeds = []
        self.embed_tags = []
        sc = self.meta.get("state_classes") or 0
        self.state_confusion = np.zeros((sc, sc), np.int64) if sc else None
        self.state_det_metrics = DetMetrics(
            {i: f"state{i}" for i in range(sc)}) if sc else None

    @staticmethod
    def _state_gt(tags, sc):
        """Clamp person-id tags into the state label range."""
        return np.clip(tags.astype(int), 0, sc - 1)

    def _extra_update(self, d, gt_boxes, gt_cls, batch, bi):
        if "tags" not in batch:
            return
        embed_dim = self.meta["embed_dim"]
        sc = self.meta["state_classes"] or 0
        gt_mask = batch["mask"][bi] > 0
        gt_tags = batch["tags"][bi][gt_mask].astype(int)
        # the state-detection mAP pass: argmax state as the class
        if sc:
            ps = d[:, 6 + embed_dim:6 + embed_dim + sc].argmax(1) if len(d) else np.zeros(0)
            gs = self._state_gt(gt_tags, sc).astype(np.float32)
            tp = match_predictions(d[:, :4], ps.astype(np.float32), gt_boxes, gs)
            self.state_det_metrics.update(tp, d[:, 4], ps.astype(np.float32), gs)
        if len(d) == 0 or len(gt_boxes) == 0:
            return
        iou = box_iou_np(gt_boxes, d[:, :4])
        # one-to-one GT-prediction pairs, greedy by IoU (>= 0.5): each prediction
        # credits at most one GT
        pairs = np.argwhere(iou >= 0.5)
        if len(pairs) == 0:
            return
        pairs = pairs[iou[pairs[:, 0], pairs[:, 1]].argsort()[::-1]]
        used_g = np.zeros(len(gt_boxes), bool)
        used_p = np.zeros(len(d), bool)
        for g, p in pairs:
            if used_g[g] or used_p[p]:
                continue
            used_g[g] = used_p[p] = True
            self.embeds.append(d[p, 6:6 + embed_dim])
            self.embed_tags.append(gt_tags[g])
            if sc:
                state_pred = int(d[p, 6 + embed_dim:6 + embed_dim + sc].argmax())
                state_gt = int(self._state_gt(gt_tags[g:g + 1], sc)[0])
                self.state_correct += int(state_pred == state_gt)
                self.state_total += 1
                self.state_confusion[state_pred, state_gt] += 1

    def finalize_metrics(self) -> dict:
        results = super().finalize_metrics()
        if self.state_total:
            results["metrics/state_acc"] = self.state_correct / self.state_total
            cm = self.state_confusion
            tp = np.diag(cm).astype(np.float64)
            pred_n = cm.sum(1)
            gt_n = cm.sum(0)
            prec = np.where(pred_n > 0, tp / np.maximum(pred_n, 1), 0.0)
            rec = np.where(gt_n > 0, tp / np.maximum(gt_n, 1), 0.0)
            f1 = np.where(prec + rec > 0, 2 * prec * rec / np.maximum(prec + rec, 1e-9), 0.0)
            seen = gt_n > 0
            if seen.any():
                results["metrics/state_macro_precision"] = float(prec[seen].mean())
                results["metrics/state_macro_recall"] = float(rec[seen].mean())
                results["metrics/state_macro_f1"] = float(f1[seen].mean())
            self.state_table = {"precision": prec, "recall": rec, "f1": f1, "support": gt_n}
        if self.state_det_metrics is not None:
            sd = self.state_det_metrics.process()
            for k in ("metrics/mAP50(B)", "metrics/mAP50-95(B)"):
                if k in sd:
                    results[k.replace("(B)", "(S)")] = sd[k]
        if len(self.embeds) >= 2:
            E = np.stack(self.embeds)
            En = E / (np.linalg.norm(E, axis=1, keepdims=True) + 1e-9)
            tags = np.asarray(self.embed_tags)
            sim = En @ En.T
            same = tags[:, None] == tags[None, :]
            off = ~np.eye(len(E), dtype=bool)
            pos, neg = sim[same & off], sim[~same]
            if len(pos) and len(neg):
                results["metrics/reid_pos_cos"] = float(pos.mean())
                results["metrics/reid_neg_cos"] = float(neg.mean())
                results["metrics/reid_separation"] = float(pos.mean() - neg.mean())
                d2 = ((E[:, None, :] - E[None, :, :]) ** 2).sum(-1) ** 0.5
                results["metrics/reid_pos_euc"] = float(d2[same & off].mean())
                results["metrics/reid_neg_euc"] = float(d2[~same].mean())
            n_ids = len(np.unique(tags))
            if 2 <= n_ids < len(E):  # clustering quality
                results["metrics/reid_silhouette"] = silhouette_cosine(En, tags)
                results["metrics/reid_davies_bouldin"] = davies_bouldin(En, tags)
        self._export_consolidated(results)
        return results

    def _export_consolidated(self, results):
        """Append one row per run to the cumulative `jde_results.csv` and mirror the whole
        table into `jde_results.xlsx`."""
        save_dir = Path(self.args.save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        path = save_dir / "jde_results.csv"
        row = {"timestamp": datetime.now().isoformat(timespec="seconds"),
               "model": str(self.args.model or "")}
        row.update({k.split("/")[-1]: f"{v:.5f}" for k, v in results.items()
                    if isinstance(v, float)})
        exists = path.exists()
        with path.open("a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row))
            if not exists:
                w.writeheader()
            w.writerow(row)
        try:  # the Excel mirror never fails a val run
            from sar_yolo_tpu_torch.utils.xlsx import write_xlsx
            with path.open(newline="") as f:
                rows = list(csv.DictReader(f))
            write_xlsx(save_dir / "jde_results.xlsx", rows)
        except Exception as e:  # noqa: BLE001
            LOGGER.warning(f"jde_results.xlsx export failed: {e}")

    def print_results(self, results, n_img):
        super().print_results(results, n_img)
        table = getattr(self, "state_table", None)
        if table is not None:
            names = self.data.get("person_states") or {}
            LOGGER.info(f"{'State':>12} {'Support':>8} {'Prec':>7} {'Rec':>7} {'F1':>7}")
            for i in range(len(table["precision"])):
                name = names.get(i, f"state{i}") if isinstance(names, dict) else f"state{i}"
                LOGGER.info(f"{name:>12} {int(table['support'][i]):>8} "
                            f"{table['precision'][i]:>7.3f} {table['recall'][i]:>7.3f} "
                            f"{table['f1'][i]:>7.3f}")


def _greedy_tp(score: np.ndarray) -> np.ndarray:
    """(n_pred, len(IOU_THRESHOLDS)) true positives of a (G, P) similarity (OKS or mask IoU):
    at each threshold the pairs at or over it, best first, each ground truth and each
    prediction used once."""
    tp = np.zeros((score.shape[1], len(IOU_THRESHOLDS)), bool)
    for t, thr in enumerate(IOU_THRESHOLDS):
        gi, pi = np.nonzero(score >= thr)
        order = score[gi, pi].argsort()[::-1]
        seen_g, seen_p = set(), set()
        for g, p in zip(gi[order], pi[order]):
            if g in seen_g or p in seen_p:
                continue
            seen_g.add(g)
            seen_p.add(p)
            tp[p, t] = True
    return tp


def _oks_matrix(gt_kpts, gt_areas, pred_kpts, sigmas):
    """OKS between gt (G, K, 3) and predicted (P, K, >= 2) keypoints."""
    d = ((gt_kpts[:, None, :, 0] - pred_kpts[None, :, :, 0]) ** 2 +
         (gt_kpts[:, None, :, 1] - pred_kpts[None, :, :, 1]) ** 2)  # (G, P, K)
    vis = gt_kpts[:, None, :, 2] > 0
    e = d / (2 * sigmas[None, None, :]) ** 2 / (gt_areas[:, None, None] + 1e-9) / 2
    return (np.exp(-e) * vis).sum(-1) / np.maximum(vis.sum(-1), 1)


class PoseValidator(BaseValidator):
    """Box mAP plus keypoint mAP under the `(P)` keys: predictions matched to the ground
    truth by OKS (COCO's sigmas for 17 keypoints, else 1 / K; the gt area is its box's
    times 0.53) over the IoU thresholds 0.5:0.95, class-blind as in the JAX package."""

    def init_metrics(self):
        super().init_metrics()
        self.pose_metrics = DetMetrics(self.data.get("names"))
        K = self.meta["kpt_shape"][0]
        self.sigmas = OKS_SIGMA.numpy().astype(np.float32) if K == 17 else np.ones(K) / K

    def _extra_update(self, d, gt_boxes, gt_cls, batch, bi):
        if "keypoints" not in batch:
            return
        K, kd = self.meta["kpt_shape"]
        h, w = batch["img"].shape[1:3]
        gt_kpts = batch["keypoints"][bi][batch["mask"][bi] > 0].copy()  # normalized
        gt_kpts[..., 0] *= w
        gt_kpts[..., 1] *= h
        gt_areas = ((gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])) * 0.53
        tp = np.zeros((len(d), len(IOU_THRESHOLDS)), bool)
        if len(gt_kpts) and len(d):
            tp = _greedy_tp(_oks_matrix(gt_kpts, gt_areas, d[:, 6:6 + K * kd].reshape(-1, K, kd),
                                        self.sigmas))
        self.pose_metrics.update(tp, d[:, 4], d[:, 5], gt_cls)

    def _plot_pred_extras(self, batch, dets, n_eff) -> dict:
        K, kd = self.meta["kpt_shape"]
        return {"kpts": [np.asarray(dets[bi])[:, 6:6 + K * kd].reshape(-1, K, kd)
                         if len(dets[bi]) else None for bi in range(min(n_eff, len(dets)))]}

    def finalize_metrics(self) -> dict:
        results = super().finalize_metrics()
        for k, v in self.pose_metrics.process().items():
            if k.startswith("metrics/"):
                results[k.replace("(B)", "(P)")] = v
        return results


class SegmentValidator(BaseValidator):
    """Box mAP plus mask mAP under the `(M)` keys: each prediction's mask (`process_mask` at
    the prototypes' resolution) matched by mask IoU, per class, over the IoU thresholds
    0.5:0.95 to the ground truth's overlap map, resized to the prototypes' grid by OpenCV's
    INTER_NEAREST where it differs (a rect batch's masks are square, as in the JAX
    package)."""

    def init_metrics(self):
        super().init_metrics()
        self.mask_metrics = DetMetrics(self.data.get("names"))

    def _extra_update(self, d, gt_boxes, gt_cls, batch, bi):
        if "masks" not in batch or self._protos is None or len(d) == 0:
            return
        nm = self.meta["nm"]
        h, w = batch["img"].shape[1:3]
        pred = process_mask(torch.from_numpy(self._protos[bi]), torch.from_numpy(d[:, 6:6 + nm]),
                            torch.from_numpy(d[:, :4]), (h, w)).numpy()  # (n, mh, mw) bool
        mh, mw = pred.shape[1:]
        overlap = batch["masks"][bi]
        if overlap.shape != (mh, mw):
            overlap = resize_nearest_cv(overlap, (mw, mh))
        gt_ids = np.nonzero(batch["mask"][bi] > 0)[0]
        gt = np.stack([overlap == g + 1 for g in gt_ids]) if len(gt_ids) else \
            np.zeros((0, mh, mw), bool)
        tp = np.zeros((len(d), len(IOU_THRESHOLDS)), bool)
        if len(gt):
            inter = (gt[:, None] & pred[None]).sum((-1, -2)).astype(np.float64)
            union = (gt[:, None] | pred[None]).sum((-1, -2)) + 1e-9
            tp = _greedy_tp(inter / union * (gt_cls[:, None] == d[None, :, 5]))
        self.mask_metrics.update(tp, d[:, 4], d[:, 5], gt_cls)

    def _plot_pred_extras(self, batch, dets, n_eff) -> dict:
        """Each image's masks (`process_mask` at the prototypes' resolution), row-aligned;
        only the rows the mosaic draws (conf >= max(conf, 0.25)) are computed, the others
        None."""
        if self._protos is None:
            return {}
        nm, thr = self.meta["nm"], max(self.conf, 0.25)
        h, w = batch["img"].shape[1:3]
        masks = []
        for bi in range(min(n_eff, len(dets))):
            d = dets[bi]
            drawn = np.flatnonzero(d[:, 4] >= thr)
            rows = [None] * len(d)
            if len(drawn):
                m = process_mask(torch.from_numpy(self._protos[bi]),
                                 torch.from_numpy(np.ascontiguousarray(d[drawn, 6:6 + nm])),
                                 torch.from_numpy(np.ascontiguousarray(d[drawn, :4])),
                                 (h, w)).numpy()
                for k, ri in enumerate(drawn):
                    rows[ri] = m[k]
            masks.append(rows)
        return {"masks": masks}

    def finalize_metrics(self) -> dict:
        results = super().finalize_metrics()
        for k, v in self.mask_metrics.process().items():
            if k.startswith("metrics/"):
                results[k.replace("(B)", "(M)")] = v
        return results


class OBBValidator(BaseValidator):
    """Rotated-box mAP under the `(B)` keys: rows [cx, cy, w, h, r, conf, cls] from the
    rotated decode and NMS, matched to the ground truth per class by probiou (float32 on the
    host) over the IoU thresholds 0.5:0.95, each threshold's pairs best first. `save_txt`
    writes xywhr rows; no COCO json, as in the JAX package. `plots` draws the rotated
    mosaics and no confusion matrix."""

    confusion = False
    ROTATED = True

    def postprocess(self, feats) -> torch.Tensor:
        meta, args = self.meta, self.args
        preds = decode_obb(feats, meta["strides"], meta["nc"], meta["reg_max"])
        return non_max_suppression_rotated(preds, conf_thres=self.conf, iou_thres=args.iou,
                                           max_det=args.max_det, nc=meta["nc"])

    def update_metrics(self, dets, batch, hw):
        h, w = hw
        for bi in range(dets.shape[0]):
            d = dets[bi]
            d = d[d[:, 5] > 0]
            gt_mask = batch["mask"][bi] > 0
            gt_cls = batch["cls"][bi][gt_mask]
            gb = batch["bboxes"][bi][gt_mask]
            gt5 = np.concatenate([gb[:, :4] * np.array([w, h, w, h]), gb[:, 4:5]], 1) \
                if len(gb) else np.zeros((0, 5), np.float32)
            tp = np.zeros((len(d), len(IOU_THRESHOLDS)), bool)
            if len(d) and len(gt5):
                iou = probiou(torch.from_numpy(gt5.astype(np.float32))[:, None],
                              torch.from_numpy(d[:, :5])[None]).squeeze(-1).numpy()
                tp = _greedy_tp(iou * (gt_cls[:, None] == d[None, :, 6]))
            self.det_metrics.update(tp, d[:, 5], d[:, 6], gt_cls)

    def _json_rows(self, batch, dets, n_eff, n_img):
        """No COCO rows for rotated boxes (the JAX package's OBB validator writes none)."""

    CONF = 5

    @staticmethod
    def _txt_line(row, rt, padx, pady, oh, ow) -> str:
        """`cls cx cy w h r` of a rotated row: the centre clipped to the image, w and h over
        the native size, the angle in radians."""
        cx = min(max((float(row[0]) - padx) / rt, 0.0), ow)
        cy = min(max((float(row[1]) - pady) / rt, 0.0), oh)
        return (f"{int(row[6])} {cx / ow:.6f} {cy / oh:.6f} {float(row[2]) / rt / ow:.6f} "
                f"{float(row[3]) / rt / oh:.6f} {float(row[4]):.6f}")


class ClassificationValidator(BaseValidator):
    """Top-1 and top-5 accuracy of the logits (ranked on the host by
    `np.argsort(-logits, axis=1)`, the JAX package's call, so that ties order alike); the
    padded tail rows are dropped; `fitness` is the top-1 accuracy."""

    def __call__(self, model, meta: dict, dataset, args, data: dict | None = None) -> dict:
        self.args, self.meta, self.data = args, meta, data or {}
        self.det_metrics = None
        device = next(model.parameters()).device
        bs = min(args.batch, len(dataset))
        mesh = mesh_replicas(model, args, bs, device)
        loader = DataLoader(dataset, bs, workers=args.workers, shuffle=False, drop_last=False,
                            pad_last=True)
        top1 = top5 = n = 0
        t0 = time.perf_counter()
        for batch in loader:
            npad = int(batch.pop("_pad", 0))
            with torch.no_grad():
                outs = [m(self.preprocess(img, d)).float()
                        for m, d, img in mesh_shares(mesh, model, device, batch["img"])]
            logits = np.concatenate([o.cpu().numpy() for o in outs])
            labels = batch["cls"].astype(int).reshape(-1)
            if npad:
                logits, labels = logits[:-npad], labels[:-npad]
            order = np.argsort(-logits, axis=1)
            top1 += int((order[:, 0] == labels).sum())
            top5 += int(sum(labels[i] in order[i, :5] for i in range(len(labels))))
            n += len(labels)
        results = {"metrics/accuracy_top1": top1 / max(n, 1),
                   "metrics/accuracy_top5": top5 / max(n, 1), "fitness": top1 / max(n, 1)}
        if n:
            results["speed/ms_per_image"] = (time.perf_counter() - t0) / n * 1000
        self.print_results(results, n)
        return results
