"""AutoBackend: one forward over the port's exported artifacts, and the predictor that serves
them (port of `sar_yolo_tpu/nn/autobackend.py`).

  * `.pt2`            -> `torch.export.load(...).module()` on the device it was traced on
                         (the sidecar's `device`); another device raises
  * `.onnx`           -> the port's numpy runtime (`export/onnx_runtime.py`) on the host;
                         onnxruntime, which the JAX package prefers, is installed neither
                         here nor on the card
  * checkpoint folder -> the native path: the BN-folded model's raw serving program

Every artifact carries the JSON sidecar the exporter writes (imgsz, nc, names, task,
with_nms, ...). `AutoBackend(path, device)(img_u8)` takes a (B, imgsz, imgsz, 3) uint8 RGB
letterboxed batch and returns torch tensors on `device`: (B, N, 4+nc+E) raw predictions, or
(B, max_det, 6+E) detections when the artifact embeds NMS (a segment artifact: a pair).
The JAX package's `stablehlo` and TF artifacts raise NotImplementedError.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from sar_yolo_tpu_torch.utils import select_device
from sar_yolo_tpu_torch.utils.checkpoint import is_checkpoint

# artifacts of the JAX package that the port does not read
JAX_ONLY = (".stablehlo", ".tflite", ".pb", "_saved_model")


def _load_sidecar(path: Path) -> dict:
    side = Path(f"{path}.json")
    return json.loads(side.read_text()) if side.is_file() else {}


def _on_device(device) -> torch.device:
    """`device` with its index (cuda -> cuda:<current>), as a traced program names it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class AutoBackend:
    """Load a `.pt2` or `.onnx` artifact (or a checkpoint folder) and expose one
    `__call__(img_u8)`; `device`: where the outputs land (None: cuda, raising without it)."""

    def __init__(self, weights, device=None):
        p = Path(weights)
        self.path = p
        self.device = select_device(device)
        self.meta = _load_sidecar(p)
        self.kind = self._detect_kind(p)
        getattr(self, f"_init_{self.kind}")(p)

    @staticmethod
    def _detect_kind(p: Path) -> str:
        s = p.name.lower()
        if s.endswith(".pt2"):
            return "pt2"
        if s.endswith(".onnx"):
            return "onnx"
        if s.endswith(JAX_ONLY):
            raise NotImplementedError(f"{p}: the port serves .pt2 and .onnx artifacts; the "
                                      "JAX package's StableHLO and TF artifacts need it")
        if is_checkpoint(p):
            return "native"
        raise ValueError(f"unrecognized model artifact: {p}")

    @staticmethod
    def is_exported_artifact(p) -> bool:
        return Path(str(p)).name.lower().endswith((".pt2", ".onnx", *JAX_ONLY))

    def _init_pt2(self, p):
        # deserialising a program that holds the area-attention op needs the op registered
        import sar_yolo_tpu_torch.ops.cuda.flash_attention  # noqa: F401

        traced = self.meta.get("device")
        if traced is None:
            raise ValueError(f"{p}: its sidecar {p}.json names no `device`; the program runs "
                             "only on the device it was traced on")
        if _on_device(traced) != _on_device(self.device):
            raise ValueError(f"{p} was traced on {traced} and serves there only (its "
                             f"constants are baked for it), not on {self.device}; export it "
                             f"again from a model on {self.device}")
        self.device = _on_device(traced)
        self.module = torch.export.load(str(p)).module()
        self._fn = lambda img: self.module(img.to(self.device))

    def _init_onnx(self, p):
        from sar_yolo_tpu_torch.export.onnx_runtime import OnnxReferenceRuntime
        run = OnnxReferenceRuntime(str(p))
        self._fn = lambda img: _to_torch(run(img.cpu().numpy()), self.device)

    def _init_native(self, p):
        from sar_yolo_tpu_torch.engine.exporter import ServingProgram
        from sar_yolo_tpu_torch.engine.model import YOLO
        yolo = YOLO(p, device=self.device)
        self.meta = {"nc": yolo.meta["nc"], "task": yolo.task, "names": yolo.names,
                     "with_nms": False, **self.meta}
        for k in ("kpt_shape", "embed_dim", "state_classes"):
            if yolo.meta.get(k):
                self.meta.setdefault(k, yolo.meta[k])
        program = ServingProgram(yolo._fused_for_serving(), yolo.meta, yolo.task, False, 0.7,
                                 300).eval()
        self._fn = lambda img: program(img.to(self.device))

    def __call__(self, img_u8):
        """img_u8: (B, imgsz, imgsz, 3) uint8 RGB letterboxed batch (numpy or torch).
        Returns a tensor, or a tuple of them (segment), on the backend's device."""
        x = torch.as_tensor(np.asarray(img_u8) if not torch.is_tensor(img_u8) else img_u8)
        if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"expected a (B, H, W, 3) uint8 batch, got {tuple(x.shape)} "
                             f"{x.dtype}")
        with torch.no_grad():
            return self._fn(x)

    def warmup(self, imgsz: int | None = None):
        s = int(imgsz or self.meta.get("imgsz", 640))
        b = int((self.meta.get("input_shape") or [1])[0] or 1)
        self(np.zeros((b, s, s, 3), np.uint8))
        return self

    @property
    def with_nms(self) -> bool:
        return bool(self.meta.get("with_nms", False))


def _to_torch(outs, device):
    """The runtime's list of numpy outputs as one tensor, or a tuple of them, on `device`."""
    ts = tuple(torch.from_numpy(np.asarray(o)).to(device) for o in outs)
    return ts[0] if len(ts) == 1 else ts


class BackendPredictor:
    """Predictor over an AutoBackend artifact: the host letterbox (an exported program has
    one input signature), the artifact's forward, and the port's NMS on the backend's device
    when the artifact ships raw predictions; Results as the native predictors make them.
    `args`: conf (None: 0.25), iou, max_det, agnostic_nms. An embedded-NMS artifact
    thresholds at 0.25 when exported: a lower conf cannot add rows to it."""

    def __init__(self, backend: AutoBackend, args, names=None):
        self.backend = backend
        self.args = args
        meta = backend.meta
        self.imgsz = int(meta.get("imgsz") or
                         (args.imgsz if isinstance(args.imgsz, int) else args.imgsz[0]))
        self.nc = int(meta.get("nc", 80))
        self.task = meta.get("task") or "detect"
        self.names = names or {i: f"c{i}" for i in range(self.nc)}

    def __call__(self, source, stream: bool = False):
        gen = self._stream(source)
        return gen if stream else list(gen)

    def _stream(self, source):
        from sar_yolo_tpu_torch.data.augment import letterbox
        from sar_yolo_tpu_torch.data.loaders import load_inference_source

        loader, _ = load_inference_source(
            source, buffer=bool(getattr(self.args, "stream_buffer", False)))
        for path, img, meta in loader:
            t0 = time.perf_counter()
            lb, r, pad = letterbox(img, self.imgsz, scaleup=False)
            rgb = np.ascontiguousarray(lb[..., ::-1])[None]
            t1 = time.perf_counter()
            out = self.backend(rgb)
            if self.backend.device.type == "cuda":
                torch.cuda.synchronize(self.backend.device)
            t2 = time.perf_counter()
            res = self._postprocess(out, img, path, r, pad)
            res.speed = {"preprocess": (t1 - t0) * 1e3, "inference": (t2 - t1) * 1e3,
                         "postprocess": (time.perf_counter() - t2) * 1e3}
            res.frame = meta.get("frame")
            yield res

    def _nms(self, preds, conf: float):
        from sar_yolo_tpu_torch.ops.nms import non_max_suppression, non_max_suppression_rotated
        a = self.args
        if self.task == "obb":
            return non_max_suppression_rotated(preds, conf_thres=conf, iou_thres=a.iou,
                                               max_det=a.max_det, nc=self.nc)
        return non_max_suppression(preds, conf_thres=conf, iou_thres=a.iou, max_det=a.max_det,
                                   nc=self.nc, agnostic=a.agnostic_nms)

    def _postprocess(self, out, img, path, r: float, pad):
        """Results of one frame (batch of 1) in the frame's pixels."""
        from sar_yolo_tpu_torch.engine.results import Results
        from sar_yolo_tpu_torch.ops.masks import process_mask

        conf = self.args.conf if self.args.conf is not None else 0.25
        task, meta = self.task, self.backend.meta
        if task == "classify":
            return Results(img, path, self.names, probs=out[0].float().cpu().numpy())
        masks = None
        if task == "segment":
            a, b = out
            if self.backend.with_nms:
                dets, masks = a, b
            else:
                dets = self._nms(a, conf)
                masks = process_mask(b.permute(0, 3, 1, 2), dets[..., 6:], dets[..., :4],
                                     (self.imgsz, self.imgsz))
                dets = dets[..., :6]
        else:
            dets = out if self.backend.with_nms else self._nms(out, conf)
        d = dets[0].float().cpu().numpy()
        score = d[:, 5 if task == "obb" else 4]
        keep = (score > 0) & (score >= conf)
        d = d[keep].copy()
        dw, dh = pad
        if task == "obb":  # rows [cx, cy, w, h, r, conf, cls]
            d[:, :2] = (d[:, :2] - np.array([dw, dh])) / r
            d[:, 2:4] = d[:, 2:4] / r
            return Results(img, path, self.names, obb=d)
        h, w = img.shape[:2]
        d[:, :4] = (d[:, :4] - np.array([dw, dh, dw, dh])) / r
        d[:, [0, 2]] = d[:, [0, 2]].clip(0, w)
        d[:, [1, 3]] = d[:, [1, 3]].clip(0, h)
        if task == "segment":
            return Results(img, path, self.names, boxes=d[:, :6],
                           masks=masks[0].cpu().numpy()[keep])
        if task == "pose":
            K, D = meta.get("kpt_shape") or (17, 3)
            kpts = d[:, 6:6 + K * D].reshape(-1, K, D)
            kpts[..., :2] = (kpts[..., :2] - np.array([dw, dh])) / r
            return Results(img, path, self.names, boxes=d[:, :6], keypoints=kpts)
        if task == "jde":
            ed = int(meta.get("embed_dim") or 0)
            sc = int(meta.get("state_classes") or 0)
            states = d[:, 6 + ed:6 + ed + sc].argmax(-1) if sc else None
            return Results(img, path, self.names, boxes=d[:, :6],
                           embeds=d[:, 6:6 + ed] if ed else None, person_states=states)
        return Results(img, path, self.names, boxes=d[:, :6])
