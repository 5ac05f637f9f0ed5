"""Exporter: deployable artifacts of a served model (port of `sar_yolo_tpu/engine/exporter.py`).

Two formats, each with the JSON sidecar the JAX package writes (and one key more, `device`):

* `pt2`: the serving program (`ServingProgram`: uint8 input, the BN-folded float32 forward,
  decode, optionally NMS) through `torch.export.export`, saved with `torch.export.save`.
  The port's counterpart of the JAX package's `stablehlo` artifact: raw predictions or
  embedded NMS (`nms=True`), and with `dynamic=True` one program for any batch
  (`torch.export.Dim`). The area attention stays one `sar_yolo_tpu_torch::flash_area_attention`
  node per call, so that the program launches the hand-written kernel on the card. The
  program is traced on the model's device and the device is baked into it (every
  `arange` and `full`): the sidecar's `device` names it, and `AutoBackend` serves the
  artifact there only.
* `onnx`: raw predictions only, static batch 1, written by the port's own walker over the
  program's core-ATen graph (`export/onnx_export.py`); `nms=True` raises `ExportError`, as
  in the JAX package.

`stablehlo` raises ValueError naming `pt2`; the JAX package's TF formats (`saved_model`,
`tflite`, `pb`) come from jax2tf and raise NotImplementedError. RT-DETR and YOLO-World, which
the JAX exporter has no serving graph for, raise NotImplementedError too, as do `int8` and
`half` (the JAX package quantizes only in its TFLite export and ignores `half`).

The input of every artifact is the JAX package's: (B, imgsz, imgsz, 3) uint8 RGB, NHWC,
letterboxed; the cast, the division by 255 and the permute to NCHW are in the program.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from sar_yolo_tpu_torch.ops.decode import decode_detect, decode_obb
from sar_yolo_tpu_torch.ops.masks import process_mask
from sar_yolo_tpu_torch.ops.nms import non_max_suppression, non_max_suppression_rotated
from sar_yolo_tpu_torch.utils import LOGGER
from sar_yolo_tpu_torch.utils.errors import ExportError

EXPORT_FORMATS = ("pt2", "onnx")
EXPORT_CONF = 0.25  # the embedded NMS's threshold (the JAX exporter's)
# formats of the JAX package that the port does not write, and why
NOT_EXPORTED = {
    "stablehlo": (ValueError, "use format='pt2' (torch.export): the port's counterpart of the "
                              "JAX package's `stablehlo` artifact (it writes no StableHLO)"),
    "saved_model": (NotImplementedError, "the JAX package writes it through jax2tf, which "
                                         "the port has no counterpart of"),
    "tflite": (NotImplementedError, "the JAX package writes it through jax2tf, which the "
                                    "port has no counterpart of"),
    "pb": (NotImplementedError, "the JAX package writes it through jax2tf, which the port "
                                "has no counterpart of"),
}


def export_formats():
    """Table of the formats the port writes (the JAX package's `export_formats` rows)."""
    return [{"format": "pt2", "suffix": ".pt2", "args": ["dynamic", "nms"]},
            {"format": "onnx", "suffix": ".onnx", "args": ["opset"]}]


class ServingProgram(torch.nn.Module):
    """The task's serving graph of a (BN-folded) model, as the JAX `Exporter._build_infer_fn`
    writes it: (B, imgsz, imgsz, 3) uint8 RGB in; out:

      detect/jde  raw: (B, N, 4+nc+E) · nms: (B, max_det, 6+E)
      pose        raw/nms: + decoded keypoint pixels as trailing columns
      segment     raw: ((B, N, 4+nc+nm) preds, (B, Hp, Wp, nm) protos)
                  nms: ((B, max_det, 6), (B, max_det, Hp, Wp) bool masks at proto resolution)
      obb         raw: (B, N, 4+nc+1) · nms: (B, max_det, 7) xywhr+conf+cls
      classify    (B, nc) softmax probabilities

    With NMS a JDE program gathers the embeddings of the kept rows only (the bank path); its
    raw program keeps them inline."""

    def __init__(self, model, meta: dict, task: str, with_nms: bool, iou: float, max_det: int):
        super().__init__()
        self.model, self.meta, self.task = model, meta, task
        self.with_nms, self.iou, self.max_det = with_nms, iou, max_det

    def forward(self, img):
        x = img.permute(0, 3, 1, 2).contiguous().float() / 255.0
        meta, task = self.meta, self.task
        strides, nc = meta["strides"], meta["nc"]
        if task == "classify":
            return self.model(x).softmax(-1)
        if task == "segment":
            feats, protos = self.model(x)
            preds = decode_detect(feats, strides, nc, meta["reg_max"])
            if not self.with_nms:
                return preds, protos.permute(0, 2, 3, 1)
            dets = self._nms(preds)
            H = img.shape[1]
            return dets[..., :6], process_mask(protos, dets[..., 6:], dets[..., :4], (H, H))
        if task == "obb":
            preds = decode_obb(self.model(x), strides, nc, meta["reg_max"])
            if not self.with_nms:
                return preds
            return non_max_suppression_rotated(preds, conf_thres=EXPORT_CONF, iou_thres=self.iou,
                                               max_det=self.max_det, nc=nc)
        emb_dim = (meta.get("embed_dim") or 0) if self.with_nms else 0
        preds = decode_detect(self.model(x), strides, nc, meta["reg_max"],
                              extra_sigmoid=meta.get("state_classes") or 0,
                              kpt_shape=meta.get("kpt_shape") if task == "pose" else None,
                              split_extras=emb_dim)
        if not self.with_nms:
            return preds
        preds, bank = preds if emb_dim else (preds, None)
        return self._nms(preds, bank)

    def _nms(self, preds, bank=None):
        return non_max_suppression(preds, conf_thres=EXPORT_CONF, iou_thres=self.iou,
                                   max_det=self.max_det, nc=self.meta["nc"], extras_bank=bank)


def _output_note(task: str, nms: bool) -> str:
    """The sidecar's `output`, word for word the JAX package's."""
    return {
        "classify": "(B, nc) softmax probs",
        "segment": ("((B, max_det, 6) dets, (B, max_det, Hp, Wp) bool "
                    "masks at proto resolution Hp=H/4)" if nms else
                    "((B, N, 4+nc+nm) preds, (B, Hp, Wp, nm) protos)"),
        "obb": ("(B, max_det, 7) xywhr+conf+cls" if nms
                else "(B, N, 4+nc+1) raw preds, trailing angle"),
    }.get(task, "(B, max_det, 6+E) dets" if nms else "(B, N, 4+nc+E) raw preds")


def sidecar(args, meta: dict, task: str, imgsz: int, dynamic: bool, device) -> dict:
    """The metadata JSON (the JAX exporter's keys and values) plus the traced-on `device`."""
    nc = meta["nc"]
    out = {"input_shape": [None if dynamic else 1, imgsz, imgsz, 3], "input_dtype": "uint8",
           "imgsz": imgsz, "nc": nc, "task": task,
           "names": meta.get("names") or {i: f"c{i}" for i in range(nc)},
           "with_nms": bool(args.nms), "output": _output_note(task, bool(args.nms))}
    for k in ("kpt_shape", "embed_dim", "state_classes"):
        if meta.get(k):
            out[k] = list(meta[k]) if isinstance(meta[k], (tuple, list)) else meta[k]
    out["device"] = str(device)
    return out


class Exporter:
    """`Exporter(args)(model, meta, task)` writes the artifact of `args.format` under
    `args.project` (default `exports/`) as `<model stem>.<suffix>` with its sidecar
    `<artifact>.json`, and returns the artifact's path."""

    def __init__(self, args):
        self.args = args

    def __call__(self, model, meta: dict, task: str) -> str:
        args = self.args
        fmt = str(args.format).lower()
        if fmt in NOT_EXPORTED:
            err, why = NOT_EXPORTED[fmt]
            raise err(f"format='{fmt}': {why}")
        if fmt not in EXPORT_FORMATS:
            raise ValueError(f"Unsupported export format '{fmt}'. Available: {EXPORT_FORMATS}")
        if meta.get("head") in ("RTDETRDecoder", "WorldDetect"):
            raise NotImplementedError(f"export of a {meta['head']} model: the JAX package's "
                                      "exporter has no serving graph for it")
        for key, why in (("int8", "the JAX package quantizes only in its TFLite export"),
                         ("half", "the JAX package's exporter serves float32 only")):
            if getattr(args, key, False):
                raise NotImplementedError(f"export with {key}=True: {why}")
        if fmt == "onnx" and args.nms:
            raise ExportError(
                "format='onnx' exports the raw-predictions graph; embedded NMS uses "
                "on-device control flow with no ONNX mapping. Export with nms=False (NMS "
                "runs in the consumer), or use format='pt2' for an embedded-NMS artifact.")
        imgsz = args.imgsz if isinstance(args.imgsz, int) else args.imgsz[0]
        dynamic = bool(args.dynamic) and fmt == "pt2"
        out_dir = Path(args.project or "exports")
        out_dir.mkdir(parents=True, exist_ok=True)
        stem = Path(str(args.model or "model")).stem
        device = next(model.parameters()).device
        program = ServingProgram(model, meta, task, bool(args.nms), args.iou, args.max_det).eval()
        t0 = time.time()
        path = out_dir / f"{stem}.{fmt}"
        if fmt == "pt2":
            # a batch of 2 to trace: torch.export specializes a size-1 dimension
            example = torch.zeros((2 if dynamic else 1, imgsz, imgsz, 3), dtype=torch.uint8,
                                  device=device)
            shapes = {"img": {0: torch.export.Dim("batch", min=1)}} if dynamic else None
            with torch.no_grad():
                ep = torch.export.export(program, (example,), dynamic_shapes=shapes)
            torch.export.save(ep, str(path))
        else:
            from sar_yolo_tpu_torch.export.onnx_export import UnsupportedPrimitive, export_onnx
            try:
                export_onnx(program, torch.zeros((1, imgsz, imgsz, 3), dtype=torch.uint8,
                                                 device=device), str(path),
                            opset=int(args.opset or 17))
            except UnsupportedPrimitive as e:
                raise ExportError(str(e)) from e
        meta_json = sidecar(args, meta, task, imgsz, dynamic, device)
        Path(f"{path}.json").write_text(json.dumps(meta_json))
        LOGGER.info(f"Export complete: {path} ({time.time() - t0:.1f}s)")
        return str(path)
