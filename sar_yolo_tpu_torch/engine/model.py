"""YOLO facade of the port: build from a config name or YAML path, seed or load weights (a
checkpoint directory too), train, validate, fuse, save, serve batches, predict and track
sources, summarize and profile, export (`engine/exporter.py`) and serve an exported artifact
(`nn/autobackend.py`), pooled feature vectors (`embed`), a format table (`benchmark`,
`utils/benchmarks.py`) and hyperparameter search (`tune`: `engine/tuner.py`, or ASHA in
`utils/tuner.py`) (port of `sar_yolo_tpu/engine/model.py`), for the detect, JDE, pose, segment, OBB and classify
tasks: each call takes the trainer, validator or predictor of `task_map[task]` (`TRAINERS`,
their `validator_cls`, `PREDICTORS`; an RT-DETR model: `RTDETRTrainer`, `RTDETRValidator`,
`RTDETRPredictor`). `Ensemble` merges the detections of several models."""

from __future__ import annotations

import copy
import os
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from sar_yolo_tpu_torch.cfg.default import DEFAULT_CFG, check_ported, get_cfg, get_save_dir
from sar_yolo_tpu_torch.data.augment import letterbox
from sar_yolo_tpu_torch.data.dataset import (ClassificationDataset, SyntheticDataset, YOLODataset,
                                             check_det_dataset)
from sar_yolo_tpu_torch.data.loaders import load_inference_source
from sar_yolo_tpu_torch.engine.exporter import Exporter
from sar_yolo_tpu_torch.engine.predictor import PREDICTORS, RTDETRPredictor
from sar_yolo_tpu_torch.engine.trainer import TRAINERS, RTDETRTrainer, train_rank
from sar_yolo_tpu_torch.engine.validator import RTDETRValidator
from sar_yolo_tpu_torch.nn.autobackend import AutoBackend, BackendPredictor
from sar_yolo_tpu_torch.nn.fuse import fuse_model, half_model
from sar_yolo_tpu_torch.nn.modules.block import AAttn
from sar_yolo_tpu_torch.nn.modules.conv import quantize_int8, set_compute_dtype
from sar_yolo_tpu_torch.nn.modules.transformer import StandaloneBatchNorm
from sar_yolo_tpu_torch.nn.tasks import build_model, init_weights
from sar_yolo_tpu_torch.ops.slicing import merge_tile_detections
from sar_yolo_tpu_torch.parallel.mesh import mesh_devices_count, model_mesh, spawn
from sar_yolo_tpu_torch.utils import LOGGER, select_device
from sar_yolo_tpu_torch.utils.checkpoint import is_checkpoint, load_checkpoint, save_checkpoint
from sar_yolo_tpu_torch.utils.convert import from_jax_variables

# the arguments the predictor reads, with the JAX package's defaults for predict
PREDICT_DEFAULTS = {"imgsz": 640, "conf": 0.25, "iou": 0.7, "max_det": 300,
                    "agnostic_nms": False, "half": False, "int8": False, "save": False,
                    "save_txt": False, "stream_buffer": False, "vid_stride": 1, "augment": False,
                    "save_dir": None, "project": None, "name": None, "exist_ok": False}


def resolve_int8_policy(int8_req, scale) -> tuple[bool, str | None]:
    """The JAX package's scale rule for int8 serving (`sar_yolo_tpu/engine/model.py::
    resolve_int8_policy`), copied for parity: `int8='auto'` applies int8 at scale m and
    above (an unknown scale included) and declines at n, t and s; `int8=True` always
    applies, with a warning below m. Returns (apply int8, note to log). The rule comes from
    the JAX package's own measurements, not from this card."""
    s = (scale or "").lower()
    small = s in ("n", "t", "s")
    if str(int8_req).lower() == "auto":
        if small:
            return False, (f"int8='auto': scale '{s}' is below m, so serving without int8 "
                           "(the JAX package's scale rule)")
        return True, None
    if small:
        return True, (f"int8=True on scale '{s}': the JAX package's scale rule declines int8 "
                      "below scale m; use int8='auto' to let the rule decide")
    return True, None


class YOLO:
    """A model from a config name or a checkpoint directory, on one device.

    Examples:
        >>> m = YOLO("yolov13n-JDE.yaml")           # on cuda; raises without CUDA
        >>> dets = m.predict_batched(frames_u8)     # (B, max_det, 6 + 256 + 6)
        >>> m = YOLO("yolov8n.yaml")                # detect: yolov8n, yolo11n, yolov12n
        >>> dets = m.predict_batched(frames_u8)     # (B, max_det, 6)
        >>> dets = YOLO("yolov8n-pose.yaml").predict_batched(frames_u8)  # (B, 300, 6 + 17 x 3)
        >>> dets, masks = YOLO("yolov8n-seg.yaml").predict_batched(frames_u8)  # masks 160 x 160
        >>> rows = YOLO("yolov8n-obb.yaml").predict_batched(tiles, imgsz=1024)  # (B, 300, 7) xywhr
        >>> probs = YOLO("yolov8n-cls.yaml").predict_batched(frames_u8, imgsz=224)  # (B, 1000)
        >>> dets = m.predict_batched(frames_u8, half=True)  # bf16 on the card
        >>> dets = m.predict_batched(frames_u8, int8=True)  # dense convs int8 (or 'auto')
        >>> dets = m.predict_batched(frames_u8, mesh_shape=[2])  # the batch over 2 devices
        >>> m = YOLO("tinyjde.yaml", device="cpu")
        >>> m.train(data="path/to/SARD.yaml", imgsz=64, batch=2, epochs=1)  # val every epoch
        >>> metrics = m.val(data="path/to/SARD.yaml", rect=True)  # EMA weights, BN folded
        >>> m = YOLO("runs/jde/jde/weights/best", device="cpu")  # a trained checkpoint
        >>> results = m.predict("frames/")                 # a folder of JPEG/PNG frames
        >>> results = m.track("frames/", tracker="bytetrack.yaml")  # boxes.id: track ids
        >>> m = YOLO("path/to/yolov13n-JDE_CBAM.yaml", device="cpu")  # a YAML file path
        >>> m.save("ckpt"); m.fuse(); print(m.info(detailed=True)); m.profile(imgsz=64)
        >>> path = YOLO("yolov13n-JDE.yaml").export(format="pt2", nms=True, dynamic=True)
        >>> results = YOLO(path).predict("frames/")  # the artifact, on the device it was traced on
        >>> results = YOLO("yolov13n.yaml").predict("frames/", augment=True)  # 3-pass TTA (Detect)
        >>> vectors = m.embed("frames/", embed=[6, 8])  # (D,) pooled features an image
        >>> rows = YOLO("yolov13n.yaml").benchmark(imgsz=640, formats=("pt2",))
        >>> best_fitness, hyp = m.tune(data="synthetic", epochs=1, iterations=2)
        >>> m.train(data="synthetic", batch=-1)  # the largest power of two that fits
    """

    def __init__(self, model: str = "yolov13n-JDE.yaml", task: str | None = None, device=None):
        self.device = select_device(device)
        self.overrides: dict = {}  # a checkpoint's non-default train args, under each call's
        self.ckpt_dir = None
        self._half = None  # the bf16 copy of the folded model (half serving)
        self._int8 = {}    # {half: the int8 copy of the folded (bf16) model}
        self._callbacks: dict = {}
        self._predictor_cache = None
        self._unfused = None  # after fuse(): the unfused state dict, for save()
        self.backend = None   # the AutoBackend of an exported artifact
        if AutoBackend.is_exported_artifact(model):
            self._load_backend(model, task)
        elif is_checkpoint(model):
            self._load(model, task)
        else:
            self._new(model, task)
        self.overrides["task"] = self.task

    def _load_backend(self, artifact, task: str | None = None):
        """An exported artifact (`.pt2`, `.onnx`): served through `AutoBackend` on this
        object's device (a `.pt2` only on the device it was traced on) by `predict`; it has
        no model to train, validate, export or serve batches with."""
        self.backend = AutoBackend(artifact, self.device)
        self.task = task or self.backend.meta.get("task") or "detect"
        names = self.backend.meta.get("names")
        self.meta = {"nc": int(self.backend.meta.get("nc", 80)),
                     "names": {int(k): v for k, v in names.items()} if names else None}
        self.model, self.cfg, self.ckpt_dir = None, str(artifact), str(artifact)

    def _needs_model(self, what: str):
        if self.backend is not None:
            raise NotImplementedError(f"{what} of an exported artifact ({self.cfg}): load the "
                                      "model's config or checkpoint for it; an artifact serves "
                                      "`predict` only")

    def _new(self, cfg: str, task: str | None = None):
        self.cfg = cfg
        model, self.meta = build_model(cfg)
        self.model = model.to(self.device)
        self.task = task or self.meta["task"]
        self._weights_ready = False
        self._fused = None

    def _load(self, ckpt_dir, task: str | None = None):
        """The checkpoint's model (`model_yaml` with its nc) with the EMA parameters (the
        raw ones where it has no EMA) and the BN statistics; its task, class names and
        non-default train args."""
        state, metadata = load_checkpoint(ckpt_dir)
        model, self.meta = build_model(metadata["model_yaml"], nc=metadata.get("nc"))
        model.load_state_dict(state["model"], strict=True)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_((state.get("ema") or state["model"])[name])
        self.model = model.to(self.device)
        self.meta["strides"] = metadata.get("strides") or self.meta["strides"]
        names = metadata.get("names")
        self.meta["names"] = {int(k): v for k, v in names.items()} if names else None
        self.task = task or metadata.get("task") or self.meta["task"]
        train_args = metadata.get("train_args", {})
        self.cfg = train_args.get("model") or metadata["model_yaml"]
        self.overrides = {k: v for k, v in train_args.items()
                          if k in DEFAULT_CFG and k != "model" and v != DEFAULT_CFG[k]}
        self.ckpt_dir = str(ckpt_dir)
        self._weights_ready = True
        self._fused = None

    def _ported_task(self) -> str:
        """The model's task, which must be one this port trains, validates and serves."""
        if self.task not in TRAINERS:
            raise NotImplementedError(f"task '{self.task}' is not part of this port yet "
                                      f"(ported: {sorted(TRAINERS)})")
        return self.task

    @property
    def task_map(self) -> dict:
        """{task: {"trainer", "validator", "predictor"}}: the classes of each ported task; an
        RT-DETR head (`RTDETRDecoder`) takes RT-DETR's for detect, as in the JAX package."""
        if self.meta.get("head") == "RTDETRDecoder":
            return {"detect": {"trainer": RTDETRTrainer, "validator": RTDETRValidator,
                               "predictor": RTDETRPredictor}}
        return {t: {"trainer": tr, "validator": tr.validator_cls, "predictor": PREDICTORS[t]}
                for t, tr in TRAINERS.items()}

    def _classes(self) -> dict:
        """The task_map entry of the model's task, which must be one this port has."""
        entry = self.task_map.get(self._ported_task())
        if entry is None:
            raise NotImplementedError(f"task '{self.task}' has no {type(self).__name__} "
                                      f"classes (it has: {sorted(self.task_map)})")
        return entry

    def _ensure_variables(self, seed: int = 0):
        """Seeded initialization (a CPU torch.Generator), once."""
        self._needs_model("the weights")
        if not self._weights_ready:
            init_weights(self.model, self.meta, torch.Generator().manual_seed(seed))
            self._weights_ready = True
            self._fused = None

    def load_jax_variables(self, variables):
        """Load the JAX package's unfused {"params", "batch_stats"} tree (numpy arrays)."""
        self._unfused_model().load_state_dict(from_jax_variables(variables), strict=True)
        self._weights_ready = True
        self._drop_caches()

    def train(self, **kwargs) -> dict:
        """Train on this model's device (keys of `cfg/default.py`); returns the last epoch's
        losses and, with `val` (the default), its validation metrics. Afterwards the model
        holds the EMA parameters and the live BN statistics, and keeps the run's compute
        dtype (bf16 after an `amp` run on the card), as the JAX package's model does.
        `mesh_shape=[N]` trains on N devices (the visible CUDA devices; a CPU model: N CPU
        processes over gloo), one process each, with `batch` the global batch: spawned here
        (callbacks must then be picklable, module-level functions; they run in rank 0), or,
        under torchrun or an existing process group, this process is one rank."""
        self._needs_model("train")
        trainer_cls = self._classes()["trainer"]
        overrides = {**self.overrides, "model": self.cfg, **kwargs}
        mesh = overrides.get("mesh_shape")
        if mesh and mesh_devices_count(mesh) > 1 and not dist.is_initialized() and \
                "WORLD_SIZE" not in os.environ:
            # one process per mesh device; rank 0 sends back the trained model
            n, batch = mesh_devices_count(mesh), get_cfg(overrides).batch
            if batch % n:
                raise ValueError(f"batch {batch} does not split over the {n} ranks of "
                                 f"mesh_shape {list(mesh)}")
            self.trainer = None
            out = spawn(train_rank, (trainer_cls, overrides, self._callbacks),
                        devices=model_mesh(mesh, self.device))
            model, _ = build_model(out["meta"]["cfg"], nc=out["meta"]["nc"])
            set_compute_dtype(model, out["compute_dtype"])
            model.load_state_dict(out["state"])
            metrics, self.model, self.meta = out["metrics"], model.to(self.device).eval(), out["meta"]
            self.meta["names"], wdir = out["names"], Path(out["wdir"])
        else:
            self.trainer = trainer_cls(overrides, device=self.device)
            for event, fns in self._callbacks.items():
                for fn in fns:
                    self.trainer.add_callback(event, fn)
            metrics = self.trainer.train()
            self.model = self.trainer.ema_model()
            self.meta = self.trainer.meta
            self.meta["names"], wdir = self.trainer.data["names"], self.trainer.wdir
        self.ckpt_dir = str(wdir / "best")
        self._weights_ready = True
        self._fused, self._unfused = None, None
        return metrics

    def val(self, **kwargs) -> dict:
        """Validate the BN-folded model on this model's device (keys of `cfg/default.py`);
        returns the metrics dict. `data`: a dataset YAML file or dict (its `split`, else
        val, else train), or 'synthetic' (the default): 16 images of
        SyntheticDataset(seed=0) with min(nc, 3) classes (a pose model's keypoint shape); a
        classify model also takes a class-folder tree (its `split`, else val, test, train,
        else the folder itself)."""
        self._needs_model("val")
        validator = self._classes()["validator"]
        args = get_cfg({**self.overrides, "model": self.cfg, **kwargs})
        args.save_dir = str(get_save_dir(args, self.task))
        nc = self.meta["nc"]
        if self.task == "classify" and args.data and Path(str(args.data)).is_dir():
            root = Path(str(args.data))
            split = next((root / s for s in (args.split or "val", "val", "test", "train")
                          if (root / s).is_dir()), root)
            dataset = ClassificationDataset(split, imgsz=args.imgsz, augment=False)
            data = {"nc": len(dataset.names), "names": dataset.names}
        elif args.data in (None, "synthetic"):
            data = {"nc": nc, "names": {i: f"c{i}" for i in range(nc)}}
            dataset = SyntheticDataset(n=16, imgsz=args.imgsz, nc=min(nc, 3),
                                       max_labels=args.max_labels, task=self.task,
                                       kpt_shape=self.meta.get("kpt_shape", (5, 3)))
        else:
            data = check_det_dataset(args.data)
            split = data.get(args.split) or data.get("val") or data["train"]
            dataset = YOLODataset(split, imgsz=args.imgsz, augment=False, hyp=args,
                                  use_tags=self.task == "jde", max_labels=args.max_labels,
                                  task=self.task, kpt_shape=tuple(data.get("kpt_shape", (17, 3))))
        self.metrics = validator()(model=self._fused_for_serving(), meta=self.meta,
                                   dataset=dataset, args=args, data=data)
        return self.metrics

    def _fused_for_serving(self, half: bool = False, int8: bool = False):
        """BN-folded copy of the model for serving, made once per set of weights. `half`
        on a CUDA device: a bf16 copy of it (folded in float32 first); on the CPU, as the
        JAX package off its accelerator, the float32 one. `int8`: a copy of that whose
        dense fused convs run int8 (`quantize_int8`; quantized in float32 from the served
        weights, output in the served dtype)."""
        self._ensure_variables()
        if self._fused is None:
            self._fused = fuse_model(copy.deepcopy(self.model)).eval()
            self._half, self._int8 = None, {}
        half = bool(half and self.device.type == "cuda")
        if half and self._half is None:
            self._half = half_model(copy.deepcopy(self._fused))
        model = self._half if half else self._fused
        if not int8:
            return model
        if half not in self._int8:
            self._int8[half] = copy.deepcopy(model)
            self._int8[half].quant = "int8" if quantize_int8(self._int8[half]) else ""
        return self._int8[half]

    def _int8_applies(self, int8_req) -> bool:
        """`resolve_int8_policy` of the request on this model's scale, its note logged."""
        if not int8_req or str(int8_req).lower() in ("false", "0"):
            return False
        apply, note = resolve_int8_policy(int8_req, self.meta.get("scale"))
        if apply and not getattr(self._fused_for_serving(), "fused", False):
            LOGGER.warning(f"int8={int8_req!r} requested but the model could not be fused; "
                           "serving full precision instead")
            return False
        if note:
            (LOGGER.warning if apply else LOGGER.info)(note)
        return apply

    def _get_predictor(self, kwargs: dict):
        """The predictor of {checkpoint args, kwargs} (each key one the predictor reads;
        conf 0.25 where neither gives it), reused while the arguments stay the same; it
        always serves the current weights and every callback added so far."""
        check_ported(kwargs)
        unknown = set(kwargs) - set(PREDICT_DEFAULTS)
        if unknown:
            raise TypeError(f"unsupported predict arguments {sorted(unknown)}")
        if not isinstance(kwargs.get("vid_stride", 1), int):  # checked, never read (JAX's)
            raise TypeError("'vid_stride' must be an int")
        overrides = {**{k: v for k, v in self.overrides.items() if k in PREDICT_DEFAULTS},
                     **kwargs}
        overrides.setdefault("conf", 0.25)
        if self.backend is not None:
            return self._backend_predictor(overrides)
        predictor_cls = self._classes()["predictor"]
        key = tuple(sorted((k, str(v)) for k, v in overrides.items()))
        if self._predictor_cache is None or self._predictor_cache[0] != key:
            args = SimpleNamespace(**{**PREDICT_DEFAULTS, **overrides})
            args.int8 = self._int8_applies(args.int8)
            self._predictor_cache = (key, predictor_cls(
                self._fused_for_serving(args.half, args.int8), self.meta, args, self.names))
        predictor = self._predictor_cache[1]
        # new weights after train()
        predictor.model = self._fused_for_serving(predictor.args.half, predictor.args.int8)
        for event, fns in self._callbacks.items():
            for fn in fns:
                if fn not in predictor.callbacks.get(event, []):
                    predictor.add_callback(event, fn)
        return predictor

    def _backend_predictor(self, overrides: dict) -> BackendPredictor:
        """The artifact's predictor; what the artifact fixed (its size, its precision) and
        what it cannot do (save_txt) raise when asked otherwise. `save` is read by nothing
        here, as the JAX package's artifact predictor writes no annotated files."""
        if any(event.startswith("on_predict") for event in self._callbacks):
            raise NotImplementedError("predict callbacks with an exported artifact")
        imgsz = self.backend.meta.get("imgsz")
        for key, ok in (("imgsz", overrides.get("imgsz", imgsz) == imgsz),
                        ("half", not overrides.get("half")), ("int8", not overrides.get("int8")),
                        ("save_txt", not overrides.get("save_txt"))):
            if not ok:
                raise NotImplementedError(f"{key}={overrides[key]!r} with an exported artifact "
                                          f"(its imgsz {imgsz}, float32, rows in memory only)")
        key = tuple(sorted((k, str(v)) for k, v in overrides.items()))
        if self._predictor_cache is None or self._predictor_cache[0] != key:
            args = SimpleNamespace(**{**PREDICT_DEFAULTS, **overrides})
            self._predictor_cache = (key, BackendPredictor(self.backend, args, self.names))
        return self._predictor_cache[1]

    def predict_batched(self, frames, mesh_shape=None, **kwargs):
        """Serve a uniform-geometry (B, H, W, 3) uint8 BGR batch on the model's device;
        `mesh_shape=[N]` splits it over N devices (`parallel.model_mesh`: the visible CUDA
        devices, or the CPU N times for a CPU model; too few raise ValueError), each share
        on a replica of the served model, the outputs in order.

        kwargs: imgsz, conf, iou, max_det, agnostic_nms, half (bf16 on the card), int8
        (True or 'auto': the dense fused convs int8, `resolve_int8_policy`).
        Returns (B, max_det, 6 + E) numpy detections in original-image pixels: [x1, y1,
        x2, y2, conf, cls, *embedding, *states] (E = 0 for a detect model; pose: the K x D
        keypoints, xy in original pixels); rows with conf == 0 are padding. A segment
        model returns (rows (B, max_det, 6), masks (B, max_det, imgsz / 4, imgsz / 4) bool
        in the letterboxed input's frame); an OBB model (B, max_det, 7) rows [cx, cy, w, h,
        r, conf, cls]; a classify model (B, nc) probabilities.
        """
        self._needs_model("predict_batched")
        devices = model_mesh(mesh_shape, self.device) if mesh_shape else None
        return self._get_predictor(kwargs).predict_batch(frames, devices)

    def export(self, **kwargs) -> str:
        """Write a deployable artifact of the BN-folded float32 model (`engine/exporter.py`)
        and return its path; `YOLO(path)` serves it. kwargs: format ('pt2', the default, or
        'onnx'), imgsz, nms (embed NMS in a pt2 program), dynamic (a pt2 program for any
        batch), iou, max_det, opset (ONNX) and project (the folder, default `exports/`).
        The program is traced on this model's device and serves there only."""
        self._needs_model("export")
        args = get_cfg({"format": "pt2", **self.overrides, "model": self.cfg, **kwargs})
        return Exporter(args)(self._fused_for_serving(), self.meta, self._ported_task())

    def predict(self, source, stream: bool = False, **kwargs):
        """Results of each image of `source`: an image file, a folder, a glob, a list of
        paths, a uint8 BGR array, a list of arrays, or a torch/numpy NCHW or NHWC tensor
        (float RGB in [0, 1], or uint8). `stream=True` returns a generator.
        kwargs: those of `predict_batched`; save (each result's `plot()` written: images as
        save_dir/<name>, each video or stream as save_dir/<stem>.avi, Motion-JPEG) and
        save_txt, both under save_dir or project/task/name (exist_ok); and augment (test-time augmentation, `ops/tta.py`: a Detect head only; any other head
        warns and serves one scale)."""
        return self._get_predictor(kwargs)(source, stream=stream)

    def embed(self, source, embed=None, imgsz: int = 640, **kwargs) -> list:
        """The mean over H and W of the listed layers' outputs (default: the second-to-last
        layer; negative indices wrap), concatenated over the channels: a list of (D,) numpy
        vectors, one an image of `source` (any source `predict` takes). Each frame is
        letterboxed on the host to imgsz x imgsz (RGB, / 255) and runs through the served
        (BN-folded) model on its device up to the last listed layer only. Other kwargs are
        accepted and unread, as in the JAX package."""
        self._needs_model("embed")
        model = self._fused_for_serving()
        n = len(model.specs)
        idx = tuple(int(i) % n for i in (embed or [n - 2]))
        dtype = getattr(model, "compute_dtype", torch.float32)
        loader, _ = load_inference_source(source)
        out = []
        with torch.no_grad():
            for _, img, _meta in loader:
                lb = letterbox(img[..., ::-1], (imgsz, imgsz))[0]
                x = torch.from_numpy(np.ascontiguousarray(lb)).to(self.device)
                x = (x.permute(2, 0, 1)[None].float() / 255.0).to(dtype)
                out.append(model(x, embed=idx)[0].float().cpu().numpy())
        return out

    def __call__(self, source, **kwargs):
        return self.predict(source, **kwargs)

    def track(self, source, stream: bool = False, persist: bool = False,
              tracker: str = "bytetrack.yaml", **kwargs):
        """`predict` with a multi-object tracker: each frame's boxes carry a track id
        (column 6). conf defaults to 0.1, so low-confidence detections reach the
        tracker's second association. `persist=True` keeps the tracks of the previous
        call; otherwise they start again. `tracker`: bytetrack.yaml or botsort.yaml
        (camera-motion compensation `gmc_method`: sparseOptFlow or none; orb, sift and
        ecc raise). Each video file and each stream of a `.streams` source gets a tracker
        of its own, at the video's frame rate."""
        from sar_yolo_tpu_torch.trackers import make_tracker, register_tracker
        self._needs_model("track")
        make_tracker(tracker)  # a config this port cannot run raises before any frame
        kwargs.setdefault("conf", 0.1)
        predictor = self._get_predictor(kwargs)
        if not getattr(predictor, "_tracking_registered", False):
            register_tracker(predictor, tracker=tracker, persist=persist)
            predictor._tracking_registered = True
        predictor._tracker, predictor._tracker_persist = tracker, persist
        return predictor(source, stream=stream)

    def benchmark(self, **kwargs) -> list:
        """Rows of the native model and of each export format's reloaded artifact: size, mAP50-95,
        ms an image and FPS (`utils/benchmarks.py::benchmark`; formats 'pt2' and 'onnx')."""
        from sar_yolo_tpu_torch.utils.benchmarks import benchmark
        self._needs_model("benchmark")
        return benchmark(self, **kwargs)

    def tune(self, iterations: int = 10, use_ray: bool = False, **kwargs):
        """Hyperparameter search over `iterations` trainings with this model's config, task and
        device and the train kwargs: mutation evolution (`engine/tuner.py`, runs/tune/
        tune_results.csv; returns (best fitness, its hyperparameters)), or with
        `use_ray=True` the built-in ASHA (`utils/tuner.py`; returns rows best first)."""
        self._needs_model("tune")
        if use_ray:
            from sar_yolo_tpu_torch.utils.tuner import run_ray_tune
            return run_ray_tune(self, max_samples=iterations, **kwargs)
        from sar_yolo_tpu_torch.engine.tuner import Tuner
        overrides = {**self.overrides, "model": self.cfg, **kwargs}
        return Tuner(overrides, device=self.device)(iterations=iterations)

    def add_callback(self, event: str, func) -> None:
        """Register a callback for every trainer (`on_train_*`, `on_fit_epoch_end`, ...) and
        every predictor (`on_predict_*`) this object makes, the predictor made already
        included; each is called with the trainer or the predictor."""
        self._callbacks.setdefault(event, []).append(func)

    def clear_callback(self, event: str) -> None:
        """Drop the callbacks registered for `event` (here and on the cached predictor)."""
        fns = self._callbacks.pop(event, [])
        if self._predictor_cache is not None:
            listed = self._predictor_cache[1].callbacks.get(event, [])
            listed[:] = [f for f in listed if f not in fns]

    def reset_callbacks(self) -> None:
        """Drop every registered callback."""
        for event in list(self._callbacks):
            self.clear_callback(event)

    @property
    def names(self):
        return self.meta.get("names") or {i: f"c{i}" for i in range(self.meta["nc"])}

    @property
    def fused(self) -> bool:
        return self._unfused is not None

    def _drop_caches(self):
        self._fused, self._half, self._predictor_cache = None, None, None
        self._int8 = {}

    def _unfused_model(self):
        """self.model as built from its config (unfused; used where fuse() folded it)."""
        if self.fused:
            model, _ = build_model(self.meta["cfg"], nc=self.meta["nc"])
            self.model = model.to(self.device)
            self._unfused = None
        return self.model

    def save(self, ckpt_dir="saved_model_ckpt") -> str:
        """Write the current weights as a checkpoint directory (`utils/checkpoint.py`) that
        `YOLO(ckpt_dir)` serves: always the unfused weights (after `fuse()`, those it kept);
        the metadata: the config, nc, strides, task, class names and `overrides`."""
        self._ensure_variables()
        if self.fused:
            state = self._unfused
        elif not any(isinstance(m, torch.nn.BatchNorm2d) and not isinstance(m, StandaloneBatchNorm)
                     for m in self.model.modules()):
            raise ValueError("cannot save a fused model without its unfused weights (load a "
                             "checkpoint, or call save() before folding it)")
        else:
            state = self.model.state_dict()
        meta = {"model_yaml": self.meta["cfg"], "nc": self.meta["nc"],
                "strides": self.meta["strides"], "task": self.task,
                "train_args": {**self.overrides, "model": self.cfg},
                "names": self.meta.get("names")}
        save_checkpoint(ckpt_dir, {"model": {k: v.detach().cpu() for k, v in state.items()}},
                        meta)
        self.ckpt_dir = str(ckpt_dir)
        return self.ckpt_dir

    def load(self, ckpt_dir) -> "YOLO":
        """Load a checkpoint's weights (its EMA parameters where it has them) and BN
        statistics into this model, unfused; the serving caches are dropped."""
        state, _ = load_checkpoint(ckpt_dir)
        model = self._unfused_model()
        model.load_state_dict(state["model"], strict=True)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_((state.get("ema") or state["model"])[name])
        self._weights_ready = True
        self._drop_caches()
        return self

    def reset_weights(self) -> "YOLO":
        """A fresh seeded initialization (seed 0), unfused; the serving caches are dropped."""
        init_weights(self._unfused_model(), self.meta, torch.Generator().manual_seed(0))
        self._weights_ready = True
        self._drop_caches()
        return self

    def fuse(self) -> "YOLO":
        """Fold every BatchNorm into its convolution in place (`nn/fuse.py`); the unfused
        weights are kept for `save`, and serving uses the folded model as it is."""
        self._ensure_variables()
        if not self.fused:
            self._unfused = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
            self._drop_caches()
            self._fused = fuse_model(self.model).eval()
        return self

    def info(self, detailed: bool = False, verbose: bool = True, imgsz: int = 640) -> str:
        """Summary: the task, the parameter count and the strides; `detailed=True` adds a
        table of each layer's index, module, parameters and output shape (NCHW), from one
        forward of a copy of the model on the `meta` device (shapes only: nothing runs on
        the card)."""
        self._ensure_variables()
        n = sum(p.numel() for p in self.model.parameters())
        s = f"{type(self).__name__} task={self.task} params={n:,} strides={self.meta['strides']}"
        if detailed:
            model, shapes = _meta_copy(self.model), {}
            for i, blk in enumerate(model.blocks):
                blk.register_forward_hook(lambda m, a, out, i=i: shapes.__setitem__(
                    i, tuple(out.shape) if torch.is_tensor(out) else
                    [tuple(o.shape) for o in torch.utils._pytree.tree_leaves(out)]))
            with torch.no_grad():
                model(torch.zeros(1, 3, imgsz, imgsz, device="meta"))
            lines = [f"{'idx':>4} {'module':<20} {'params':>12}  output"]
            for spec, blk in zip(self.model.specs, self.model.blocks):
                n_i = sum(p.numel() for p in blk.parameters())
                lines.append(f"{spec.i:>4} {spec.name:<20} {n_i:>12,}  {shapes.get(spec.i, '-')}")
            s = s + "\n" + "\n".join(lines)
        if verbose:
            LOGGER.info(s)
        return s

    def profile(self, imgsz: int = 640, batch: int = 1, n_iter: int = 10) -> dict:
        """The JAX package's `profile` keys for one eval forward of a (batch, 3, imgsz, imgsz)
        input. These are not XLA's cost-analysis counts: `gflops` is
        `torch.utils.flop_counter.FlopCounterMode`'s count (convolutions and matmuls, 2 per
        multiply-add; elementwise work is not counted), `bytes_accessed_gb` the sum of the
        bytes each aten op reads and writes (views excluded; no fusion), both over one
        forward on the `meta` device; `latency_ms` and `imgs_per_sec` time `n_iter`
        forwards on the model's device (CUDA events on the card, the host clock on the
        CPU)."""
        self._ensure_variables()
        model = _meta_copy(self.model)
        x = torch.zeros(batch, 3, imgsz, imgsz, device="meta")
        with torch.no_grad(), FlopCounterMode(display=False) as flops, _BytesCounter() as nbytes:
            model(x)
        live = self.model.eval()
        x = torch.zeros(batch, 3, imgsz, imgsz, device=self.device,
                        dtype=getattr(live, "compute_dtype", torch.float32))
        with torch.no_grad():
            live(x)  # warm-up
            if self.device.type == "cuda":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n_iter):
                    live(x)
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3 / n_iter
            else:
                t0 = time.perf_counter()
                for _ in range(n_iter):
                    live(x)
                dt = (time.perf_counter() - t0) / n_iter
        info = {"params": sum(p.numel() for p in self.model.parameters()),
                "gflops": round(flops.get_total_flops() / 1e9, 2),
                "bytes_accessed_gb": round(nbytes.total / 1e9, 3),
                "latency_ms": round(dt * 1e3, 2), "imgs_per_sec": round(batch / dt, 1),
                "imgsz": imgsz, "batch": batch}
        LOGGER.info(str(info))
        return info


def _meta_copy(model):
    """A copy of `model` on the `meta` device with the attention on its plain path (shapes
    and operation counts only; the kernel takes no meta tensor)."""
    model = copy.deepcopy(model).to("meta").eval()
    for m in model.modules():
        if isinstance(m, AAttn):
            m.use_flash = False
    return model


class _BytesCounter(TorchDispatchMode):
    """While active, `total` sums the bytes of every tensor each aten op reads or writes
    (view ops excluded: they move no data)."""

    def __enter__(self):
        self.total = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            for t in torch.utils._pytree.tree_leaves((args, kwargs, out)):
                if torch.is_tensor(t):
                    self.total += t.numel() * t.element_size()
        return out


class Ensemble:
    """Several models, each serving with its own predictor, their detections a frame merged
    by one class-aware greedy NMS (`ops/slicing.py::merge_tile_detections`), as the JAX
    package's `Ensemble` does.

        ens = Ensemble(["yolov13n-JDE.yaml", "runs/jde/jde/weights/best"])
        merged = ens.predict("frames/")   # a list of (N, 6 + ...) arrays, one a frame
    """

    def __init__(self, models, device=None):
        self.models = [m if isinstance(m, YOLO) else YOLO(m, device=device) for m in models]

    def predict(self, source, merge_iou: float = 0.5, max_det: int = 300, **kwargs) -> list:
        per_model = [m.predict(source, **kwargs) for m in self.models]
        merged = []
        for per_img in zip(*per_model):
            dets = [np.asarray(r.boxes.data) if r.boxes is not None else
                    np.zeros((0, 6), np.float32) for r in per_img]
            merged.append(merge_tile_detections(dets, [(0, 0)] * len(dets), merge_iou, max_det))
        return merged
