"""YOLO facade of the port: build, seed or load weights (a checkpoint directory too),
train, validate, fuse, serve batches, predict and track sources (port of the serving,
tracking, training and validation part of `sar_yolo_tpu/engine/model.py`), for the
detect and JDE tasks: each call takes the trainer (`TRAINERS`, whose `validator_cls`
validates) or the predictor (`PREDICTORS`) of the model's task."""

from __future__ import annotations

import copy
from types import SimpleNamespace

import torch

from sar_yolo_tpu_torch.cfg.default import DEFAULT_CFG, NOT_PORTED, get_cfg, get_save_dir
from sar_yolo_tpu_torch.data.dataset import SyntheticDataset, YOLODataset, check_det_dataset
from sar_yolo_tpu_torch.engine.predictor import PREDICTORS
from sar_yolo_tpu_torch.engine.trainer import TRAINERS
from sar_yolo_tpu_torch.nn.fuse import fuse_model, half_model
from sar_yolo_tpu_torch.nn.tasks import build_model, init_weights
from sar_yolo_tpu_torch.utils import select_device
from sar_yolo_tpu_torch.utils.checkpoint import is_checkpoint, load_checkpoint
from sar_yolo_tpu_torch.utils.convert import from_jax_variables

# the arguments the predictor reads, with the JAX package's defaults for predict
PREDICT_DEFAULTS = {"imgsz": 640, "conf": 0.25, "iou": 0.7, "max_det": 300,
                    "agnostic_nms": False, "half": False, "save": False, "save_txt": False,
                    "save_dir": None, "project": None, "name": None, "exist_ok": False}


class YOLO:
    """A model from a config name or a checkpoint directory, on one device.

    Examples:
        >>> m = YOLO("yolov13n-JDE.yaml")           # on cuda; raises without CUDA
        >>> dets = m.predict_batched(frames_u8)     # (B, max_det, 6 + 256 + 6)
        >>> m = YOLO("yolov8n.yaml")                # detect: yolov8n, yolo11n, yolov12n
        >>> dets = m.predict_batched(frames_u8)     # (B, max_det, 6)
        >>> dets = m.predict_batched(frames_u8, half=True)  # bf16 on the card
        >>> m = YOLO("tinyjde.yaml", device="cpu")
        >>> m.train(data="path/to/SARD.yaml", imgsz=64, batch=2, epochs=1)  # val every epoch
        >>> metrics = m.val(data="path/to/SARD.yaml", rect=True)  # EMA weights, BN folded
        >>> m = YOLO("runs/jde/jde/weights/best", device="cpu")  # a trained checkpoint
        >>> results = m.predict("frames/")                 # a folder of JPEG/PNG frames
        >>> results = m.track("frames/", tracker="bytetrack.yaml")  # boxes.id: track ids
    """

    def __init__(self, model: str = "yolov13n-JDE.yaml", device=None):
        self.device = select_device(device)
        self.overrides: dict = {}  # a checkpoint's non-default train args, under each call's
        self.ckpt_dir = None
        self._half = None  # the bf16 copy of the folded model (half serving)
        self._callbacks: dict = {}
        self._predictor_cache = None
        if is_checkpoint(model):
            self._load(model)
        else:
            self._new(model)

    def _new(self, cfg: str):
        self.cfg = cfg
        model, self.meta = build_model(cfg)
        self.model = model.to(self.device)
        self.task = self.meta["task"]
        self._weights_ready = False
        self._fused = None

    def _load(self, ckpt_dir):
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
        self.task = metadata.get("task") or self.meta["task"]
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

    def _ensure_variables(self, seed: int = 0):
        """Seeded initialization (a CPU torch.Generator), once."""
        if not self._weights_ready:
            init_weights(self.model, self.meta, torch.Generator().manual_seed(seed))
            self._weights_ready = True
            self._fused = None

    def load_jax_variables(self, variables):
        """Load the JAX package's unfused {"params", "batch_stats"} tree (numpy arrays)."""
        self.model.load_state_dict(from_jax_variables(variables), strict=True)
        self._weights_ready = True
        self._fused = None

    def train(self, **kwargs) -> dict:
        """Train on this model's device (keys of `cfg/default.py`); returns the last epoch's
        losses and, with `val` (the default), its validation metrics. Afterwards the model
        holds the EMA parameters and the live BN statistics, and keeps the run's compute
        dtype (bf16 after an `amp` run on the card), as the JAX package's model does."""
        self.trainer = TRAINERS[self._ported_task()](
            {**self.overrides, "model": self.cfg, **kwargs}, device=self.device)
        metrics = self.trainer.train()
        self.model = self.trainer.ema_model()
        self.meta = self.trainer.meta
        self.meta["names"] = self.trainer.data["names"]
        self.ckpt_dir = str(self.trainer.wdir / "best")
        self._weights_ready = True
        self._fused = None
        return metrics

    def val(self, **kwargs) -> dict:
        """Validate the BN-folded model on this model's device (keys of `cfg/default.py`);
        returns the metrics dict. `data`: a dataset YAML file or dict (its `split`, else
        val, else train), or 'synthetic' (the default): 16 images of
        SyntheticDataset(seed=0) with min(nc, 3) classes."""
        validator = TRAINERS[self._ported_task()].validator_cls
        args = get_cfg({**self.overrides, "model": self.cfg, **kwargs})
        args.save_dir = str(get_save_dir(args, self.task))
        nc = self.meta["nc"]
        if args.data in (None, "synthetic"):
            data = {"nc": nc, "names": {i: f"c{i}" for i in range(nc)}}
            dataset = SyntheticDataset(n=16, imgsz=args.imgsz, nc=min(nc, 3),
                                       max_labels=args.max_labels, task=self.task)
        else:
            data = check_det_dataset(args.data)
            split = data.get(args.split) or data.get("val") or data["train"]
            dataset = YOLODataset(split, imgsz=args.imgsz, augment=False, hyp=args,
                                  use_tags=self.task == "jde", max_labels=args.max_labels,
                                  task=self.task, kpt_shape=tuple(data.get("kpt_shape", (17, 3))))
        self.metrics = validator()(model=self._fused_for_serving(), meta=self.meta,
                                   dataset=dataset, args=args, data=data)
        return self.metrics

    def _fused_for_serving(self, half: bool = False):
        """BN-folded copy of the model for serving, made once per set of weights. `half`
        on a CUDA device: a bf16 copy of it (folded in float32 first); on the CPU, as the
        JAX package off its accelerator, the float32 one."""
        self._ensure_variables()
        if self._fused is None:
            self._fused = fuse_model(copy.deepcopy(self.model)).eval()
            self._half = None
        if not (half and self.device.type == "cuda"):
            return self._fused
        if self._half is None:
            self._half = half_model(copy.deepcopy(self._fused))
        return self._half

    def _get_predictor(self, kwargs: dict):
        """The predictor of {checkpoint args, kwargs} (each key one the predictor reads;
        conf 0.25 where neither gives it), reused while the arguments stay the same; it
        always serves the current weights and every callback added so far."""
        for k in kwargs:
            if k in NOT_PORTED:
                raise NotImplementedError(f"'{k}': {NOT_PORTED[k]} is not part of this port yet")
        unknown = set(kwargs) - set(PREDICT_DEFAULTS)
        if unknown:
            raise TypeError(f"unsupported predict arguments {sorted(unknown)}")
        predictor_cls = PREDICTORS[self._ported_task()]
        overrides = {**{k: v for k, v in self.overrides.items() if k in PREDICT_DEFAULTS},
                     **kwargs}
        overrides.setdefault("conf", 0.25)
        if overrides.get("save"):
            raise NotImplementedError("save=True (annotated images) is not part of this port "
                                      "yet: it needs OpenCV's drawing and a JPEG encoder")
        key = tuple(sorted((k, str(v)) for k, v in overrides.items()))
        if self._predictor_cache is None or self._predictor_cache[0] != key:
            args = SimpleNamespace(**{**PREDICT_DEFAULTS, **overrides})
            self._predictor_cache = (key, predictor_cls(self._fused_for_serving(args.half),
                                                        self.meta, args, self.names))
        predictor = self._predictor_cache[1]
        predictor.model = self._fused_for_serving(predictor.args.half)  # new weights after train()
        for event, fns in self._callbacks.items():
            for fn in fns:
                if fn not in predictor.callbacks[event]:
                    predictor.add_callback(event, fn)
        return predictor

    def predict_batched(self, frames, **kwargs):
        """Serve a uniform-geometry (B, H, W, 3) uint8 BGR batch on the model's device.

        kwargs: imgsz, conf, iou, max_det, agnostic_nms, half (bf16 on the card).
        Returns (B, max_det, 6 + E) numpy detections in original-image pixels: [x1, y1,
        x2, y2, conf, cls, *embedding, *states] (E = 0 for a detect model); rows with
        conf == 0 are padding.
        """
        return self._get_predictor(kwargs).predict_batch(frames)

    def predict(self, source, stream: bool = False, **kwargs):
        """Results of each image of `source`: an image file, a folder, a glob, a list of
        paths, a uint8 BGR array, a list of arrays, or a torch/numpy NCHW or NHWC tensor
        (float RGB in [0, 1], or uint8). `stream=True` returns a generator.
        kwargs: those of `predict_batched`, and save_txt with save_dir or
        project/name/exist_ok."""
        return self._get_predictor(kwargs)(source, stream=stream)

    def __call__(self, source, **kwargs):
        return self.predict(source, **kwargs)

    def track(self, source, stream: bool = False, persist: bool = False,
              tracker: str = "bytetrack.yaml", **kwargs):
        """`predict` with a multi-object tracker: each frame's boxes carry a track id
        (column 6). conf defaults to 0.1, so low-confidence detections reach the
        tracker's second association. `persist=True` keeps the tracks of the previous
        call; otherwise they start again. `tracker`: bytetrack.yaml, or a BoT-SORT YAML
        with `gmc_method: none` (the shipped botsort.yaml asks for camera-motion
        compensation, which is not ported, and raises)."""
        from sar_yolo_tpu_torch.trackers import make_tracker, register_tracker
        make_tracker(tracker)  # a config this port cannot run raises before any frame
        kwargs.setdefault("conf", 0.1)
        predictor = self._get_predictor(kwargs)
        if not getattr(predictor, "_tracking_registered", False):
            register_tracker(predictor, tracker=tracker, persist=persist)
            predictor._tracking_registered = True
        predictor._tracker, predictor._tracker_persist = tracker, persist
        return predictor(source, stream=stream)

    def add_callback(self, event: str, func) -> None:
        """Register a callback (an `on_predict_*` event) for every predictor this object
        makes, the ones made already included."""
        self._callbacks.setdefault(event, []).append(func)

    @property
    def names(self):
        return self.meta.get("names") or {i: f"c{i}" for i in range(self.meta["nc"])}
