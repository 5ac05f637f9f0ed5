"""Training and validation defaults and override handling (port of the train and val
keys of `sar_yolo_tpu/cfg/default.yaml` and of `sar_yolo_tpu/cfg/__init__.py`'s
`get_cfg` and `get_save_dir`).

A Python dict rather than YAML, because the training machine has no YAML
parser. Every value equals the JAX package's default for the same key.
"""

from __future__ import annotations

import difflib
from pathlib import Path
from types import SimpleNamespace

DEFAULT_CFG = {
    "task": "detect",         # the model's task; the facade passes the model's own
    "model": None,            # model config name, e.g. 'yolov13n-JDE.yaml'
    "data": None,             # a dataset YAML file or dict, or 'synthetic'
    "epochs": 100,
    "time": None,             # hours to train for: the epoch loop stops once over it
    "patience": 100,          # epochs without fitness improvement before stopping
    "batch": 16,              # -1: the largest power of two that fits (`utils/autobatch.py`)
    "imgsz": 640,
    "save": True,             # weights/last every epoch, weights/best on improvement
    "save_period": -1,        # also weights/epoch{n} every N epochs (< 1: never)
    "device": None,           # the command line's device ('cuda', 'cuda:1', 'cpu'); default cuda
    "workers": 8,             # host threads that build samples
    "project": None,          # runs are saved under project/task/name (default runs/)
    "name": None,             # default: the task
    "exist_ok": False,        # reuse project/task/name instead of numbering a new one
    "optimizer": "auto",      # SGD, AdamW or auto
    "verbose": True,          # the per-class table after validation
    "seed": 0,
    "single_cls": False,
    "rect": False,            # val: rectangular batches, sorted by aspect ratio
    "cos_lr": False,
    "close_mosaic": 10,       # mosaic off for the last N epochs
    "resume": False,          # True: this run's weights/last; or a checkpoint directory
    "fraction": 1.0,          # the share of the train images used
    "cache": False,           # decoded images: True/'ram' in memory, 'disk' as .npy sidecars
    "max_labels": 128,        # static per-image label padding
    "val": True,              # validate the EMA weights after every epoch
    "split": "val",           # the dataset split YOLO.val reads
    "save_json": False,       # COCO-style predictions.json and its numpy COCOeval
    "conf": None,             # detection threshold; None means 0.001 at val
    "iou": 0.7,               # NMS IoU threshold
    "max_det": 300,
    "save_txt": False,        # per-image label files of the detections
    "save_conf": False,       # with their confidences
    "augment": False,         # test-time augmentation (3 scales and a flip; Detect heads only)
    "plots": True,            # val/train figures: mosaics, confusion matrix, labels, results
    "lr0": 0.01,
    "lrf": 0.01,
    "momentum": 0.937,        # SGD momentum / Adam beta1
    "weight_decay": 0.0005,
    "warmup_epochs": 3.0,
    "warmup_momentum": 0.8,
    "warmup_bias_lr": 0.0,
    "box": 7.5,
    "cls": 0.5,
    "dfl": 1.5,
    "pose": 12.0,             # pose: keypoint (OKS) loss gain
    "kobj": 1.0,              # pose: keypoint visibility loss gain
    "clr": 0.5,               # jde: triplet embedding loss gain
    "state": 1.0,             # jde: state loss gain
    "state_focal_gamma": 2.0,
    "use_state_cb": True,
    "state_cb_beta": 0.999,
    "nbs": 64,                # nominal batch size for accumulation and weight decay
    "hsv_h": 0.015,           # host augmentation gains and probabilities
    "hsv_s": 0.7,
    "hsv_v": 0.4,
    "degrees": 0.0,
    "translate": 0.1,
    "scale": 0.5,
    "shear": 0.0,
    "perspective": 0.0,       # > 0 raises: warpPerspective is not part of this port yet
    "flipud": 0.0,
    "fliplr": 0.5,
    "mosaic": 1.0,
    "mosaic9": 0.0,           # > 0 raises: the 9-image mosaic is not part of this port yet
    "mixup": 0.0,
    "copy_paste": 0.1,
    "device_augment": "auto", # augment on the device where the hyperparameters allow it
    "amp": True,              # train in bf16 compute (f32 parameters) on the card
    "half": False,            # serve the BN-folded model in bf16 on the card
    "int8": False,            # serve dense fused convs int8 (True, or 'auto': scale m and up)
    "mesh_shape": None,       # [N]: train on N devices, one process each (global batch);
                              # val shards each batch over N devices
    "remat": False,           # train with per-block activation checkpointing
    "multi_scale": False,     # train at a random stride multiple in [0.5, 1.5] x imgsz
    "profile": False,         # 'trace': a torch.profiler trace of steps 1-3 of epoch 0
    "dropout": 0.0,           # the classify head's dropout
    "overlap_mask": True,     # segment: accepted and unread, as in the JAX package (its masks
    "mask_ratio": 4,          # are always one overlap map at imgsz // 4)
    "retina_masks": False,    # segment: accepted and unread, as in the JAX package
    "format": "stablehlo",    # export: the JAX YAML's; `YOLO.export` defaults to 'pt2' (the
                              # port writes no StableHLO: 'stablehlo' raises naming 'pt2')
    "keras": False,           # export: TF keras (jax2tf; not ported unless False)
    "optimize": False,        # export: TFLite mobile optimize (not ported unless False)
    "dynamic": False,         # export: pt2 for any batch size
    "simplify": True,         # export: graph simplification (not ported unless True)
    "opset": None,            # export: ONNX opset (None: 17; clamped to 13..17)
    "workspace": "None",      # export: TensorRT's workspace (the JAX YAML's string; not
                              # ported unless unset)
    "nms": False,             # export: NMS inside the pt2 program
}

# keys of the JAX package whose feature this port does not have yet; those with a default
# raise only when set to another value
NOT_PORTED = {
    "keras": "TF keras export (jax2tf)",
    "optimize": "TFLite's mobile optimize (jax2tf)",
    "simplify": "export graph simplification",
    "workspace": "TensorRT's workspace",
}


def check_ported(overrides: dict) -> None:
    """Raise NotImplementedError for a key of `NOT_PORTED` that asks for its feature: any
    value of a key without a default, any but the default of one with it."""
    for k, v in overrides.items():
        if k in NOT_PORTED and (k not in DEFAULT_CFG or v != DEFAULT_CFG[k]):
            raise NotImplementedError(f"'{k}': {NOT_PORTED[k]} is not part of this port yet")


def get_cfg(overrides: dict | None = None) -> SimpleNamespace:
    """Defaults with `overrides` on top; an unknown key raises KeyError, a key of a
    feature not ported yet NotImplementedError."""
    overrides = dict(overrides or {})
    check_ported(overrides)
    unknown = [k for k in overrides if k not in DEFAULT_CFG]
    if unknown:
        hints = {k: difflib.get_close_matches(k, DEFAULT_CFG) for k in unknown}
        raise KeyError(f"unknown config keys {hints} (key: close matches)")
    return SimpleNamespace(**{**DEFAULT_CFG, **overrides})


def get_save_dir(args, task: str) -> Path:
    """project/task/name (default runs/task/task), numbered name2, name3, ... where it
    exists, unless args.exist_ok."""
    project = Path(args.project or "runs") / task
    base = args.name or task
    save_dir = project / base
    if save_dir.exists() and not args.exist_ok:
        for i in range(2, 10000):
            cand = project / f"{base}{i}"
            if not cand.exists():
                save_dir = cand
                break
    return save_dir
