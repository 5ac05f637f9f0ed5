"""Training defaults and override handling (port of the train keys of
`sar_yolo_tpu/cfg/default.yaml` and of `sar_yolo_tpu/cfg/__init__.py::get_cfg`).

A Python dict rather than YAML, because the training machine has no YAML
parser. Every value equals the JAX package's default for the same key.
"""

from __future__ import annotations

import difflib
from types import SimpleNamespace

DEFAULT_CFG = {
    "model": None,            # model config name, e.g. 'yolov13n-JDE.yaml'
    "data": None,             # 'synthetic' (the only dataset of this slice)
    "epochs": 100,
    "patience": 100,          # epochs without fitness improvement before stopping
    "batch": 16,
    "imgsz": 640,
    "workers": 8,             # host threads that build samples
    "optimizer": "auto",      # SGD, AdamW or auto
    "seed": 0,
    "single_cls": False,
    "cos_lr": False,
    "max_labels": 128,        # static per-image label padding
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
    "clr": 0.5,               # jde: triplet embedding loss gain
    "state": 1.0,             # jde: state loss gain
    "state_focal_gamma": 2.0,
    "use_state_cb": True,
    "state_cb_beta": 0.999,
    "nbs": 64,                # nominal batch size for accumulation and weight decay
}


def get_cfg(overrides: dict | None = None) -> SimpleNamespace:
    """Defaults with `overrides` on top; an unknown key raises KeyError."""
    overrides = dict(overrides or {})
    unknown = [k for k in overrides if k not in DEFAULT_CFG]
    if unknown:
        hints = {k: difflib.get_close_matches(k, DEFAULT_CFG) for k in unknown}
        raise KeyError(f"unknown config keys {hints} (key: close matches)")
    return SimpleNamespace(**{**DEFAULT_CFG, **overrides})
