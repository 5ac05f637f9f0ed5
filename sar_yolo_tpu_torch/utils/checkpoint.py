"""Checkpoints of the port (port of `sar_yolo_tpu/utils/checkpoint.py`).

The JAX package's layout: one directory per checkpoint holding `run_meta.json` (the
run's metadata) beside the state, here one `state.pt` written by `torch.save` in
place of Orbax's files. The state is a dict of tensors, numbers and lists, read back
on the CPU with `weights_only=True`. `tools/torch_port_jax_checkpoint.py` converts a
JAX checkpoint into this layout.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

STATE = "state.pt"
META = "run_meta.json"


def save_checkpoint(ckpt_dir, state: dict, metadata: dict | None = None):
    """Write `state` (tensors, numbers, lists and dicts of them) and the json metadata."""
    ckpt_dir = Path(ckpt_dir).resolve()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    torch.save(state, ckpt_dir / STATE)
    if metadata is not None:
        (ckpt_dir / META).write_text(json.dumps(metadata, default=str))


def load_checkpoint(ckpt_dir) -> tuple[dict, dict]:
    """(state with its tensors on the CPU, metadata) of a checkpoint directory."""
    ckpt_dir = Path(ckpt_dir).resolve()
    state = torch.load(ckpt_dir / STATE, map_location="cpu", weights_only=True)
    meta_path = ckpt_dir / META
    return state, json.loads(meta_path.read_text()) if meta_path.exists() else {}


def is_checkpoint(path) -> bool:
    p = Path(path)
    return p.is_dir() and (p / META).exists()
