#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package into one that the PyTorch port reads.

    JAX_PLATFORMS=cpu python3 tools/torch_port_jax_checkpoint.py runs/jde/train/weights/best out/best

It runs where the JAX package and Orbax are installed, not in the port: the port
reads only its own format (`sar_yolo_tpu_torch/utils/checkpoint.py`). The JAX
checkpoint directory is restored with the JAX package's `load_checkpoint`; its
`params` with `batch_stats` become the port model's state dict and its
`ema_params` the EMA, through `sar_yolo_tpu_torch/utils/convert.py`;
`cb_counts` and `run_meta.json` are carried over. The optimizer state is not: a
run resumed from the result starts its optimizer fresh. `YOLO(<out>)` of the port
then serves the JAX weights (the EMA with the BN statistics).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def convert(src, dst) -> Path:
    """Write the port checkpoint of JAX checkpoint `src` into directory `dst`; returns it."""
    from sar_yolo_tpu.utils.checkpoint import load_checkpoint as load_jax_checkpoint
    from sar_yolo_tpu_torch.utils.checkpoint import save_checkpoint
    from sar_yolo_tpu_torch.utils.convert import from_jax_variables
    payload, metadata = load_jax_checkpoint(src)
    params = payload.get("params")
    ema = payload.get("ema_params") or params
    state = {"model": from_jax_variables({"params": params,
                                          "batch_stats": payload.get("batch_stats") or {}}),
             "ema": from_jax_variables({"params": ema}),
             "cb_counts": torch.tensor(np.asarray(payload.get("cb_counts", np.zeros(1)),
                                                  np.float32))}
    save_checkpoint(dst, state, metadata)
    return Path(dst)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="the JAX package's checkpoint directory (holds run_meta.json)")
    ap.add_argument("dst", help="the port's checkpoint directory to write")
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    print(convert(args.src, args.dst))


if __name__ == "__main__":
    main()
