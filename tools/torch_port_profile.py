#!/usr/bin/env python3
"""Where the serving or training time of the PyTorch/CUDA port goes, on one NVIDIA GPU.

    python3 tools/torch_port_profile.py [--imgsz 640] [--batch 8] [--model yolov13n-JDE.yaml]
    python3 tools/torch_port_profile.py --model yolov8n.yaml --phase14 --batch 128 \
        --conf 0.25                            # bench.py's serving geometry
    python3 tools/torch_port_profile.py --train [--imgsz 640] [--batch 16] [--model ...]
    ... [--precision bf16]   # half=True serving / amp training (default float32)

Serving: seeded random weights (as chip_smoke.py builds them) through
`YOLO.predict_batched` on ragged uint8 720x1280 frames, for a detect
or a JDE model; with --phase14, the weights and frames whose img/s chip_smoke.py's
phase 14 measures (seed 3, class logits damped, 480x640 frames). Training (--train): SGD
train steps of the seeded model on one batch of the port's synthetic data
(float32, TF32 off; with --precision bf16: `half=True` serving, `amp=True` training).
Prints, as JSON lines:
  * the host-clock time of one call or step, and of its stages (serving: frames
    to the card and letterbox, forward, decode + NMS, result to the host;
    training: batch to the card, forward, loss, backward, optimizer + EMA),
    each ended by a device synchronize; serving NMS's candidates a frame at --conf
    (min, median, max, frames at its pre_topk);
  * torch.profiler's device time per kernel name over one call or step, top 15,
    with the total device time and the share of the wall time the device was busy.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_port_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="yolov13n-JDE.yaml")
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--batch", type=int, default=None, help="8 serving, 16 training")
    ap.add_argument("--conf", type=float, default=0.005)
    ap.add_argument("--phase14", action="store_true",
                    help="chip_smoke.py phase 14's weights and 480x640 frames")
    ap.add_argument("--train", action="store_true", help="profile a train step instead")
    ap.add_argument("--precision", choices=("f32", "bf16"), default="f32")
    a = ap.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bf16 = a.precision == "bf16"
    if a.train:
        return profile_train(a.model, a.imgsz, a.batch or 16, bf16)
    a.batch = a.batch or 8

    if a.phase14:
        yolo, frames, _ = chip_smoke._detect_model(a.model, a.batch)
        a.imgsz = chip_smoke.DETECT_IMGSZ
    else:
        yolo = chip_smoke._perturbed_yolo(a.model, 0, a.imgsz)
        frames = np.random.default_rng(0).integers(0, 256, (a.batch, 720, 1280, 3), np.uint8)
    kw = dict(imgsz=a.imgsz, conf=a.conf, half=bf16)
    for _ in range(3):
        yolo.predict_batched(frames, **kw)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    predictor = yolo._get_predictor(kw)
    stages = {}
    with torch.no_grad():
        for _ in range(3):  # the last repetition is reported
            (x, _, _), stages["h2d_letterbox_ms"] = timed(lambda: predictor.preprocess(frames))
            feats, stages["forward_ms"] = timed(lambda: predictor.model(x))
            dets, stages["decode_nms_ms"] = timed(lambda: predictor.decode_nms(feats))
            _, stages["d2h_ms"] = timed(lambda: dets.cpu().numpy())
        candidates = chip_smoke._candidate_summary(chip_smoke._candidates(predictor, feats, a.conf))
    _, call_ms = timed(lambda: yolo.predict_batched(frames, **kw))
    print(json.dumps({"model": a.model, "imgsz": a.imgsz, "batch": a.batch,
                      "frames": "x".join(map(str, frames.shape[1:3])),
                      "weights": "phase 14" if a.phase14 else "seed 0", "conf": a.conf,
                      "precision": a.precision, "call_ms": call_ms, **stages,
                      "candidates_per_frame": candidates,
                      "device": torch.cuda.get_device_name(0)}))

    print_device_time(lambda: yolo.predict_batched(frames, **kw))
    return 0


def profile_train(model: str, imgsz: int, batch: int, bf16: bool) -> int:
    """Stage times and device breakdown of one SGD train step on one synthetic batch."""
    import torch

    import chip_smoke
    from sar_yolo_tpu_torch.engine.trainer import TRAINERS
    from sar_yolo_tpu_torch.nn.tasks import build_model
    task = build_model(model)[1]["task"]
    tr = TRAINERS[task](dict(model=model, data="synthetic", imgsz=imgsz, batch=batch, nbs=batch,
                             optimizer="SGD", warmup_epochs=0.0, amp=bf16))
    tr.setup()
    data = next(iter(tr.train_loader))
    timing = chip_smoke._timed_steps(tr, data)
    print(json.dumps({"model": model, "imgsz": imgsz, "batch": batch, "train": True,
                      "compute_dtype": str(tr.model.compute_dtype), **timing,
                      "device": torch.cuda.get_device_name(0)}))
    print_device_time(lambda: tr.train_step(data))
    return 0


def print_device_time(fn):
    """torch.profiler's device time per kernel name over one call of fn, and the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    rows = []  # device-side events only (kernels, copies): operator rows would count twice
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    for dev_us, key, count in rows[:15]:
        print(json.dumps({"kernel": key[:90], "device_ms": dev_us / 1e3, "calls": count,
                          "share": dev_us / 1e3 / total_ms if total_ms else None}))
    print(json.dumps({"profiled_wall_ms": wall_ms, "device_busy_ms": total_ms,
                      "device_busy_share": total_ms / wall_ms, "kernel_names": len(rows)}))


if __name__ == "__main__":
    sys.exit(main())
