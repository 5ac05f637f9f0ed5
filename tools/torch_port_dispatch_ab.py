#!/usr/bin/env python3
"""The area-attention wrapper's host cost a call, and serving img/s, of two trees of the
PyTorch/CUDA port on one NVIDIA GPU, in turns.

    python3 tools/torch_port_dispatch_ab.py --parent DIR [--rounds 2]
    python3 tools/torch_port_dispatch_ab.py --one ROOT      # one tree's numbers
    python3 tools/torch_port_dispatch_ab.py --casts [--rounds 4]

DIR is another checkout of the repo (say, the parent commit unpacked with `git archive`
into a folder that `.gitignore` lists). `--parent` runs `--one` in a fresh process for DIR,
this tree, this tree and DIR, `--rounds` times over, and prints each run and each tree's
medians. `--one ROOT` imports `sar_yolo_tpu_torch` and `chip_smoke.py` from ROOT and prints
one JSON line:

  * `host_us`: the host time of one call of `ops/cuda/flash_attention.py::
    flash_area_attention` (what `AAttn` calls) at yolov13n-JDE's two attention shapes @640,
    batch 1 and 8, on q, k, v that are views of NCHW maps as `AAttn` gives them: 200 calls
    queued after a synchronize, timed before the closing synchronize (the queue stays
    under the driver's depth, so the time is the host's; `drain_us` is what the card still
    had to do). Under `torch.no_grad()` (serving) and with inputs that require a gradient
    (the train step's forward). The median of 5 runs.
  * `img_per_s`: `YOLO.predict_batched` of yolov13n-JDE @640 at batch 1 and 8, chip_smoke.py
    phase 4's model and frames (`_perturbed_yolo(..., seed 0)`, ragged 720x1280 uint8,
    conf 0.005): 10 calls after 3, host clock, 3 runs each.

`--casts` (this tree, one process) asks what identity casts cost a served forward. The
conv layers, blocks, DFL decode and NMS cast only a tensor of another dtype (`as_dtype`);
with `as_dtype` patched to an unconditional `.to`, a traced program holds an
`_assert_tensor_metadata` and a `to.dtype` node for each such call. For yolov13n-JDE and
yolov8n @640 with chip_smoke.py phase 21's weights and frames, it prints the img/s, in turns
over `--rounds` rounds at batch 1 and 8, of: the `.pt2` program with NMS as exported; the
program exported with the unconditional casts and then stripped of its assertion and
identity-cast nodes (a graph pass); the eager served model; the eager model with the
unconditional casts. The two programs' detections must be equal.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

SHAPES = [  # (label, B, C, H, W, heads, area): yolov13n-JDE's A2C2f calls @640
    ("P4 b1", 1, 64, 40, 40, 2, 4), ("P5 b1", 1, 128, 20, 20, 4, 1),
    ("P4 b8", 8, 64, 40, 40, 2, 4), ("P5 b8", 8, 128, 20, 20, 4, 1)]


def _host_us(fn, n: int = 200, runs: int = 5) -> dict:
    import torch
    host, drain = [], []
    for _ in range(runs + 1):  # the first run warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) / n * 1e6)
        drain.append((time.perf_counter() - t1) * 1e6)
    return {"host_us": statistics.median(host[1:]), "drain_us": statistics.median(drain[1:])}


def one(root: Path) -> dict:
    sys.path.insert(0, str(root))
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"root": str(root), "host_us": {}}
    for label, B, C, H, W, heads, area in SHAPES:
        def maps(c, grad=False):
            t = torch.randn(B, c, H * W, device=dev, generator=gen).requires_grad_(grad)
            return t.transpose(1, 2)  # (B, N, c) token views of an NCHW map
        for mode, grad in (("no_grad", False), ("grad", True)):
            qk, v = maps(2 * C, grad), maps(C, grad)
            q, k = qk[..., :C], qk[..., C:]
            ctx = torch.enable_grad() if grad else torch.no_grad()
            with ctx:
                out["host_us"][f"{label} {mode}"] = _host_us(
                    lambda: flash_area_attention(q, k, v, heads, area))
    yolo = chip_smoke._perturbed_yolo("yolov13n-JDE.yaml", 0, 640)
    frames = np.random.default_rng(0).integers(0, 256, (8, 720, 1280, 3), np.uint8)
    kw = dict(imgsz=640, conf=0.005)
    out["img_per_s"] = {}
    for b in (1, 8):
        runs = []
        for _ in range(3):
            for _ in range(3):
                yolo.predict_batched(frames[:b], **kw)
            t0 = time.perf_counter()
            for _ in range(10):
                yolo.predict_batched(frames[:b], **kw)
            runs.append(10 * b / (time.perf_counter() - t0))
        out["img_per_s"][f"b{b}"] = {"median": statistics.median(runs), "runs": runs}
    return out


def _strip_identity_casts(ep):
    """ep without `aten._assert_tensor_metadata` nodes and with each `aten.to.dtype` to the
    dtype its input has replaced by the input."""
    import torch
    aten = torch.ops.aten
    graph = ep.graph_module.graph
    for node in list(graph.nodes):
        if node.target is aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (node.target is aten.to.dtype and not any(node.args[2:]) and
              not any(node.kwargs.values()) and node.args[0].meta["val"].dtype == node.args[1]):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    ep.graph_module.recompile()
    return ep


class _UnconditionalCasts:
    """`as_dtype` as an unconditional `.to` in every module that calls it, while entered."""

    def __enter__(self):
        from sar_yolo_tpu_torch.nn.modules import block, conv
        from sar_yolo_tpu_torch.ops import boxes, nms
        self.mods = [block, conv, boxes, nms]
        self.saved = [m.as_dtype for m in self.mods]
        for m in self.mods:
            m.as_dtype = lambda x, dtype: x.to(dtype)
        return self

    def __exit__(self, *exc):
        for m, fn in zip(self.mods, self.saved):
            m.as_dtype = fn


def casts(rounds: int) -> dict:
    import shutil

    import numpy as np
    import torch

    import chip_smoke as c
    from sar_yolo_tpu_torch.nn.autobackend import AutoBackend
    root = Path("runs/dispatch_ab_casts")
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    for name, seed, hw in (("yolov13n-JDE.yaml", 0, (720, 1280)), ("yolov8n.yaml", 1, c.BENCH_HW)):
        yolo = c._perturbed_yolo(name, seed, c.EXPORT_IMGSZ)
        frames = np.random.default_rng(seed).integers(0, 256, (c.EXPORT_BATCH, *hw, 3), np.uint8)
        u8 = c._letterboxed(frames, c.EXPORT_IMGSZ)
        c._shift_class_bias(yolo, u8, 0.25, c.EXPORT_CANDIDATES)
        kw = dict(format="pt2", imgsz=c.EXPORT_IMGSZ, nms=True, dynamic=True)
        lean = AutoBackend(yolo.export(project=str(root / "lean"), **kw), device=yolo.device)
        with _UnconditionalCasts():
            path = yolo.export(project=str(root / "casts"), **kw)
        ep = torch.export.load(path)
        nodes = {"lean": len(lean.module.graph.nodes), "with_casts": len(ep.graph.nodes)}
        torch.export.save(_strip_identity_casts(ep), path)
        stripped = AutoBackend(path, device=yolo.device)
        nodes["stripped"] = len(stripped.module.graph.nodes)
        c.check(torch.equal(lean(u8), stripped(u8)), f"{name}: the two programs differ")

        def eager_casts(b):
            with _UnconditionalCasts():
                return c._eager_program(yolo, u8[:b], True).cpu()
        out[name] = {"nodes": nodes}
        for b in (1, len(u8)):
            out[name][f"b{b}"] = c._rates_in_turns({
                "program": (lambda: lean(u8[:b]).cpu(), b),
                "program_casts_stripped": (lambda: stripped(u8[:b]).cpu(), b),
                "eager": (lambda: c._eager_program(yolo, u8[:b], True).cpu(), b),
                "eager_unconditional_casts": (lambda: eager_casts(b), b)}, rounds=rounds)
        print(json.dumps({name: out[name]}), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="the other tree, run in turns with this one")
    ap.add_argument("--one", type=Path, help="measure the tree at this root")
    ap.add_argument("--casts", action="store_true", help="identity casts: programs and eager")
    ap.add_argument("--rounds", type=int, default=1)
    a = ap.parse_args()
    if a.casts:
        here = Path(__file__).resolve().parents[1]
        sys.path.insert(0, str(here))
        os.chdir(here)
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True).stdout
        print(card.strip())
        print(json.dumps({"casts_ab": casts(max(a.rounds, 4)), "card": card.strip()}))
        return 0
    if a.one:
        print(json.dumps({"dispatch_ab_run": one(a.one.resolve())}), flush=True)
        return 0
    if not a.parent:
        ap.error("give --parent DIR or --one ROOT")
    here = Path(__file__).resolve().parents[1]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    trees = {"parent": a.parent.resolve(), "change": here}
    runs = {k: [] for k in trees}
    for _ in range(a.rounds):
        for key in ("parent", "change", "change", "parent"):
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one",
                                   str(trees[key])], capture_output=True, text=True)
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"dispatch_ab_run"')]
            if proc.returncode or not lines:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                return 1
            run = json.loads(lines[-1])["dispatch_ab_run"]
            print(json.dumps({key: run}), flush=True)
            runs[key].append(run)
    summary = {}
    for key, rs in runs.items():
        summary[key] = {
            "host_us": {s: statistics.median(r["host_us"][s]["host_us"] for r in rs)
                        for s in rs[0]["host_us"]},
            "img_per_s": {b: statistics.median(r["img_per_s"][b]["median"] for r in rs)
                          for b in rs[0]["img_per_s"]}}
    summary["change_over_parent"] = {
        "host_us": {s: summary["change"]["host_us"][s] - summary["parent"]["host_us"][s]
                    for s in summary["change"]["host_us"]},
        "img_per_s": {b: summary["change"]["img_per_s"][b] / summary["parent"]["img_per_s"][b]
                      for b in summary["change"]["img_per_s"]}}
    print(json.dumps({"dispatch_ab": summary, "card": card.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
