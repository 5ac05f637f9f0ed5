#!/usr/bin/env python3
"""Sweeps of the int8 path on the card: the conv kernel's tiles at every shape, ablated
builds of the conv, and the host cost of a quantized convolution.

    python3 tools/torch_port_int8_sweep.py [--no-host] [--ablate]

For yolov13n-JDE (`int8=True`) and yolov13l-JDE (`int8='auto'`) at 640 on 8 seeded 720x1280
frames (`chip_smoke.py`'s weights), every int8_conv call of one forward is recorded; at each
distinct shape every tile of `ops/cuda/int8_conv.py::TILES` is timed (CUDA-graph replay of
20 launches), and one JSON line gives the shape, its calls a forward, the tile
`pick_tile` takes and each tile's microseconds. A total line per model sums them over the
forward: the picked tiles, the best tile of each shape, each tile alone (a tile that cannot
run a shape, the 64-pixel tiles at the stem's 4-byte channels, counts the picked tile's time
there, so every total covers the whole forward).
Without `--no-host`, the host cost at batch 1: one pass of every quantized convolution
through `Int8Conv2d` on its own input, through `int8_quantize` and `int8_conv` alone, and
the same convolutions in cuDNN float32 (ms a pass, the host's time and after a
synchronize). `--ablate` times text-edited builds of the conv kernel at six shapes of those
models (no MMA; float32 stores that never happen; no copies into shared memory; plain
instead of streaming stores) beside a memset and an in-place scale of the output, to show
which part of the kernel takes the time. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

MODELS = (("yolov13n-JDE.yaml", True), ("yolov13l-JDE.yaml", "auto"))


# text edits of csrc/int8_conv.cu: each removes one part of the work (the no-store edit keeps a
# store that depends on the result and never happens, so the compiler keeps the work)
_STORE = """__stcs(reinterpret_cast<float4*>(static_cast<float*>(y) + o),
                 make_float4(r[0], r[1], r[2], r[3]));"""
ABLATIONS = {
    "no_mma": [("mma_s8(acc[i][j], af, bf[j][0], bf[j][1]);", ";")],
    "no_store": [(_STORE, "if (r[0] == 1234.5f && r[1] == -3.f && r[2] == 7.f && r[3] == 9.f) "
                          "static_cast<float*>(y)[o] = r[0];")],
    "no_copies": [("    if (s < kt_total) load(s);", "    if (s < 0) load(s);"),
                  ("    if (kt + kStages - 1 < kt_total) load((kt + kStages - 1) % kStages);", "")],
    "plain_store": [(_STORE, "*reinterpret_cast<float4*>(static_cast<float*>(y) + o) = "
                             "make_float4(r[0], r[1], r[2], r[3]);")],
}
ABLATION_SHAPES = (  # B, H, W, C, C_out, k, stride, padding: yolov13n/l-JDE @640 b8
    (8, 160, 160, 256, 256, 1, 1, 0), (8, 80, 80, 512, 512, 1, 1, 0), (8, 640, 640, 4, 64, 3, 2, 1),
    (8, 80, 80, 256, 256, 3, 1, 1), (8, 40, 40, 64, 64, 1, 1, 0), (8, 20, 20, 256, 256, 3, 1, 1))


def ablate():
    """Each ablation's microseconds at each of ABLATION_SHAPES, one JSON line a shape."""
    import torch

    import chip_smoke as cs
    from sar_yolo_tpu_torch.ops.cuda import int8_conv as ic
    from sar_yolo_tpu_torch.ops.cuda import nvcc
    text = ic.SOURCE.read_text()
    libs = {"shipped": ic._Library.get().conv}
    for name, edits in ABLATIONS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"ablation {name}: the source no longer holds {old!r}")
            src = src.replace(old, new)
        path = nvcc.BUILD_DIR / f"int8_conv_ablation_{name}.cu"
        path.write_text(src)
        lib = ctypes.CDLL(str(nvcc.build(path)[0]))
        for fn in (lib.int8_conv_f32, lib.int8_conv_bf16):
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = lib
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, H, W, C, N, k, s, p in ABLATION_SHAPES:
        xq = torch.randint(-127, 128, (B, H, W, C), device="cuda", generator=g, dtype=torch.int8)
        wq = torch.randint(-127, 128, (N, k, k, C), device="cuda", generator=g, dtype=torch.int8)
        sx, sw, bias = (torch.rand(n, device="cuda", generator=g) for n in (B, N, N))
        row = {"ablate": [B, H, W, C, N, k, s], "device": torch.cuda.get_device_name(0),
               **ic.plan(xq, wq, s, p, 1)}
        for name, lib in libs.items():
            ic._Library.conv = lib
            ic._conv_plan.cache_clear()
            row[f"{name}_us"] = cs.device_ms(lambda: ic.int8_conv(xq, wq, sx, sw, bias, s, p, 1),
                                             reps=3) * 1e3
        ic._Library.conv = libs["shipped"]
        ic._conv_plan.cache_clear()
        out = torch.empty(B, N, ic.out_size(H, k, s, p, 1), ic.out_size(W, k, s, p, 1),
                          device="cuda")
        row["memset_out_us"] = cs.device_ms(lambda: out.zero_(), reps=3) * 1e3
        row["scale_out_in_place_us"] = cs.device_ms(lambda: out.mul_(1.0), reps=3) * 1e3
        print(json.dumps(row))


def host_cost(pred, frames) -> dict:
    """ms a pass of every quantized conv at batch 1: (host, after a synchronize)."""
    import torch

    from sar_yolo_tpu_torch.nn.modules.conv import Int8Conv2d
    from sar_yolo_tpu_torch.ops.cuda import int8_conv as ic
    x1 = pred.preprocess(frames[:1])[0]
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append((m, a[0])))
             for m in pred.model.modules() if isinstance(m, Int8Conv2d)]
    with torch.no_grad():
        pred.model(x1)
    for h in hooks:
        h.remove()

    def timed(fn, n: int = 20):
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                fn()
            host = time.perf_counter() - t
            torch.cuda.synchronize()
            return host / n * 1e3, (time.perf_counter() - t) / n * 1e3
    weights = [m.quantized_weight() for m, _ in seen]
    quantized = [ic.int8_quantize(x, ic.channel_multiple(x.shape[1], x.device)) for _, x in seen]
    convs = [torch.nn.Conv2d(m.in_channels, m.out_channels, m.kernel_size, m.stride, m.padding,
                             m.dilation).cuda() for m, _ in seen]
    return {"quantized_convs": len(seen),
            "forward": timed(lambda: pred.model(x1)),
            "Int8Conv2d": timed(lambda: [m(x) for m, x in seen]),
            "int8_quantize": timed(lambda: [ic.int8_quantize(x, ic.channel_multiple(
                x.shape[1], x.device)) for _, x in seen]),
            "int8_conv": timed(lambda: [ic.int8_conv(xq, w[0], sx, w[1], w[2], m.stride[0],
                                                     m.padding[0], m.dilation[0])
                                        for (m, _), w, (xq, sx) in zip(seen, weights, quantized)]),
            "cudnn_float32": timed(lambda: [c(x) for c, (_, x) in zip(convs, seen)])}


def sweep(name: str, calls: list) -> dict:
    """Every tile at each distinct shape of `calls`; returns the totals over the forward."""
    import chip_smoke as cs
    from sar_yolo_tpu_torch.ops.cuda import int8_conv as ic
    groups = collections.OrderedDict()
    for _, _, args in calls:
        key = (tuple(args[0].shape), tuple(args[1].shape), *args[5:8])
        groups.setdefault(key, [args, 0])[1] += 1
    pick = ic.pick_tile
    totals = collections.Counter()
    for key, (args, n) in groups.items():
        plan = ic.plan(args[0], args[1], *args[5:8])
        picked = "x".join(map(str, plan["tile"]))
        row = {"sweep": name, "x": key[0], "w": key[1], "stride": key[2], "calls": n,
               "M": plan["M"], "N": plan["N"], "K": plan["K"], "picked": picked}
        times = {}
        for t, (bf, bp) in enumerate(ic.TILES):
            if bp == 64 and plan["Cp"] % 16:
                continue
            ic.pick_tile = lambda *a, t=t: t
            ic._conv_plan.cache_clear()
            times[f"{bf}x{bp}"] = cs.device_ms(lambda: ic.int8_conv(*args), reps=3)
        ic.pick_tile = pick
        ic._conv_plan.cache_clear()
        totals["picked"] += n * times[picked]
        totals["best"] += n * min(times.values())
        for bf, bp in ic.TILES:
            tile = f"{bf}x{bp}"
            totals[tile] += n * times.get(tile, times[picked])
        row["us"] = {k: round(v * 1e3, 2) for k, v in times.items()}
        print(json.dumps(row))
    return dict(totals)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-host", action="store_true", help="skip the host cost at batch 1")
    ap.add_argument("--ablate", action="store_true", help="time ablated builds of the conv")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_int8_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from sar_yolo_tpu_torch.ops.cuda import int8_conv as ic
    print(cs.phase_card())
    ic._Library.get()
    if args.ablate:
        ablate()
    frames = np.random.default_rng(0).integers(0, 256, (8, 720, 1280, 3), np.uint8)
    for name, req in MODELS:
        yolo = cs._perturbed_yolo(name, 0, 640)
        pred = yolo._get_predictor(dict(imgsz=640, int8=req))
        if not args.no_host:
            print(json.dumps({"host_ms_a_pass": name, "device": torch.cuda.get_device_name(0),
                              **host_cost(pred, frames)}))
        calls = []
        with cs._int8_calls(calls), torch.no_grad():
            pred.model(pred.preprocess(frames)[0])
        print(json.dumps({"sweep_total_ms": name, "device": torch.cuda.get_device_name(0),
                          **sweep(name, calls)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
