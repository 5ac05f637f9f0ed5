#!/usr/bin/env python3
"""Reruns of chip_smoke.py's phase 8 (train on a PNG dataset, then the rect-val A/B of the
kernel path against `use_flash=False`) on one NVIDIA GPU, until one fails.

    python3 tools/torch_port_phase8_reruns.py [--runs 10] [--diagnose-all]
        [--out runs/phase8_reruns.jsonl]

Each run trains a new model (cuDNN's choices are not deterministic, so each run is a new
sample of trained weights) and validates it as phase 8 does. A run prints one JSON line:
its seconds, a fingerprint of the trained weights and the A/B's numbers, or the failure.

At a failed A/B (or, with --diagnose-all, at every run) it also prints, for each val image
whose kept rows differ between the two paths at the A/B's threshold, why greedy NMS chose
differently: for each anchor kept on one path and not on the other, the anchor that
suppressed it there, both scores and their IoU on the kernel path, on the plain path and
in float64 (the plain model run in float64), and how far each lies from its cut (the
score gap, the IoU's distance to the NMS threshold, the score's distance to conf). It
also holds the head maps of every val batch against float64 as phase 4 does (the kernel
path no farther than twice the plain path), and reports for each val image whether a
threshold exists at which greedy NMS does not hang on rounding (`stable_report`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _kept_anchors(preds, conf: float, iou: float, nc: int):
    """Anchors greedy NMS keeps per image (the validator's single-label NMS)."""
    import torch

    from sar_yolo_tpu_torch.ops.nms import non_max_suppression
    B, N, _ = preds.shape
    bank = torch.arange(N, device=preds.device, dtype=torch.float32)[None, :, None].expand(B, N, 1)
    out = non_max_suppression(preds[..., :4 + nc].float(), conf_thres=conf, iou_thres=iou,
                              max_det=300, nc=nc, extras_bank=bank)
    return [set(int(a) for a, s in zip(out[b, :, 6].tolist(), out[b, :, 4].tolist()) if s > 0)
            for b in range(B)]


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two xywh boxes, float64."""
    lo = np.maximum(a[:2] - a[2:] / 2, b[:2] - b[2:] / 2)
    hi = np.minimum(a[:2] + a[2:] / 2, b[:2] + b[2:] / 2)
    inter = float(np.clip(hi - lo, 0, None).prod())
    return inter / (float(a[2:].prod()) + float(b[2:].prod()) - inter)


def stable_report(yolo, xs: list, iou: float = 0.7) -> list:
    """For each val image: the float32 plain path's largest score distance from float64,
    the top scores in float64, and for margins on the score (4x that distance, 1e-6, 1e-4)
    and on the IoU (1e-3, 1e-4, 1e-5) the threshold `chip_smoke._nms_stable_conf` finds
    (None where it finds none) with the candidates above it."""
    import torch

    import chip_smoke as cs
    meta, nc = yolo.meta, yolo.meta["nc"]
    exact = cs._float64_copy(yolo)._fused
    plain = cs.copy.deepcopy(yolo)
    cs._set_flash(plain, False)
    plain._fused = None
    out = []
    for x in xs:
        with torch.no_grad():
            r64 = cs.decode_detect_rows(exact(x.double()), meta)[..., :4 + nc]
            r32 = cs.decode_detect_rows(plain._fused_for_serving()(x), meta)[..., :4 + nc]
        for i in range(x.shape[0]):
            rounding = float(np.abs(r32[i, :, 4:] - r64[i, :, 4:]).max())
            top = np.sort(r64[i, :, 4:].max(-1))[::-1]
            variants = {}
            for sname, m in (("4x_rounding", max(4 * rounding, 1e-8)), ("1e-6", 1e-6),
                             ("1e-4", 1e-4)):
                for im in (1e-3, 1e-4, 1e-5):
                    try:
                        c, _ = cs._nms_stable_conf(r64[i:i + 1], nc, iou, 300, margin=m,
                                                   iou_margin=im)
                        variants[f"score {sname}, iou {im}"] = [c, int((top > c).sum())]
                    except RuntimeError:
                        variants[f"score {sname}, iou {im}"] = None
            out.append({"image": len(out), "rounding": rounding, "top_scores": top[:8].tolist(),
                        "score_300th": float(top[299]), "variants": variants})
    return out


def diagnose(yolo, xs: list, conf: float, iou: float = 0.7) -> dict:
    """Why NMS keeps different rows on the two paths (see the module docstring)."""
    import torch

    import chip_smoke as cs
    from sar_yolo_tpu_torch.ops.decode import decode_detect
    meta = yolo.meta
    nc = meta["nc"]
    plain = cs.copy.copy(yolo)
    plain.model, plain._fused = cs.copy.deepcopy(yolo.model), None
    cs._set_flash(plain, False)
    exact = cs._float64_copy(yolo)

    def rows(model, x):
        with torch.no_grad():
            return decode_detect(model(x), meta["strides"], nc, meta["reg_max"],
                                 extra_sigmoid=meta["state_classes"],
                                 split_extras=meta["embed_dim"])[0]

    out, maps, frame0 = [], {}, 0
    for x in xs:
        for k, v in cs._maps_errors(yolo, plain, x, conf, exact=exact._fused).items():
            if k.startswith("maps"):
                maps[k] = max(maps.get(k, 0.0), v)
        rk, rp = rows(yolo._fused_for_serving(), x), rows(plain._fused_for_serving(), x)
        r64 = rows(exact._fused, x.double()).cpu().numpy()
        kk, kp = _kept_anchors(rk, conf, iou, nc), _kept_anchors(rp, conf, iou, nc)
        nk, np_ = rk.double().cpu().numpy(), rp.double().cpu().numpy()
        for b in range(x.shape[0]):
            if kk[b] == kp[b]:
                continue
            paths = {"kernel": nk[b], "plain": np_[b], "float64": r64[b]}
            cases = []
            for a in sorted(kk[b] ^ kp[b]):
                lost_on = "plain" if a in kk[b] else "kernel"
                kept = kp[b] if lost_on == "plain" else kk[b]
                r = paths[lost_on]
                sa = float(r[a, 4:4 + nc].max())
                by = [s for s in kept if r[s, 4:4 + nc].max() >= sa and s != a
                      and r[s, 4:4 + nc].argmax() == r[a, 4:4 + nc].argmax()
                      and _iou(r[a, :4], r[s, :4]) > iou]
                case = {"anchor": a, "kept_on": "kernel" if lost_on == "plain" else "plain",
                        "suppressed_on": lost_on, "suppressor": by[:1] or None}
                for name, rr in paths.items():
                    s_a = float(rr[a, 4:4 + nc].max())
                    entry = {"score": s_a, "score_minus_conf": s_a - conf}
                    if by:
                        s_s = float(rr[by[0], 4:4 + nc].max())
                        v = _iou(rr[a, :4], rr[by[0], :4])
                        entry.update({"suppressor_score": s_s, "score_gap": s_s - s_a,
                                      "iou": v, "iou_minus_thres": v - iou})
                    case[name] = entry
                cases.append(case)
            out.append({"image": frame0 + b, "kept_kernel": len(kk[b]), "kept_plain": len(kp[b]),
                        "differing_anchors": cases})
        frame0 += x.shape[0]
    maps["kernel_within_twice_plain"] = maps["maps_kernel_vs_f64"] <= 2 * maps["maps_plain_vs_f64"]
    return {"conf": conf, "iou": iou, "images_that_differ": out, **maps,
            "stable_thresholds": stable_report(yolo, xs, iou)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--out", default="runs/phase8_reruns.jsonl")
    parser.add_argument("--diagnose-all", action="store_true")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    card = cs.phase_card()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    log = open(args.out, "a")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        log.write(line + "\n")
        log.flush()

    seen = {}
    orig_val_ab = cs._val_ab

    def val_ab(yolo, kw, xs, label, **options):
        params = torch.cat([p.detach().double().flatten() for p in yolo.model.parameters()])
        seen["fingerprint"] = [params.sum().item(), params.abs().sum().item()]
        try:
            result = orig_val_ab(yolo, kw, xs, label, **options)
        except Exception:
            conf = seen.get("conf")
            seen["diagnosis"] = diagnose(yolo, xs, conf) if conf is not None else None
            raise
        if args.diagnose_all:
            seen["diagnosis"] = diagnose(yolo, xs, result["ab_conf"])
        return result

    orig_ab_conf = cs._ab_conf

    def ab_conf(scores, max_det, margin=1e-5):
        conf, half = orig_ab_conf(scores, max_det, margin)
        seen["conf"] = conf
        return conf, half

    cs._val_ab, cs._ab_conf = val_ab, ab_conf
    failures = 0
    for run in range(1, args.runs + 1):
        seen.clear()
        t0 = time.perf_counter()
        try:
            cs.phase_data(card, seed=0)
            status = "passed"
        except Exception as e:  # noqa: BLE001 — a failed run is the result we look for
            status = f"failed: {e}"
            traceback.print_exc()
            failures += 1
        emit({"run": run, "status": status, "seconds": time.perf_counter() - t0,
              "weights_fingerprint": seen.get("fingerprint"), "ab_conf": seen.get("conf"),
              "diagnosis": seen.get("diagnosis"), "card": card})
        torch.cuda.empty_cache()
        if failures:
            break
    emit({"runs": run, "failures": failures, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
