"""Where the area-attention kernel's time goes, on one NVIDIA GPU: ablation builds.

    python3 -m sar_yolo_tpu_torch.ops.cuda.probe      (from the root of the repo)

Builds variants of `sar_yolo_tpu_torch/csrc/flash_area_attention.cu` by editing
its text (into sar_yolo_tpu_torch/build/probe/), loads each in place of the
kernel library and prints, as one JSON line per variant, its device time
(`device_ms` of the repo's chip_smoke.py) at four on-path shapes in float32 and bfloat16. Apart
from `base` and the launch plans, the variants compute wrong results: they only
remove work, to show what it costs.

  base             the kernel as committed
  no_mma           every mma.sync replaced by one f32 add of its operands
  no_softmax       no exponentials and no row-max shuffles
  no_mma_softmax   both: staging, fragment reads, Q loads, merge and stores
  no_staging       no cp.async copies (the products read stale shared memory)
  stages_3         three copy stages instead of two
  plan_S           every grid with S warps splitting each query tile's keys
                   (S = 4, 2, 1) instead of the plan's choice by grid size
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

from sar_yolo_tpu_torch.ops.cuda import nvcc

_REPO = Path(__file__).resolve().parents[3]

SHAPES = ("640 P5 b1", "640 P4 b4", "640 P4 b8", "1280 P4 b1")
_MMA_TF32 = ('"mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "\n'
             '      "{%8,%9}, {%0,%1,%2,%3};\\n"')
_MMA_BF16 = _MMA_TF32.replace("m16n8k8", "m16n8k16").replace("tf32.tf32", "bf16.bf16")
_ADD = '"add.f32 %0, %0, %4; add.f32 %1, %1, %8;\\n"'
_PLAN = "const int splits = tiles >= 6LL * SMS ? 1 : tiles >= 2LL * SMS ? 2 : 4;"


def _edits(name: str) -> list[tuple[str, str]]:
    no_mma = [(_MMA_TF32, _ADD), (_MMA_BF16, _ADD)]
    no_softmax = [
        ("s[n][c] = exp2_approx(fmaf(s[n][c], scale_log2, -m[c >> 1]));",
         "s[n][c] = s[n][c] * 0.01f;"),
        ("alpha[r] = exp2_approx(m[r] - m_new);", "alpha[r] = 1.f;"),
        ("__shfl_xor_sync(0xffffffffu, mx[r], 1)", "mx[r]"),
        ("__shfl_xor_sync(0xffffffffu, mx[r], 2)", "mx[r]")]
    table = {
        "base": [], "no_mma": no_mma, "no_softmax": no_softmax,
        "no_mma_softmax": no_mma + no_softmax,
        "no_staging": [("cp_async<W>(tile + d * PITCH + key, p, valid * static_cast<int>(sizeof(T)));",
                        "")],
        "stages_3": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    }
    table.update({f"plan_{s}": [(_PLAN, f"const int splits = {s};")] for s in (4, 2, 1)})
    return table[name]


def _build(name: str, source: str) -> tuple[Path, str]:
    for old, new in _edits(name):
        if old not in source:
            raise RuntimeError(f"probe variant {name}: the kernel source no longer holds {old!r}")
        source = source.replace(old, new)
    out = nvcc.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(source)
    proc = subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for probe variant {name}:\n{proc.stderr}")
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", proc.stderr)]
    return lib, f"{min(regs)}-{max(regs)}"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(_REPO))
    import chip_smoke
    from sar_yolo_tpu_torch.ops.cuda import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    source = fa.SOURCE.read_text()
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for label, B, C, H, W, heads, area in chip_smoke.KERNEL_SHAPES:
        if label in SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                qk = torch.randn(B, 2 * C, H, W, device="cuda", generator=g).to(dtype)
                vm = torch.randn(B, C, H, W, device="cuda", generator=g).to(dtype)
                tokens = qk.flatten(2).transpose(1, 2)
                cases.append((f"{label} {str(dtype).removeprefix('torch.')}", tokens[..., :C],
                              tokens[..., C:], vm.flatten(2).transpose(1, 2), heads, area))
    names = ["base", "no_mma", "no_softmax", "no_mma_softmax", "no_staging", "stages_3",
             "plan_4", "plan_2", "plan_1"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    for name in names:
        lib, regs = _build(name, source)
        fa._Library.load(lib)
        times = {}
        for key, q, k, v, heads, area in cases:
            times[key] = chip_smoke.device_ms(lambda: fa.flash_area_attention(q, k, v, heads, area))
        print(json.dumps({"variant": name, "registers": regs, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
