"""Model-FLOPs utilization (port of `sar_yolo_tpu/utils/mfu.py`): achieved TFLOP/s over the
card's dense bf16 peak. The FLOPs are `torch.utils.flop_counter.FlopCounterMode`'s count of
one forward on the `meta` device (convolutions and matmuls, 2 a multiply-add), where the JAX
package reads XLA's cost analysis of the compiled forward.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

# dense bf16 tensor-core TFLOP/s by card name (NVIDIA's spec sheet); the H100 SXM (80GB HBM3)
# is the only card the port is measured on
_PEAK_BF16_TFLOPS = {
    "h100 80gb hbm3": 989.0,
    "h100 sxm": 989.0,
}


def chip_peak_bf16_tflops() -> float | None:
    """Dense bf16 TFLOP/s of card 0, or None off CUDA or for a card not in the table."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(0).lower()
    for key, peak in _PEAK_BF16_TFLOPS.items():
        if key in name:
            return peak
    return None


def model_fwd_gflops(model, imgsz: int = 640, batch: int = 1) -> float | None:
    """GFLOPs an image of one eval forward of `model` (a GraphModel) at imgsz x imgsz, counted
    on a `meta` copy (nothing runs on the card); None where the count fails or is 0."""
    from sar_yolo_tpu_torch.engine.model import _meta_copy
    try:
        net = _meta_copy(model)
        x = torch.zeros(batch, 3, imgsz, imgsz, device="meta",
                        dtype=getattr(model, "compute_dtype", torch.float32))
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            net(x)
    except Exception:  # noqa: BLE001 — accounting must never break callers
        return None
    flops = counter.get_total_flops()
    return float(flops) / batch / 1e9 if flops else None


def mfu_pct(imgs_per_sec: float, gflops_per_img: float,
            peak_tflops: float | None = None) -> float | None:
    """Percent of the card's peak achieved at `imgs_per_sec` for `gflops_per_img`."""
    peak = peak_tflops if peak_tflops is not None else chip_peak_bf16_tflops()
    if not peak:
        return None
    return 100.0 * (imgs_per_sec * gflops_per_img / 1e3) / peak
