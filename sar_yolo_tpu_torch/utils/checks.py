"""The bf16 sanity check of training (port of `sar_yolo_tpu/utils/checks.py::check_bf16`)."""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_leaves

from sar_yolo_tpu_torch.nn.modules.conv import set_compute_dtype
from sar_yolo_tpu_torch.nn.modules.transformer import RTDETRDecoder
from sar_yolo_tpu_torch.utils import LOGGER


@torch.no_grad()
def check_bf16(model: torch.nn.Module, imgsz: int = 64) -> bool:
    """Whether the bf16 forward of `model` tracks its float32 forward: the mean absolute
    difference of the first head map (the first leaf of the output) over the float32 map's mean magnitude is under 0.1,
    on one uniform random image (seed 0) of side imgsz, in eval mode.

    The JAX check feeds a bf16 image to a model whose compute is already bf16; this
    one runs the same weights with float32 compute against bf16 compute. The model
    leaves with bf16 compute and its train/eval mode as it came.

    An RT-DETR model's first output lists its queries in the order of their encoder
    scores, which bf16 rounding reshuffles; it is compared with each box coordinate
    sorted over the queries (the JAX check compares it query by query, and so finds
    every RT-DETR model divergent).
    """
    device = next(model.parameters()).device
    x = torch.rand(1, 3, imgsz, imgsz, generator=torch.Generator().manual_seed(0)).to(device)
    training = model.training
    model.eval()
    try:
        ordered = isinstance(model.blocks[-1], RTDETRDecoder)

        def first(out):
            leaf = tree_leaves(out)[0].float()
            return leaf.sort(-2)[0] if ordered else leaf
        set_compute_dtype(model, torch.float32)
        out32 = first(model(x))
        set_compute_dtype(model, torch.bfloat16)
        outbf = first(model(x))
        rel = ((out32 - outbf).abs().mean() / (out32.abs().mean() + 1e-6)).item()
        return rel < 0.1
    except Exception as e:  # noqa: BLE001 — a failed check means f32 training
        LOGGER.warning(f"check_bf16 failed: {e}")
        return False
    finally:
        set_compute_dtype(model, torch.bfloat16)
        model.train(training)
