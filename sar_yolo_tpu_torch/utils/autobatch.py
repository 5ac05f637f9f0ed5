"""`batch=-1`: the largest power of two (1 to 1024) whose train step fits `fraction` of the
device's free memory (port of `sar_yolo_tpu/utils/autobatch.py`'s contract).

The JAX package estimates an image's cost as 180 imgsz^2 bytes, a constant fitted to XLA on a
TPU; for yolov13n-JDE at 640 on an 80 GB card it gives 512, where the float32 step takes
about 0.64 GiB an image. On CUDA the port measures instead, as Ultralytics' autobatch does:
the peak memory (`torch.cuda.max_memory_allocated`) of real train steps at two small
batches, a straight line through them, and the free memory from `torch.cuda.mem_get_info`
plus what the caching allocator holds unused. Without device memory statistics (the CPU) it
returns 16, as the JAX package does off its accelerator.
"""

from __future__ import annotations

import numpy as np
import torch

from sar_yolo_tpu_torch.utils import LOGGER

PROBE_BATCHES = (2, 4)


def batch_for(batches, peaks, free: float, fraction: float = 0.8, fixed: float = 0.0) -> int:
    """The largest power of two b in [1, 1024] with fixed + the fitted line's peak at b
    within fraction x free: `peaks` are the bytes a step adds at `batches` (a degree-1 fit)."""
    slope, intercept = np.polyfit(np.asarray(batches, float), np.asarray(peaks, float), 1)
    batch = int(max(free * fraction - fixed - intercept, 0) // max(slope, 1.0))
    batch = max(1, min(batch, 1024))
    p = 1
    while p * 2 <= batch:
        p *= 2
    return p


def check_train_batch_size(step_peak=None, device=None, fraction: float = 0.8,
                           fixed: float = 0.0) -> int:
    """The batch for `batch=-1`. `step_peak(b)`: the bytes one train step at batch b adds to
    what is allocated before it (its peak); `fixed`: bytes the run allocates beside the step
    (the EMA and the optimizer's state). 16 where `device` is not CUDA."""
    device = torch.device(device or "cpu")
    if device.type != "cuda" or step_peak is None:
        LOGGER.warning("autobatch: no device memory stats; defaulting to 16")
        return 16
    peaks = [step_peak(b) for b in PROBE_BATCHES]
    free = torch.cuda.mem_get_info(device)[0] + torch.cuda.memory_reserved(device) \
        - torch.cuda.memory_allocated(device)
    batch = batch_for(PROBE_BATCHES, peaks, free, fraction, fixed)
    LOGGER.info(f"autobatch: free={free / 1e9:.1f}GB, "
                f"{(peaks[1] - peaks[0]) / (PROBE_BATCHES[1] - PROBE_BATCHES[0]) / 2**30:.3f} "
                f"GiB an image -> batch={batch}")
    return batch
