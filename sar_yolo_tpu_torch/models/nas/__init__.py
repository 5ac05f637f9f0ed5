"""YOLO-NAS facade (port of `sar_yolo_tpu/models/nas/__init__.py`): any detect-task YAML or
checkpoint under a predict / val-only API; `train` raises, as upstream's does."""

from __future__ import annotations

from sar_yolo_tpu_torch.engine.model import YOLO


class NAS(YOLO):
    """Examples:
        >>> m = NAS("yolo_nas.yaml")                 # on cuda; raises without CUDA
        >>> rows = m.predict_batched(frames_u8)      # (B, 300, 6)
    """

    def __init__(self, model: str = "yolo_nas.yaml", task: str | None = None, device=None):
        super().__init__(model, task="detect", device=device)

    def train(self, **kwargs):
        raise NotImplementedError("YOLO-NAS models only support predict/val (reference "
                                  "models/nas/model.py)")


__all__ = ["NAS"]
