"""RT-DETR facade (port of `sar_yolo_tpu/models/rtdetr/__init__.py`)."""

from sar_yolo_tpu_torch.engine.model import YOLO
from sar_yolo_tpu_torch.engine.predictor import RTDETRPredictor
from sar_yolo_tpu_torch.engine.trainer import RTDETRTrainer
from sar_yolo_tpu_torch.engine.validator import RTDETRValidator


class RTDETR(YOLO):
    """The YOLO facade over an RT-DETR model: trains with `RTDETRTrainer`, validates with
    `RTDETRValidator` and serves with `RTDETRPredictor` ((B, 300, 6) rows, no NMS).

    Examples:
        >>> m = RTDETR("rtdetr-l.yaml")                  # on cuda; raises without CUDA
        >>> rows = m.predict_batched(frames_u8)           # (B, 300, 6)
        >>> m = RTDETR("tinyrtdetr.yaml", device="cpu")
        >>> m.train(data="synthetic", imgsz=64, batch=4, epochs=1, project="/tmp/runs")
    """

    def __init__(self, model: str = "rtdetr-l.yaml", task: str | None = None, device=None):
        super().__init__(model, task="detect", device=device)

    @property
    def task_map(self) -> dict:
        return {"detect": {"trainer": RTDETRTrainer, "validator": RTDETRValidator,
                           "predictor": RTDETRPredictor}}


__all__ = ["RTDETR", "RTDETRTrainer", "RTDETRValidator", "RTDETRPredictor"]
