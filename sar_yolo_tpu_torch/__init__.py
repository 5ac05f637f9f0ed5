"""PyTorch/CUDA port of sar_yolo_tpu, slice by slice (see ROADMAP.md).

The first slice serves yolov13-JDE: `YOLO("yolov13n-JDE.yaml").predict_batched(frames)`
letterboxes uint8 frames on the card, runs the BN-folded forward (area attention
in a hand-written CUDA kernel), decodes, runs NMS and gathers the ReID
embeddings of the kept detections.
"""

__all__ = ["YOLO"]


def __getattr__(name):
    if name == "YOLO":
        from sar_yolo_tpu_torch.engine.model import YOLO
        return YOLO
    raise AttributeError(name)
