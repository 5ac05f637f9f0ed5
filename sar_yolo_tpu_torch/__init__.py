"""PyTorch/CUDA port of sar_yolo_tpu, slice by slice (see ROADMAP.md).

`YOLO("yolov13n-JDE.yaml")` serves yolov13-JDE on the card: `predict_batched(frames)`
letterboxes uint8 frames on the card, runs the BN-folded forward (area attention in a
hand-written CUDA kernel), decodes, runs NMS and gathers the ReID embeddings of the
kept detections; `predict("frames/")` streams image files (JPEG and PNG decoded as
OpenCV decodes them), arrays or tensors through the same path, and `track(...)` adds
ByteTrack or BoT-SORT identities. `train` and `val` run on synthetic data or on a
YOLO-format JDE dataset on disk. `RTDETR("rtdetr-l.yaml")` serves, trains and validates
RT-DETR (no NMS), `YOLOWorld("yolov8s-world.yaml").set_classes([...])` YOLO-World.
`SAM("sam_b.pt")` / `SAM("mobile_sam")` serve promptable and segment-everything masks,
`FastSAM("FastSAM-s.yaml")` prompt-filtered everything-segmentation, `NAS("yolo_nas.yaml")`
a predict / val-only detector.
"""

# registers the area attention as `torch.ops.sar_yolo_tpu_torch.flash_area_attention`, which
# `torch.export.load` needs before it reads a .pt2 program of a model with A2C2f blocks
from sar_yolo_tpu_torch.ops.cuda import flash_attention as _flash_attention  # noqa: F401,E402

__all__ = ["YOLO", "RTDETR", "YOLOWorld", "SAM", "FastSAM", "NAS"]


def __getattr__(name):
    if name == "YOLO":
        from sar_yolo_tpu_torch.engine.model import YOLO
        return YOLO
    if name == "RTDETR":
        from sar_yolo_tpu_torch.models.rtdetr import RTDETR
        return RTDETR
    if name == "YOLOWorld":
        from sar_yolo_tpu_torch.models.yolo.world import YOLOWorld
        return YOLOWorld
    if name in ("SAM", "FastSAM", "NAS"):
        from sar_yolo_tpu_torch import models
        return getattr(models, name)
    raise AttributeError(name)
