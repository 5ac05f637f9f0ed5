"""Model-family facades of the port (RT-DETR, YOLO-World, SAM, FastSAM, NAS), imported lazily."""


def __getattr__(name):
    if name == "SAM":
        from sar_yolo_tpu_torch.models.sam import SAM
        return SAM
    if name == "FastSAM":
        from sar_yolo_tpu_torch.models.fastsam import FastSAM
        return FastSAM
    if name == "NAS":
        from sar_yolo_tpu_torch.models.nas import NAS
        return NAS
    if name == "RTDETR":
        from sar_yolo_tpu_torch.models.rtdetr import RTDETR
        return RTDETR
    raise AttributeError(name)


__all__ = ["SAM", "FastSAM", "NAS", "RTDETR"]
