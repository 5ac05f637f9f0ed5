"""SAM and MobileSAM promptable segmentation (port of `sar_yolo_tpu/models/sam/`, without SAM2)."""

from sar_yolo_tpu_torch.models.sam.build import build_sam
from sar_yolo_tpu_torch.models.sam.model import SAM
from sar_yolo_tpu_torch.models.sam.predict import SAMPredictor

__all__ = ["SAM", "SAMPredictor", "build_sam"]
