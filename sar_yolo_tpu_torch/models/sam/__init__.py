"""SAM, MobileSAM and SAM2 promptable segmentation, and SAM2 video tracking (port of
`sar_yolo_tpu/models/sam/`)."""

from sar_yolo_tpu_torch.models.sam.build import build_sam
from sar_yolo_tpu_torch.models.sam.model import SAM
from sar_yolo_tpu_torch.models.sam.predict import SAM2VideoPredictor, SAMPredictor

__all__ = ["SAM", "SAM2VideoPredictor", "SAMPredictor", "build_sam"]
