"""SAM facade (port of `sar_yolo_tpu/models/sam/model.py`).

    sam = SAM("sam_b")                          # on cuda, seeded weights; raises without CUDA
    res = sam("img.jpg", points=[[500, 375]])
    res = sam("img.jpg", bboxes=[[100, 100, 400, 400]])
    res = sam("img.jpg")                        # segment everything
    sam = SAM("mobile_sam", device="cpu")       # MobileSAM's TinyViT encoder, on the CPU
"""

from __future__ import annotations

from pathlib import Path

from sar_yolo_tpu_torch.utils import LOGGER
from sar_yolo_tpu_torch.utils.convert import from_jax_variables


class SAM:
    """Promptable segmentation model (SAM or MobileSAM, by name)."""

    def __init__(self, model="sam_b.pt", weights=None, imgsz: int | None = None,
                 verbose: bool = False, device=None):
        from sar_yolo_tpu_torch.models.sam.build import build_sam
        self.model_name = str(model)
        self.is_sam2 = "sam2" in Path(str(model)).stem.lower()
        self.model, self.info_dict = build_sam(model, weights=weights, imgsz=imgsz,
                                               device=device)
        self.device = next(self.model.parameters()).device
        self.task = "segment"
        self.verbose = verbose
        self._predictor = None

    @property
    def predictor(self):
        if self._predictor is None:
            from sar_yolo_tpu_torch.models.sam.predict import SAMPredictor
            self._predictor = SAMPredictor(self.model, imgsz=self.info_dict["img_size"])
        return self._predictor

    def load_jax_variables(self, variables):
        """Load the JAX package's SAM variables ({"params"[, "batch_stats"]}, numpy arrays)."""
        sd = {k: v.to(self.device) for k, v in from_jax_variables(variables).items()}
        self.model.load_state_dict(sd, strict=True)
        if self._predictor is not None:
            self._predictor.reset_image()

    def predict(self, source, stream: bool = False, bboxes=None, points=None, labels=None,
                **kwargs):
        """Prompted (bboxes / points) or segment-everything (no prompt) Results."""
        out = self.predictor(source, bboxes=bboxes, points=points, labels=labels, **kwargs)
        return iter(out) if stream else out

    def __call__(self, source=None, stream: bool = False, bboxes=None, points=None,
                 labels=None, **kwargs):
        return self.predict(source, stream, bboxes, points, labels, **kwargs)

    def track(self, source, bboxes=None, points=None, labels=None, **kwargs):
        """Video object segmentation needs a SAM2 model, which this port does not have yet."""
        if not self.is_sam2:
            raise ValueError("video tracking requires a SAM2 model (sam2_*)")
        raise NotImplementedError("SAM2 video tracking is not part of this port yet")

    def info(self):
        """Log and return the parameter count and configuration."""
        n = sum(p.numel() for p in self.model.parameters()) + sum(
            b.numel() for name, b in self.model.named_buffers() if name.endswith(
                ("running_mean", "running_var")))
        info = dict(self.info_dict, params=int(n))
        LOGGER.info(f"SAM {info}")
        return info
