"""SAM facade (port of `sar_yolo_tpu/models/sam/model.py`).

    sam = SAM("sam_b")                          # on cuda, seeded weights; raises without CUDA
    res = sam("img.jpg", points=[[500, 375]])
    res = sam("img.jpg", bboxes=[[100, 100, 400, 400]])
    res = sam("img.jpg")                        # segment everything
    sam = SAM("mobile_sam", device="cpu")       # MobileSAM's TinyViT encoder, on the CPU
    res = SAM("sam2_b").track(frames, bboxes=[[100, 100, 400, 400]])  # one Results a frame
"""

from __future__ import annotations

from sar_yolo_tpu_torch.utils import LOGGER
from sar_yolo_tpu_torch.utils.convert import from_jax_variables


class SAM:
    """Promptable segmentation model (SAM, MobileSAM or SAM2, by name)."""

    def __init__(self, model="sam_b.pt", weights=None, imgsz: int | None = None,
                 verbose: bool = False, device=None):
        from sar_yolo_tpu_torch.models.sam.build import build_sam
        self.model_name = str(model)
        self.model, self.info_dict = build_sam(model, weights=weights, imgsz=imgsz,
                                               device=device)
        self.is_sam2 = self.info_dict["is_sam2"]
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
        """Video object segmentation: the objects prompted on the first frame of `source` (a
        list of frames or a folder of images) are carried through the others by SAM2's memory
        bank; one Results a frame, the object's index in box column 6 and `frame` set.
        Raises ValueError for a model that is not SAM2."""
        if not self.is_sam2:
            raise ValueError("video tracking requires a SAM2 model (sam2_*)")
        from sar_yolo_tpu_torch.models.sam.predict import SAM2VideoPredictor
        vp = SAM2VideoPredictor(self.model, imgsz=self.info_dict["img_size"])
        return vp(source, bboxes=bboxes, points=points, labels=labels, **kwargs)

    def info(self):
        """Log and return the parameter count and configuration."""
        n = sum(p.numel() for p in self.model.parameters()) + sum(
            b.numel() for name, b in self.model.named_buffers() if name.endswith(
                ("running_mean", "running_var")))
        info = dict(self.info_dict, params=int(n))
        LOGGER.info(f"SAM {info}")
        return info
