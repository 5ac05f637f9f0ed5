"""Detect, v10Detect, JDE, Pose, Segment, OBB, Classify and WorldDetect heads in NCHW (port of
`sar_yolo_tpu/nn/modules/head.py`).

Heads return raw per-level maps (B, no, H, W) in the compute dtype, as the JAX
heads do (Segment: the maps and its (B, nm, H/4, W/4) prototypes; Classify: (B, nc)
logits); decoding lives in
`ops/decode.py`, and the loss takes them to float32. Submodules carry the Flax names
(`cv2_0_0`, `cv3_0_pred`, `cv4_1_1`, `state_fc1`, `proto.upsample`).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from .conv import Conv, Conv2d, ConvTranspose2d, Dropout, DWConv, Linear
from .transformer import StandaloneBatchNorm


class Detect(nn.Module):
    """Anchor-free decoupled head with DFL box regression.

    `legacy` selects the v8 cls branch (two 3x3 Convs); otherwise the v13
    branch of depthwise and pointwise Convs.
    """

    def __init__(self, nc: int = 80, ch: tuple = (), reg_max: int = 16, legacy: bool = False):
        super().__init__()
        self.nc, self.ch, self.reg_max, self.legacy = nc, tuple(ch), reg_max, legacy
        self.nl = len(ch)
        self._add_branches()

    def _add_branches(self, prefix: str = ""):
        """The box (cv2) and cls (cv3) branches of every level, named with `prefix`."""
        ch, nc, reg_max = self.ch, self.nc, self.reg_max
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        for i, c in enumerate(ch):
            p = f"{prefix}cv2_{i}"
            self.add_module(f"{p}_0", Conv(c, c2, 3))
            self.add_module(f"{p}_1", Conv(c2, c2, 3))
            self.add_module(f"{p}_pred", Conv2d(c2, 4 * reg_max, 1))
            p = f"{prefix}cv3_{i}"
            if self.legacy:
                self.add_module(f"{p}_0", Conv(c, c3, 3))
                self.add_module(f"{p}_1", Conv(c3, c3, 3))
            else:
                self.add_module(f"{p}_0dw", DWConv(c, c, 3))
                self.add_module(f"{p}_0pw", Conv(c, c3, 1))
                self.add_module(f"{p}_1dw", DWConv(c3, c3, 3))
                self.add_module(f"{p}_1pw", Conv(c3, c3, 1))
            self.add_module(f"{p}_pred", Conv2d(c3, nc, 1))

    @property
    def no(self) -> int:
        return self.nc + self.reg_max * 4

    def _sub(self, name: str) -> nn.Module:
        return self._modules[name]

    def _box(self, x, i: int, prefix: str = ""):
        p = f"{prefix}cv2_{i}"
        return self._sub(f"{p}_pred")(self._sub(f"{p}_1")(self._sub(f"{p}_0")(x)))

    def _cls(self, x, i: int, prefix: str = ""):
        p = f"{prefix}cv3_{i}"
        if self.legacy:
            y = self._sub(f"{p}_1")(self._sub(f"{p}_0")(x))
        else:
            y = self._sub(f"{p}_0pw")(self._sub(f"{p}_0dw")(x))
            y = self._sub(f"{p}_1pw")(self._sub(f"{p}_1dw")(y))
        return self._sub(f"{p}_pred")(y)

    def _maps(self, xs, prefix: str = ""):
        return [torch.cat([self._box(x, i, prefix), self._cls(x, i, prefix)], 1)
                for i, x in enumerate(xs)]

    def forward(self, xs):
        return self._maps(xs)


class v10Detect(Detect):
    """The NMS-free head: a one2many copy of the Detect branches and a one2one copy
    (`o2o_` names). Train mode returns {"one2many": maps, "one2one": maps}; eval mode the
    one2one maps only, which `ops/nms.py::postprocess_end2end` serves without NMS.

    As in the JAX package, the one2one branch reads the live feature maps (Ultralytics
    detaches them, so there its loss sends no gradient into the neck), and the cls branch
    follows `legacy` (`nn/tasks.py` passes False: the depthwise one).
    """

    def __init__(self, nc: int = 80, ch: tuple = (), reg_max: int = 16, legacy: bool = False):
        super().__init__(nc, ch, reg_max, legacy)
        self._add_branches("o2o_")

    def forward(self, xs):
        o2o = self._maps(xs, "o2o_")
        if not self.training:
            return o2o
        return {"one2many": self._maps(xs), "one2one": o2o}


class JDE(Detect):
    """Detection + ReID embedding (+ posture state) head.

    Per-level channels: [box 4*reg_max, cls nc, embedding E, states S]. The
    state MLP runs on the embedding and is shared across levels.
    """

    def __init__(self, nc: int = 80, embed_dim: int = 128, state_classes: int | None = None,
                 ch: tuple = (), reg_max: int = 16, legacy: bool = False):
        super().__init__(nc, ch, reg_max, legacy)
        self.embed_dim, self.state_classes = embed_dim, state_classes
        c4 = max(ch[0] // 4, embed_dim)
        for i, c in enumerate(ch):
            self.add_module(f"cv4_{i}_0", Conv(c, c4, 3))
            self.add_module(f"cv4_{i}_1", Conv(c4, c4, 3))
            self.add_module(f"cv4_{i}_pred", Conv2d(c4, embed_dim, 1))
        if state_classes is not None:
            self.state_fc1 = Linear(embed_dim, embed_dim // 2)
            self.state_fc2 = Linear(embed_dim // 2, state_classes)
            self.dropout = Dropout(0.1)

    @property
    def no(self) -> int:
        return self.nc + self.reg_max * 4 + self.embed_dim + (self.state_classes or 0)

    def forward(self, xs):
        outs = []
        for i, x in enumerate(xs):
            e = self._sub(f"cv4_{i}_1")(self._sub(f"cv4_{i}_0")(x))
            emb = self._sub(f"cv4_{i}_pred")(e)
            parts = [self._box(x, i), self._cls(x, i), emb]
            if self.state_classes is not None:
                s = F.relu(self.state_fc1(emb.movedim(1, -1)))
                parts.append(self.state_fc2(self.dropout(s)).movedim(-1, 1))
            outs.append(torch.cat(parts, 1))
        return outs


class _ExtrasHead(Detect):
    """Detect plus a per-level branch of `ne` extra channels (`cv4_{i}`: two 3x3 Convs of
    max(ch[0] // 4, ne) channels and a 1x1 prediction), concatenated after box and cls."""

    def __init__(self, nc: int, ne: int, ch: tuple, reg_max: int, legacy: bool):
        super().__init__(nc, ch, reg_max, legacy)
        self.ne = ne
        c4 = max(ch[0] // 4, ne)
        for i, c in enumerate(ch):
            self.add_module(f"cv4_{i}_0", Conv(c, c4, 3))
            self.add_module(f"cv4_{i}_1", Conv(c4, c4, 3))
            self.add_module(f"cv4_{i}_pred", Conv2d(c4, ne, 1))

    @property
    def no(self) -> int:
        return self.nc + self.reg_max * 4 + self.ne

    def _maps(self, xs, prefix: str = ""):
        return [torch.cat([self._box(x, i), self._cls(x, i), self._sub(f"cv4_{i}_pred")(
            self._sub(f"cv4_{i}_1")(self._sub(f"cv4_{i}_0")(x)))], 1) for i, x in enumerate(xs)]


class Pose(_ExtrasHead):
    """Keypoint head: Detect plus K x D raw keypoint channels per anchor (xy offsets, then
    the visibility logit where D is 3)."""

    def __init__(self, nc: int = 80, kpt_shape: tuple = (17, 3), ch: tuple = (),
                 reg_max: int = 16, legacy: bool = False):
        self.kpt_shape = tuple(kpt_shape)
        super().__init__(nc, self.kpt_shape[0] * self.kpt_shape[1], ch, reg_max, legacy)


class Proto(nn.Module):
    """Mask prototypes: Conv 3x3, a learned 2x upsample (`ConvTranspose2d(c_, 2, 2)`, biased,
    no BN), Conv 3x3, Conv 1x1 to c2 channels."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = ConvTranspose2d(c_, c_, 2, 2)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, c2, 1)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


class Segment(_ExtrasHead):
    """Segmentation head: Detect plus nm mask coefficients per anchor; returns (maps, protos),
    the prototypes (B, nm, 2 H3, 2 W3) from the first level's features."""

    def __init__(self, nc: int = 80, nm: int = 32, npr: int = 256, ch: tuple = (),
                 reg_max: int = 16, legacy: bool = False):
        super().__init__(nc, nm, ch, reg_max, legacy)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm)

    def forward(self, xs):
        return self._maps(xs), self.proto(xs[0])


class OBB(_ExtrasHead):
    """Oriented-box head: Detect plus `ne` raw angle channels per anchor (the angle is
    (sigmoid - 0.25) pi, in `ops/decode.py::decode_obb` and the loss)."""

    def __init__(self, nc: int = 80, ne: int = 1, ch: tuple = (), reg_max: int = 16,
                 legacy: bool = False):
        super().__init__(nc, ne, ch, reg_max, legacy)


class Classify(nn.Module):
    """Classification head: the inputs concatenated on channels (a list), a 1x1 Conv to
    c_ = 1280 channels, the spatial mean, Dropout(dropout), then a Linear to nc logits (its
    parameters float32, its compute in the model's dtype). Returns (B, nc) logits."""

    def __init__(self, c1: int, nc: int, c_: int = 1280, dropout: float = 0.0):
        super().__init__()
        self.nc = nc
        self.conv = Conv(c1, c_, 1, 1)
        self.dropout = Dropout(dropout)
        self.linear = Linear(c_, nc)

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            x = torch.cat(x, 1)
        return self.linear(self.dropout(self.conv(x).mean((2, 3))))


class WorldDetect(Detect):
    """YOLO-World's open-vocabulary head: Detect's box branch, a cls branch of two 3x3 Convs
    (whatever `legacy` says) ending in an `embed_dim` projection, and per level a contrastive
    head that scores the embedding against the text rows `txt` (n, E) or (B, n, E), in
    float32: both sides l2-normalized (eps 1e-6), times exp(`cv4_{i}_logit_scale`), plus
    `cv4_{i}_bias`; with `with_bn` a BatchNorm (`cv4_{i}_norm`, momentum 0.9, eps 1e-5)
    replaces the image side's normalization. Per-level maps (B, 4 reg_max + n, H, W); the
    class channels follow the text row count, the convolutions keep `nc`."""

    def __init__(self, nc: int = 80, embed_dim: int = 512, with_bn: bool = False,
                 ch: tuple = (), reg_max: int = 16, legacy: bool = False):
        nn.Module.__init__(self)
        self.nc, self.ch, self.reg_max, self.legacy = nc, tuple(ch), reg_max, True
        self.nl, self.embed_dim, self.with_bn = len(ch), embed_dim, with_bn
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        for i, c in enumerate(ch):
            self.add_module(f"cv2_{i}_0", Conv(c, c2, 3))
            self.add_module(f"cv2_{i}_1", Conv(c2, c2, 3))
            self.add_module(f"cv2_{i}_pred", Conv2d(c2, 4 * reg_max, 1))
            self.add_module(f"cv3_{i}_0", Conv(c, c3, 3))
            self.add_module(f"cv3_{i}_1", Conv(c3, c3, 3))
            self.add_module(f"cv3_{i}_pred", Conv2d(c3, embed_dim, 1))
            setattr(self, f"cv4_{i}_bias", nn.Parameter(torch.tensor(-10.0)))
            setattr(self, f"cv4_{i}_logit_scale", nn.Parameter(
                torch.tensor(-1.0 if with_bn else math.log(1 / 0.07))))
            if with_bn:
                norm = StandaloneBatchNorm(embed_dim, eps=1e-5, momentum=0.1)
                norm.follows_compute_dtype = False  # a float32 BatchNorm in JAX
                self.add_module(f"cv4_{i}_norm", norm)

    def forward(self, xs, txt):
        t = txt.float()
        t = t / (t.norm(dim=-1, keepdim=True) + 1e-6)
        tq = t if t.ndim == 2 else t[0]
        outs = []
        for i, x in enumerate(xs):
            box = self._box(x, i)
            e = self._cls(x, i).float()
            if self.with_bn:
                e = self._sub(f"cv4_{i}_norm")(e)
            else:
                e = e / (e.norm(dim=1, keepdim=True) + 1e-6)
            scale, bias = getattr(self, f"cv4_{i}_logit_scale"), getattr(self, f"cv4_{i}_bias")
            logits = torch.einsum("behw,ce->bchw", e, tq) * torch.exp(scale) + bias
            outs.append(torch.cat([box, logits.to(box.dtype)], 1))
        return outs
