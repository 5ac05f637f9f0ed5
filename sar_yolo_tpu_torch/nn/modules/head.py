"""Detect and JDE heads in NCHW (port of `sar_yolo_tpu/nn/modules/head.py`).

Heads return raw per-level maps (B, no, H, W) in the compute dtype, as the JAX
heads do; decoding lives in `ops/decode.py`, and the loss takes them to float32.
Submodules carry the Flax names (`cv2_0_0`, `cv3_0_pred`, `cv4_1_1`, `state_fc1`).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .conv import Conv, Conv2d, Dropout, DWConv, Linear


class Detect(nn.Module):
    """Anchor-free decoupled head with DFL box regression.

    `legacy` selects the v8 cls branch (two 3x3 Convs); otherwise the v13
    branch of depthwise and pointwise Convs.
    """

    def __init__(self, nc: int = 80, ch: tuple = (), reg_max: int = 16, legacy: bool = False):
        super().__init__()
        self.nc, self.ch, self.reg_max, self.legacy = nc, tuple(ch), reg_max, legacy
        self.nl = len(ch)
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        for i, c in enumerate(ch):
            self.add_module(f"cv2_{i}_0", Conv(c, c2, 3))
            self.add_module(f"cv2_{i}_1", Conv(c2, c2, 3))
            self.add_module(f"cv2_{i}_pred", Conv2d(c2, 4 * reg_max, 1))
            if legacy:
                self.add_module(f"cv3_{i}_0", Conv(c, c3, 3))
                self.add_module(f"cv3_{i}_1", Conv(c3, c3, 3))
            else:
                self.add_module(f"cv3_{i}_0dw", DWConv(c, c, 3))
                self.add_module(f"cv3_{i}_0pw", Conv(c, c3, 1))
                self.add_module(f"cv3_{i}_1dw", DWConv(c3, c3, 3))
                self.add_module(f"cv3_{i}_1pw", Conv(c3, c3, 1))
            self.add_module(f"cv3_{i}_pred", Conv2d(c3, nc, 1))

    @property
    def no(self) -> int:
        return self.nc + self.reg_max * 4

    def _sub(self, name: str) -> nn.Module:
        return self._modules[name]

    def _box(self, x, i: int):
        y = self._sub(f"cv2_{i}_1")(self._sub(f"cv2_{i}_0")(x))
        return self._sub(f"cv2_{i}_pred")(y)

    def _cls(self, x, i: int):
        if self.legacy:
            y = self._sub(f"cv3_{i}_1")(self._sub(f"cv3_{i}_0")(x))
        else:
            y = self._sub(f"cv3_{i}_0pw")(self._sub(f"cv3_{i}_0dw")(x))
            y = self._sub(f"cv3_{i}_1pw")(self._sub(f"cv3_{i}_1dw")(y))
        return self._sub(f"cv3_{i}_pred")(y)

    def forward(self, xs):
        return [torch.cat([self._box(x, i), self._cls(x, i)], 1) for i, x in enumerate(xs)]


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
