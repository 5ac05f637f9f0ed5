"""TinyViT image encoder of MobileSAM (port of `sar_yolo_tpu/models/sam/tiny_vit.py`).

NCHW for the convolution stages; the attention blocks work on (B, H, W, C) windows, padded
bottom-right as JAX's `window_partition` pads (the padded tokens take part in the
attention, as there). BatchNorm runs in eval mode on its running statistics. Submodule
names are the Flax scopes (`pe_conv1.c`, `s0_mb0.conv2.bn`, `merge2`, `s3_blk1.attn`), so the
bridge maps JAX's params and batch_stats mechanically.
"""

from __future__ import annotations

import itertools
import math

import torch
from torch import nn
from torch.nn import functional as F

from sar_yolo_tpu_torch.models.sam.modules import (LayerNorm2d, softmax, window_partition,
                                                   window_unpartition)


class ConvBN(nn.Module):
    """Conv2d without bias, then BatchNorm (eps 1e-5)."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1, p: int = 0,
                 groups: int = 1):
        super().__init__()
        self.c = nn.Conv2d(c_in, c_out, k, s, p, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-5, momentum=0.1)

    def forward(self, x):
        return self.bn(self.c(x))


class MBConv(nn.Module):
    """Mobile inverted bottleneck with 4x expansion."""

    def __init__(self, dim: int, expand: float = 4.0):
        super().__init__()
        h = int(dim * expand)
        self.conv1 = ConvBN(dim, h)
        self.conv2 = ConvBN(h, h, 3, 1, 1, groups=h)
        self.conv3 = ConvBN(h, dim)

    def forward(self, x):
        y = F.gelu(self.conv2(F.gelu(self.conv1(x))))
        return F.gelu(x + self.conv3(y))


class PatchMerging(nn.Module):
    """Downsampling and channel change between stages; the depthwise stride is 1 for the
    320 / 448 / 576-dim last stage (SAM keeps its 64 x 64 grid)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        s = 1 if out_dim in {320, 448, 576} else 2
        self.conv1 = ConvBN(in_dim, out_dim)
        self.conv2 = ConvBN(out_dim, out_dim, 3, s, 1, groups=out_dim)
        self.conv3 = ConvBN(out_dim, out_dim)

    def forward(self, x):
        return self.conv3(F.gelu(self.conv2(F.gelu(self.conv1(x)))))


class BiasAttention(nn.Module):
    """Multi-head attention over window tokens with a learned bias per (|dy|, |dx|) offset,
    gathered from `attention_biases` by fixed indices."""

    def __init__(self, dim: int, key_dim: int, num_heads: int, attn_ratio: float = 4.0,
                 resolution=(7, 7)):
        super().__init__()
        self.num_heads, self.key_dim = num_heads, key_dim
        self.d = int(attn_ratio * key_dim)
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.qkv = nn.Linear(dim, num_heads * (2 * key_dim + self.d))
        self.proj = nn.Linear(num_heads * self.d, dim)
        pts = list(itertools.product(range(resolution[0]), range(resolution[1])))
        offsets, idxs = {}, []
        for p1 in pts:
            for p2 in pts:
                off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
                offsets.setdefault(off, len(offsets))
                idxs.append(offsets[off])
        self.attention_biases = nn.Parameter(torch.zeros(num_heads, len(offsets)))
        self.register_buffer("bias_idxs", torch.tensor(idxs).reshape(len(pts), len(pts)),
                             persistent=False)

    def forward(self, x):
        B, N, _ = x.shape
        kd = self.key_dim
        qkv = self.qkv(self.norm(x)).reshape(B, N, self.num_heads, 2 * kd + self.d)
        q, k, v = qkv.split([kd, kd, self.d], -1)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(kd)
        attn = attn + self.attention_biases[:, self.bias_idxs][None].to(attn.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", softmax(attn), v).reshape(B, N, -1)
        return self.proj(out)


class TinyViTBlock(nn.Module):
    """Window attention, a depthwise 3x3 ConvBN, then an MLP (NCHW in and out)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size = window_size
        # attn_ratio 1: the value dim is the key dim, so proj maps heads x key_dim = dim back
        self.attn = BiasAttention(dim, dim // num_heads, num_heads, attn_ratio=1.0,
                                  resolution=(window_size, window_size))
        self.local_conv = ConvBN(dim, dim, 3, 1, 1, groups=dim)
        self.mlp_norm = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        B, C, H, W = x.shape
        ws = self.window_size
        res = x.permute(0, 2, 3, 1)
        xw, pad_hw = window_partition(res, ws)
        xw = self.attn(xw.reshape(-1, ws * ws, C)).reshape(-1, ws, ws, C)
        x = (res + window_unpartition(xw, ws, pad_hw, (H, W))).permute(0, 3, 1, 2)
        x = self.local_conv(x).permute(0, 2, 3, 1)
        x = x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.mlp_norm(x))))
        return x.permute(0, 3, 1, 2)


class TinyViT(nn.Module):
    """TinyViT producing (B, out_chans, S / 16, S / 16) as SAM's ViT does."""

    def __init__(self, embed_dims=(64, 128, 160, 320), depths=(2, 2, 6, 2),
                 num_heads=(2, 4, 5, 10), window_sizes=(7, 7, 14, 7), out_chans: int = 256):
        super().__init__()
        d0 = embed_dims[0]
        self.depths = tuple(depths)
        self.pe_conv1 = ConvBN(3, d0 // 2, 3, 2, 1)
        self.pe_conv2 = ConvBN(d0 // 2, d0, 3, 2, 1)
        for i in range(depths[0]):
            self.add_module(f"s0_mb{i}", MBConv(d0))
        for s in range(1, 4):
            self.add_module(f"merge{s}", PatchMerging(embed_dims[s - 1], embed_dims[s]))
            for i in range(depths[s]):
                self.add_module(f"s{s}_blk{i}", TinyViTBlock(embed_dims[s], num_heads[s],
                                                             window_sizes[s]))
        self.neck_conv1 = nn.Conv2d(embed_dims[3], out_chans, 1, bias=False)
        self.neck_ln1 = LayerNorm2d(out_chans, eps=1e-6)
        self.neck_conv2 = nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False)
        self.neck_ln2 = LayerNorm2d(out_chans, eps=1e-6)

    def forward(self, x):
        x = self.pe_conv2(F.gelu(self.pe_conv1(x)))
        for i in range(self.depths[0]):
            x = getattr(self, f"s0_mb{i}")(x)
        for s in range(1, 4):
            x = getattr(self, f"merge{s}")(x)
            for i in range(self.depths[s]):
                x = getattr(self, f"s{s}_blk{i}")(x)
        return self.neck_ln2(self.neck_conv2(self.neck_ln1(self.neck_conv1(x))))


# mobile_sam_test is the JAX package's test size (its last dim in PatchMerging's stride-1 set,
# so the /16 geometry holds)
MOBILE_SAM_CONFIGS = {
    "mobile_sam": {},
    "mobile_sam_test": dict(
        img_size=128,
        tiny_cfg=dict(embed_dims=(16, 32, 40, 320), depths=(1, 1, 1, 1),
                      num_heads=(2, 4, 5, 10), window_sizes=(4, 4, 4, 4))),
}


def build_mobile_sam(name="mobile_sam", weights=None, dtype=torch.float32,
                     imgsz: int | None = None, device=None):
    """MobileSAM: the TinyViT encoder with SAM's prompt encoder and mask decoder; (SAMModel,
    info dict) as `build.build_sam` returns them."""
    from sar_yolo_tpu_torch.models.sam.build import _finish
    from sar_yolo_tpu_torch.models.sam.modules import SAMModel
    from sar_yolo_tpu_torch.utils import select_device
    device = select_device(device)
    cfg = dict(MOBILE_SAM_CONFIGS.get(name, {}))
    img_size = imgsz or cfg.pop("img_size", 1024)
    cfg.pop("img_size", None)
    return _finish(SAMModel(img_size=img_size, encoder="tiny", **cfg), name, weights, dtype,
                   device)
