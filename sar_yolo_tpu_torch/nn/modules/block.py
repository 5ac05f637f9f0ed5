"""YOLO blocks of the yolov8, yolo11, yolov12 and yolov13 graphs and the fork's CBAM
variants, in NCHW (port of `sar_yolo_tpu/nn/modules/block.py`).

Submodule names are the Flax scope names (`cv1`, `m0_0`, `attn`, `qk`, ...).
Tokens of a (B, C, H, W) map are taken as `x.flatten(2).transpose(1, 2)`,
which gives the JAX package's row-major (B, H*W, C) order. Under a bf16 compute
dtype the blocks follow the JAX modules' dtypes: parameters used outside a
Conv2d or Linear (prototypes, gamma, gate) are cast to the data's dtype, and
softmaxes run in float32.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from sar_yolo_tpu_torch.ops.cuda.flash_attention import area_attention_plain, flash_area_attention

from .conv import CBAM, Conv, Dropout, DSConv, Linear


def _tokens(x):
    """(B, C, H, W) -> (B, H*W, C) view, row-major tokens."""
    return x.flatten(2).transpose(1, 2)


def _map(tokens, h: int, w: int):
    """(B, H*W, C) -> (B, C, H, W)."""
    return tokens.transpose(1, 2).reshape(tokens.shape[0], -1, h, w)


class Bottleneck(nn.Module):
    """Residual bottleneck: Conv(k1) -> Conv(k2), add if channels match."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 k: tuple = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP bottleneck with a 2-way split and a (2+n)-way concat."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.n = n
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c, c, shortcut, g, (3, 3), 1.0))
        self.cv2 = Conv((2 + n) * c, c2, 1)

    def forward(self, x):
        ys = list(self.cv1(x).split(self.c, 1))
        for i in range(self.n):
            ys.append(getattr(self, f"m{i}")(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class C3k2(nn.Module):
    """C2f whose inner blocks are C3k stacks (c3k=True) or plain Bottlenecks. The plain
    Bottleneck keeps its own e=0.5, unlike C2f's e=1.0."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5,
                 g: int = 1, shortcut: bool = True):
        super().__init__()
        self.c = c = int(c2 * e)
        self.n = n
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        for i in range(n):
            self.add_module(f"m{i}", C3k(c, c, 2, shortcut, g) if c3k
                            else Bottleneck(c, c, shortcut, g, (3, 3), 0.5))
        self.cv2 = Conv((2 + n) * c, c2, 1)

    def forward(self, x):
        ys = list(self.cv1(x).split(self.c, 1))
        for i in range(self.n):
            ys.append(getattr(self, f"m{i}")(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class C3k2_CBAM(C3k2):
    """C3k2 with CBAM on its output (the fork's block)."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5,
                 g: int = 1, shortcut: bool = True, kernel_size: int = 7):
        super().__init__(c1, c2, n, c3k, e, g, shortcut)
        self.cbam = CBAM(c2, kernel_size)

    def forward(self, x):
        return self.cbam(super().forward(x))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): three cumulative k x k max-pools."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(4 * c_, c2, 1, 1)

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(ys, 1))


class AAttn(nn.Module):
    """Area attention with a depthwise-conv position term.

    `use_flash`: None runs the CUDA kernel for CUDA tensors and the plain
    version for CPU tensors; True always calls the kernel's wrapper; False
    forces the plain version (the A/B reference).
    """

    def __init__(self, dim: int, num_heads: int, area: int = 1, use_flash: bool | None = None):
        super().__init__()
        self.num_heads, self.area, self.use_flash = num_heads, area, use_flash
        self.qk = Conv(dim, 2 * dim, 1, act=False)
        self.v = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 5, 1, 2, g=dim, act=False)
        self.proj = Conv(dim, dim, 1, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        qk = _tokens(self.qk(x))
        v = self.v(x)
        pe = self.pe(v)
        q, k = qk[..., :C], qk[..., C:]
        if self.use_flash is False:
            out = area_attention_plain(q, k, _tokens(v), self.num_heads, self.area)
        else:
            out = flash_area_attention(q, k, _tokens(v), self.num_heads, self.area)
        return self.proj(_map(out, H, W) + pe)


class ABlock(nn.Module):
    """Area-attention block: attention and MLP, both residual."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 1.2, area: int = 1):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.attn = AAttn(dim, num_heads, area)
        self.mlp1 = Conv(dim, hidden, 1)
        self.mlp2 = Conv(hidden, dim, 1, act=False)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp2(self.mlp1(x))


class C3k(nn.Module):
    """C3 with k x k bottlenecks (the A2C2f a2=False branch)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, k: int = 3):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = Conv(c1, c_, 1, 1)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c_, c_, shortcut, g, (k, k), 1.0))
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)

    def forward(self, x):
        a = self.cv1(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        return self.cv3(torch.cat([a, self.cv2(x)], 1))


class A2C2f(nn.Module):
    """R-ELAN area-attention CSP block, with the optional layer-scaled residual."""

    def __init__(self, c1: int, c2: int, n: int = 1, a2: bool = True, area: int = 1,
                 residual: bool = False, mlp_ratio: float = 2.0, e: float = 0.5, g: int = 1,
                 shortcut: bool = True):
        super().__init__()
        c_ = int(c2 * e)
        if c_ % 32:
            raise ValueError("A2C2f hidden dim must be a multiple of 32")
        num_heads = c_ // 32
        self.n, self.a2, self.residual = n, a2, a2 and residual
        self.cv1 = Conv(c1, c_, 1, 1)
        for i in range(n):
            if a2:
                self.add_module(f"m{i}_0", ABlock(c_, num_heads, mlp_ratio, area))
                self.add_module(f"m{i}_1", ABlock(c_, num_heads, mlp_ratio, area))
            else:
                self.add_module(f"m{i}", C3k(c_, c_, 2, shortcut, g))
        self.cv2 = Conv((1 + n) * c_, c2, 1)
        if self.residual:
            self.gamma = nn.Parameter(torch.full((c2,), 0.01))

    def forward(self, x):
        ys = [self.cv1(x)]
        for i in range(self.n):
            if self.a2:
                t = getattr(self, f"m{i}_0")(ys[-1])
                ys.append(getattr(self, f"m{i}_1")(t))
            else:
                ys.append(getattr(self, f"m{i}")(ys[-1]))
        out = self.cv2(torch.cat(ys, 1))
        if self.residual:
            return x + self.gamma.to(out.dtype).view(1, -1, 1, 1) * out
        return out


class YoloAttention(nn.Module):
    """Multi-head self-attention over all tokens with a conv qkv and a depthwise 3x3
    position term (key_dim = head_dim * attn_ratio). The qkv conv's channels are
    head-major, [q_h | k_h | v_h] for each head h, as the JAX module reshapes its NHWC
    output to (B, N, heads, 2 key_dim + head_dim). The softmax runs in float32."""

    def __init__(self, dim: int, num_heads: int = 8, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.hd = dim // num_heads
        self.kd = int(self.hd * attn_ratio)
        self.qkv = Conv(dim, dim + 2 * self.kd * num_heads, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)
        self.proj = Conv(dim, dim, 1, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        kd = self.kd
        t = self.qkv(x).view(B, self.num_heads, 2 * kd + self.hd, H * W)
        q, k, v = t[:, :, :kd], t[:, :, kd:2 * kd], t[:, :, 2 * kd:]
        attn = (q.transpose(-2, -1) @ k) * (kd ** -0.5)  # (B, heads, Nq, Nk)
        attn = attn.float().softmax(-1).to(v.dtype)
        out = (v @ attn.transpose(-2, -1)).reshape(B, C, H, W)
        return self.proj(out + self.pe(v.reshape(B, C, H, W)))


class PSABlock(nn.Module):
    """YoloAttention and a 2x feed-forward, each with a shortcut."""

    def __init__(self, c: int, attn_ratio: float = 0.5, num_heads: int = 4,
                 shortcut: bool = True):
        super().__init__()
        self.shortcut = shortcut
        self.attn = YoloAttention(c, num_heads, attn_ratio)
        self.ffn1 = Conv(c, 2 * c, 1)
        self.ffn2 = Conv(2 * c, c, 1, act=False)

    def forward(self, x):
        a = self.attn(x)
        x = x + a if self.shortcut else a
        f = self.ffn2(self.ffn1(x))
        return x + f if self.shortcut else f


class C2PSA(nn.Module):
    """n PSABlocks on one half of a CSP split (heads = c // 64)."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.n = n
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        for i in range(n):
            self.add_module(f"m{i}", PSABlock(c, 0.5, max(c // 64, 1)))
        self.cv2 = Conv(2 * c, c2, 1)

    def forward(self, x):
        a, b = self.cv1(x).split(self.c, 1)
        for i in range(self.n):
            b = getattr(self, f"m{i}")(b)
        return self.cv2(torch.cat([a, b], 1))


class DSBottleneck(nn.Module):
    """Depthwise-separable bottleneck: DSConv(k1) -> DSConv(k2, dilation d2)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5,
                 k1: int = 3, k2: int = 5, d2: int = 1):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = DSConv(c1, c_, k1, 1)
        self.cv2 = DSConv(c_, c2, k2, 1, d=d2)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class DSC3k(nn.Module):
    """C3 with DSBottleneck inner blocks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, k1: int = 3, k2: int = 5, d2: int = 1):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = Conv(c1, c_, 1, 1)
        for i in range(n):
            self.add_module(f"m{i}", DSBottleneck(c_, c_, shortcut, 1.0, k1, k2, d2))
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)

    def forward(self, x):
        a = self.cv1(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        return self.cv3(torch.cat([a, self.cv2(x)], 1))


class DSC3k2(nn.Module):
    """C2f whose inner blocks are DSC3k stacks (dsc3k=True) or DSBottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, dsc3k: bool = False, e: float = 0.5,
                 g: int = 1, shortcut: bool = True, k1: int = 3, k2: int = 7, d2: int = 1):
        super().__init__()
        self.c = c = int(c2 * e)
        self.n = n
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        for i in range(n):
            inner = (DSC3k(c, c, 2, shortcut, g, 1.0, k1, k2, d2) if dsc3k
                     else DSBottleneck(c, c, shortcut, 1.0, k1, k2, d2))
            self.add_module(f"m{i}", inner)
        self.cv2 = Conv((2 + n) * c, c2, 1)

    def forward(self, x):
        ys = list(self.cv1(x).split(self.c, 1))
        for i in range(self.n):
            ys.append(getattr(self, f"m{i}")(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class DSC3k2_CBAM(DSC3k2):
    """DSC3k2 with CBAM on its output (the fork's block)."""

    def __init__(self, c1: int, c2: int, n: int = 1, dsc3k: bool = False, e: float = 0.5,
                 g: int = 1, shortcut: bool = True, k1: int = 3, k2: int = 7, d2: int = 1,
                 kernel_size: int = 7):
        super().__init__(c1, c2, n, dsc3k, e, g, shortcut, k1, k2, d2)
        self.cbam = CBAM(c2, kernel_size)

    def forward(self, x):
        return self.cbam(super().forward(x))


class AdaHyperedgeGen(nn.Module):
    """Hyperedge participation matrix A (B, N, E), softmax over the vertex axis."""

    def __init__(self, node_dim: int, num_hyperedges: int, num_heads: int = 4,
                 dropout: float = 0.1, context: str = "both"):
        super().__init__()
        self.E, self.h, self.context = num_hyperedges, num_heads, context
        self.prototype_base = nn.Parameter(torch.empty(num_hyperedges, node_dim))
        nn.init.xavier_uniform_(self.prototype_base)
        ctx_dim = 2 * node_dim if context == "both" else node_dim
        self.context_net = Linear(ctx_dim, num_hyperedges * node_dim)
        self.pre_head_proj = Linear(node_dim, node_dim)
        self.dropout = Dropout(dropout)

    def forward(self, X):
        B, N, D = X.shape
        hd = D // self.h
        if self.context == "mean":
            ctx = X.mean(1)
        elif self.context == "max":
            ctx = X.amax(1)
        else:
            ctx = torch.cat([X.mean(1), X.amax(1)], -1)
        offsets = self.context_net(ctx).view(B, self.E, D)
        prototypes = self.prototype_base.to(offsets.dtype)[None] + offsets
        Xh = self.pre_head_proj(X).view(B, N, self.h, hd)
        Ph = prototypes.view(B, self.E, self.h, hd)
        # the JAX module divides by sqrt(hd) rounded to the data's dtype
        scale = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(Xh.dtype)
        logits = torch.einsum("bnhd,behd->bhne", Xh, Ph) / scale
        logits = self.dropout(logits.mean(1))  # (B, N, E): mean over heads
        return logits.float().softmax(1).to(X.dtype)


class AdaHGConv(nn.Module):
    """Hypergraph conv: vertex -> hyperedge -> vertex message passing, plus residual."""

    def __init__(self, embed_dim: int, num_hyperedges: int = 16, num_heads: int = 4,
                 dropout: float = 0.1, context: str = "both"):
        super().__init__()
        self.edge_generator = AdaHyperedgeGen(embed_dim, num_hyperedges, num_heads, dropout,
                                              context)
        self.edge_proj = Linear(embed_dim, embed_dim)
        self.node_proj = Linear(embed_dim, embed_dim)

    def forward(self, X):
        A = self.edge_generator(X)
        He = F.gelu(self.edge_proj(torch.einsum("bne,bnd->bed", A, X)))
        Xn = F.gelu(self.node_proj(torch.einsum("bne,bed->bnd", A, He)))
        return Xn + X


class AdaHGComputation(nn.Module):
    """AdaHGConv over the tokens of an NCHW map."""

    def __init__(self, embed_dim: int, num_hyperedges: int = 16, num_heads: int = 8,
                 dropout: float = 0.1, context: str = "both"):
        super().__init__()
        self.hgnn = AdaHGConv(embed_dim, num_hyperedges, num_heads, dropout, context)

    def forward(self, x):
        _, _, H, W = x.shape
        return _map(self.hgnn(_tokens(x)), H, W)


class C3AH(nn.Module):
    """CSP block with an adaptive-hypergraph branch."""

    def __init__(self, c1: int, c2: int, e: float = 1.0, num_hyperedges: int = 8,
                 context: str = "both"):
        super().__init__()
        c_ = int(c2 * e)
        if c_ % 16:
            raise ValueError("C3AH hidden dim must be a multiple of 16")
        self.cv1 = Conv(c1, c_, 1, 1)
        self.m = AdaHGComputation(c_, num_hyperedges, c_ // 16, 0.1, context)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


def _avgpool2(x):
    return F.avg_pool2d(x, 2, 2)


def _upsample2(x):
    return x.repeat_interleave(2, 2).repeat_interleave(2, 3)


class FuseModule(nn.Module):
    """Bring 3 (P3-P5) or 4 (P2-P5) scales to the next-to-last one's size and fuse by 1x1 conv."""

    def __init__(self, chs: tuple, c_out: int):
        super().__init__()
        self.conv_out = Conv(sum(chs), c_out, 1)

    def forward(self, xs):
        if len(xs) == 3:
            cat = [_avgpool2(xs[0]), xs[1], _upsample2(xs[2])]
        else:
            cat = [_avgpool2(_avgpool2(xs[0])), _avgpool2(xs[1]), xs[2], _upsample2(xs[3])]
        return self.conv_out(torch.cat(cat, 1))


class HyperACE(nn.Module):
    """Hypergraph-based adaptive correlation enhancement.

    `chs` are the input scales' channels; c1 is the fused width. Both C3AH
    branches read the middle split (ys[1]), as the JAX package does.
    """

    def __init__(self, chs: tuple, c1: int, c2: int, n: int = 1, num_hyperedges: int = 8,
                 dsc3k: bool = True, shortcut: bool = False, e1: float = 0.5, e2: float = 1.0,
                 context: str = "both", channel_adjust: bool = True):
        super().__init__()
        self.c = c = int(c2 * e1)
        self.n = n
        self.fuse = FuseModule(chs, c1)
        self.cv1 = Conv(c1, 3 * c, 1, 1)
        self.branch1 = C3AH(c, c, e2, num_hyperedges, context)
        self.branch2 = C3AH(c, c, e2, num_hyperedges, context)
        for i in range(n):
            self.add_module(f"m{i}", DSC3k(c, c, 2, shortcut, 1, 0.5, 3, 7) if dsc3k
                            else DSBottleneck(c, c, shortcut))
        self.cv2 = Conv((4 + n) * c, c2, 1)

    def forward(self, xs):
        ys = list(self.cv1(self.fuse(xs)).split(self.c, 1))
        out1 = self.branch1(ys[1])
        out2 = self.branch2(ys[1])
        for i in range(self.n):
            ys.append(getattr(self, f"m{i}")(ys[-1]))
        ys[1] = out1
        ys.append(out2)
        return self.cv2(torch.cat(ys, 1))


class DownsampleConv(nn.Module):
    """2x average-pool downsample, then (channel_adjust) a 1x1 Conv to 2*c1 channels."""

    def __init__(self, c1: int, channel_adjust: bool = True):
        super().__init__()
        if channel_adjust:
            self.channel_adjust = Conv(c1, 2 * c1, 1)
        else:
            self.channel_adjust = None

    def forward(self, x):
        x = _avgpool2(x)
        return self.channel_adjust(x) if self.channel_adjust is not None else x


class FullPAD_Tunnel(nn.Module):
    """Gated residual fusion x0 + gate * x1, with a scalar gate that starts at 0."""

    def __init__(self):
        super().__init__()
        self.gate = nn.Parameter(torch.zeros(()))

    def forward(self, xs):
        return xs[0] + self.gate.to(xs[0].dtype) * xs[1]
