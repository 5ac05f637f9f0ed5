"""YOLO blocks of the yolov3-v13 detect graphs (v10's CIB and PSA, v9's GELAN and CBLinear /
CBFuse, v5's C3, v8's ghost and C2 blocks), the fork's CBAM variants and the PPHGNetV2 and
ResNet backbone blocks, in NCHW (port of `sar_yolo_tpu/nn/modules/block.py`).

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

from sar_yolo_tpu_torch.ops.boxes import as_dtype
from sar_yolo_tpu_torch.ops.cuda.flash_attention import area_attention_plain, flash_area_attention

from .conv import CBAM, Conv, Conv2d, Dropout, DSConv, DWConv, GhostConv, LightConv, Linear, RepConv
from .transformer import LayerNorm, _sqrt_in


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


class _CSP2f(nn.Module):
    """The C2f pattern: cv1 to 2c channels split in two halves, the inner blocks `m{i}`
    chained on the second, all 2 + n maps concatenated into cv2."""

    def __init__(self, c1: int, c2: int, c: int, inner: list):
        super().__init__()
        self.c, self.n = c, len(inner)
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        for i, m in enumerate(inner):
            self.add_module(f"m{i}", m)
        self.cv2 = Conv((2 + self.n) * c, c2, 1)

    def forward(self, x):
        ys = list(self.cv1(x).split(self.c, 1))
        for i in range(self.n):
            ys.append(getattr(self, f"m{i}")(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class C2f(_CSP2f):
    """CSP bottleneck with a 2-way split and a (2+n)-way concat."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1,
                 e: float = 0.5):
        c = int(c2 * e)
        super().__init__(c1, c2, c, [Bottleneck(c, c, shortcut, g, (3, 3), 1.0)
                                     for _ in range(n)])


class C3k2(_CSP2f):
    """C2f whose inner blocks are C3k stacks (c3k=True) or plain Bottlenecks. The plain
    Bottleneck keeps its own e=0.5, unlike C2f's e=1.0."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5,
                 g: int = 1, shortcut: bool = True):
        c = int(c2 * e)
        super().__init__(c1, c2, c, [C3k(c, c, 2, shortcut, g) if c3k
                                     else Bottleneck(c, c, shortcut, g, (3, 3), 0.5)
                                     for _ in range(n)])


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


class _CSP3(nn.Module):
    """The C3 pattern: cv1 to c_ channels -> the inner blocks `m{i}`, beside cv2, concatenated
    into cv3."""

    def __init__(self, c1: int, c2: int, c_: int, inner: list):
        super().__init__()
        self.n = len(inner)
        self.cv1 = Conv(c1, c_, 1, 1)
        for i, m in enumerate(inner):
            self.add_module(f"m{i}", m)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)

    def forward(self, x):
        a = self.cv1(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        return self.cv3(torch.cat([a, self.cv2(x)], 1))


class C3k(_CSP3):
    """C3 with k x k bottlenecks (the A2C2f a2=False branch)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, k: int = 3):
        c_ = int(c2 * e)
        super().__init__(c1, c2, c_, [Bottleneck(c_, c_, shortcut, g, (k, k), 1.0)
                                      for _ in range(n)])


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


class DSC3k(_CSP3):
    """C3 with DSBottleneck inner blocks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, k1: int = 3, k2: int = 5, d2: int = 1):
        c_ = int(c2 * e)
        super().__init__(c1, c2, c_, [DSBottleneck(c_, c_, shortcut, 1.0, k1, k2, d2)
                                      for _ in range(n)])


class DSC3k2(_CSP2f):
    """C2f whose inner blocks are DSC3k stacks (dsc3k=True) or DSBottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, dsc3k: bool = False, e: float = 0.5,
                 g: int = 1, shortcut: bool = True, k1: int = 3, k2: int = 7, d2: int = 1):
        c = int(c2 * e)
        super().__init__(c1, c2, c, [DSC3k(c, c, 2, shortcut, g, 1.0, k1, k2, d2) if dsc3k
                                     else DSBottleneck(c, c, shortcut, 1.0, k1, k2, d2)
                                     for _ in range(n)])


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
        prototypes = as_dtype(self.prototype_base, offsets.dtype)[None] + offsets
        Xh = self.pre_head_proj(X).view(B, N, self.h, hd)
        Ph = prototypes.view(B, self.E, self.h, hd)
        # the JAX module divides by sqrt(hd) rounded to the data's dtype
        scale = as_dtype(torch.tensor(math.sqrt(hd), dtype=torch.float32), Xh.dtype)
        logits = torch.einsum("bnhd,behd->bhne", Xh, Ph) / scale
        logits = self.dropout(logits.mean(1))  # (B, N, E): mean over heads
        return as_dtype(as_dtype(logits, torch.float32).softmax(1), X.dtype)


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
        return xs[0] + as_dtype(self.gate, xs[0].dtype) * xs[1]


def _pool(x, k: int, s: int = 1):
    """k x k max-pool with 'same' padding k // 2 (padding with -inf)."""
    return F.max_pool2d(x, k, s, k // 2)


class C2(nn.Module):
    """CSP bottleneck with 2 convs: n Bottlenecks in sequence on one half of the split."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.n = n
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c, c, shortcut, g, (3, 3), 1.0))
        self.cv2 = Conv(2 * c, c2, 1)

    def forward(self, x):
        a, b = self.cv1(x).split(self.c, 1)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        return self.cv2(torch.cat([a, b], 1))


class C3(_CSP3):
    """CSP bottleneck with 3 convs; the Bottlenecks' kernels are (k[0][0], k[1][0])."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, k: tuple = ((1, 1), (3, 3))):
        c_ = int(c2 * e)
        super().__init__(c1, c2, c_, [Bottleneck(c_, c_, shortcut, g, (k[0][0], k[1][0]), 1.0)
                                      for _ in range(n)])


class GhostBottleneck(nn.Module):
    """Ghost bottleneck: GhostConv -> (depthwise stride-2 Conv) -> linear GhostConv, plus the
    input, or on stride 2 a depthwise + pointwise shortcut of it."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.conv_0 = GhostConv(c1, c_, 1, 1)
        self.conv_1 = DWConv(c_, c_, k, s, act=False) if s == 2 else None
        self.conv_2 = GhostConv(c_, c2, 1, 1, act=False)
        if s == 2:
            self.shortcut_0 = DWConv(c1, c1, k, s, act=False)
            self.shortcut_1 = Conv(c1, c2, 1, 1, act=False)
        self.s = s

    def forward(self, x):
        y = self.conv_0(x)
        if self.conv_1 is not None:
            y = self.conv_1(y)
        y = self.conv_2(y)
        return y + (self.shortcut_1(self.shortcut_0(x)) if self.s == 2 else x)


class C3Ghost(_CSP3):
    """C3 with GhostBottleneck inner blocks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        c_ = int(c2 * e)
        super().__init__(c1, c2, c_, [GhostBottleneck(c_, c_) for _ in range(n)])


class RepBottleneck(nn.Module):
    """Bottleneck whose first conv is a RepConv."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k: tuple = (3, 3),
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = RepConv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class RepCSP(_CSP3):
    """C3 with RepBottleneck inner blocks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        c_ = int(c2 * e)
        super().__init__(c1, c2, c_, [RepBottleneck(c_, c_, shortcut, g, (3, 3), 1.0)
                                      for _ in range(n)])


class RepNCSPELAN4(nn.Module):
    """CSP-ELAN: a 1x1 split, two RepCSP + 3x3 Conv stages on the second half, and a 1x1
    fuse of the 4-way concat."""

    def __init__(self, c1: int, c2: int, c3: int = 64, c4: int = 32, n: int = 1):
        super().__init__()
        self.c = c3 // 2
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv2_0 = RepCSP(c3 - self.c, c4, n)
        self.cv2_1 = Conv(c4, c4, 3, 1)
        self.cv3_0 = RepCSP(c4, c4, n)
        self.cv3_1 = Conv(c4, c4, 3, 1)
        self.cv4 = Conv(c3 + 2 * c4, c2, 1, 1)

    def forward(self, x):
        y = self.cv1(x)
        ys = [y[:, :self.c], y[:, self.c:]]
        ys.append(self.cv2_1(self.cv2_0(ys[-1])))
        ys.append(self.cv3_1(self.cv3_0(ys[-1])))
        return self.cv4(torch.cat(ys, 1))


class ELAN1(nn.Module):
    """Light ELAN: RepNCSPELAN4 with plain 3x3 Convs in place of the RepCSP stages."""

    def __init__(self, c1: int, c2: int, c3: int = 32, c4: int = 16):
        super().__init__()
        self.c = c3 // 2
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv2 = Conv(c3 - self.c, c4, 3, 1)
        self.cv3 = Conv(c4, c4, 3, 1)
        self.cv4 = Conv(c3 + 2 * c4, c2, 1, 1)

    def forward(self, x):
        y = self.cv1(x)
        ys = [y[:, :self.c], y[:, self.c:]]
        ys.append(self.cv2(ys[-1]))
        ys.append(self.cv3(ys[-1]))
        return self.cv4(torch.cat(ys, 1))


class AConv(nn.Module):
    """2x2 stride-1 average pool (no padding), then a 3x3 stride-2 Conv."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.cv1 = Conv(c1, c2, 3, 2, 1)

    def forward(self, x):
        return self.cv1(F.avg_pool2d(x, 2, 1, 0))


class ADown(nn.Module):
    """2x2 stride-1 average pool, then a 3x3 stride-2 Conv on the first channel half and a
    3x3 stride-2 max-pool + 1x1 Conv on the second, concatenated."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.half = c1 // 2
        self.cv1 = Conv(self.half, c2 // 2, 3, 2, 1)
        self.cv2 = Conv(c1 - self.half, c2 // 2, 1, 1, 0)

    def forward(self, x):
        x = F.avg_pool2d(x, 2, 1, 0)
        x1, x2 = x[:, :self.half], x[:, self.half:]
        return torch.cat([self.cv1(x1), self.cv2(F.max_pool2d(x2, 3, 2, 1))], 1)


class SPPELAN(nn.Module):
    """SPP-ELAN: a 1x1 Conv, three cumulative k x k max-pools, a 1x1 fuse."""

    def __init__(self, c1: int, c2: int, c3: int = 64, k: int = 5):
        super().__init__()
        self.k = k
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv5 = Conv(4 * c3, c2, 1, 1)

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(_pool(ys[-1], self.k))
        return self.cv5(torch.cat(ys, 1))


class CBLinear(nn.Module):
    """One biased conv whose output channels split into a tuple of chunks of sizes c2s."""

    def __init__(self, c1: int, c2s, k: int = 1, s: int = 1, g: int = 1):
        super().__init__()
        self.c2s = tuple(c2s)
        self.conv = Conv2d(c1, sum(self.c2s), k, s, k // 2, groups=g, bias=True)

    def forward(self, x):
        return tuple(self.conv(x).split(self.c2s, 1))


def resize_nearest(x, h: int, w: int):
    """Nearest resize of an NCHW map with `jax.image.resize(..., "nearest")`'s sampling: output
    index i reads floor((i + 0.5) * n_in / n_out), computed in float32 (half-pixel centres,
    which `F.interpolate(mode="nearest")` does not use)."""
    for dim, n in ((2, h), (3, w)):
        m = x.shape[dim]
        if m != n:
            src = ((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * m / n)
            x = x.index_select(dim, src.floor().long())
    return x


class CBFuse(nn.Module):
    """The sum of the last input and chunk idx[i] of each CBLinear output before it, each
    resized (`resize_nearest`) to the last input's grid."""

    def __init__(self, idx):
        super().__init__()
        self.idx = tuple(idx)

    def forward(self, xs):
        target = xs[-1]
        h, w = target.shape[2:]
        acc = target
        for i, x in enumerate(xs[:-1]):
            acc = acc + resize_nearest(x[self.idx[i]], h, w)
        return acc


class SPP(nn.Module):
    """Spatial pyramid pooling: a 1x1 Conv, parallel k x k max-pools, a 1x1 fuse."""

    def __init__(self, c1: int, c2: int, k: tuple = (5, 9, 13)):
        super().__init__()
        self.k = tuple(k)
        self.cv1 = Conv(c1, c1 // 2, 1, 1)
        self.cv2 = Conv(c1 // 2 * (len(self.k) + 1), c2, 1, 1)

    def forward(self, x):
        y = self.cv1(x)
        return self.cv2(torch.cat([y] + [_pool(y, k) for k in self.k], 1))


class SCDown(nn.Module):
    """Separable downsample: a 1x1 Conv, then a depthwise k x k stride-s Conv (no
    activation)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 2):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c2, c2, k, s, g=c2, act=False)

    def forward(self, x):
        return self.cv2(self.cv1(x))


class RepVGGDW(nn.Module):
    """Depthwise 7x7 and 3x3 Convs (no activation) in parallel, summed, then SiLU. `nn/fuse.py`
    folds both into one biased depthwise 7x7 `conv` (a Conv2d) and drops conv1."""

    def __init__(self, ed: int):
        super().__init__()
        self.conv = Conv(ed, ed, 7, 1, 3, g=ed, act=False)
        self.conv1 = Conv(ed, ed, 3, 1, 1, g=ed, act=False)

    def forward(self, x):
        if self.conv1 is None:
            return F.silu(self.conv(x))
        return F.silu(self.conv(x) + self.conv1(x))


class CIB(nn.Module):
    """Compact inverted block: depthwise 3x3, pointwise expand, a large-kernel RepVGGDW (lk)
    or a depthwise 3x3, pointwise, depthwise 3x3; residual when channels match."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5,
                 lk: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1_0 = Conv(c1, c1, 3, g=c1)
        self.cv1_1 = Conv(c1, 2 * c_, 1)
        self.cv1_2 = RepVGGDW(2 * c_) if lk else Conv(2 * c_, 2 * c_, 3, g=2 * c_)
        self.cv1_3 = Conv(2 * c_, c2, 1)
        self.cv1_4 = Conv(c2, c2, 3, g=c2)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv1_4(self.cv1_3(self.cv1_2(self.cv1_1(self.cv1_0(x)))))
        return x + y if self.add else y


class C2fCIB(_CSP2f):
    """C2f with CIB inner blocks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, lk: bool = False,
                 g: int = 1, e: float = 0.5):
        c = int(c2 * e)
        super().__init__(c1, c2, c, [CIB(c, c, shortcut, 1.0, lk) for _ in range(n)])


class PSA(nn.Module):
    """Position-sensitive attention: one PSABlock (heads = c // 64) on one half of a CSP
    split."""

    def __init__(self, c1: int, c2: int, e: float = 0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        self.m = PSABlock(c, 0.5, max(c // 64, 1))
        self.cv2 = Conv(2 * c, c2, 1)

    def forward(self, x):
        a, b = self.cv1(x).split(self.c, 1)
        return self.cv2(torch.cat([a, self.m(b)], 1))


class HGStem(nn.Module):
    """PPHGNetV2 stem (ReLU Convs): 3x3/2, then a 2x2 conv pair beside a 2x2 stride-1 max-pool
    of the bottom/right-padded map, concatenated, 3x3/2 and 1x1."""

    def __init__(self, c1: int, cm: int, c2: int):
        super().__init__()
        self.stem1 = Conv(c1, cm, 3, 2, act=nn.ReLU())
        self.stem2a = Conv(cm, cm // 2, 2, 1, p=0, act=nn.ReLU())
        self.stem2b = Conv(cm // 2, cm, 2, 1, p=0, act=nn.ReLU())
        self.stem3 = Conv(2 * cm, cm, 3, 2, act=nn.ReLU())
        self.stem4 = Conv(cm, c2, 1, 1, act=nn.ReLU())

    def forward(self, x):
        xp = F.pad(self.stem1(x), (0, 1, 0, 1))
        x2 = self.stem2b(F.pad(self.stem2a(xp), (0, 1, 0, 1)))
        x1 = F.max_pool2d(xp, 2, 1)
        return self.stem4(self.stem3(torch.cat([x1, x2], 1)))


class HGBlock(nn.Module):
    """PPHGNetV2 block: n (Light)Convs in a chain, their dense concat with the input
    squeezed to c2 / 2 and excited to c2 (ReLU throughout)."""

    def __init__(self, c1: int, cm: int, c2: int, k: int = 3, n: int = 6,
                 lightconv: bool = False, shortcut: bool = False):
        super().__init__()
        self.n = n
        for i in range(n):
            ci = c1 if i == 0 else cm
            self.add_module(f"m{i}", LightConv(ci, cm, k) if lightconv
                            else Conv(ci, cm, k, act=nn.ReLU()))
        self.sc = Conv(c1 + n * cm, c2 // 2, 1, 1, act=nn.ReLU())
        self.ec = Conv(c2 // 2, c2, 1, 1, act=nn.ReLU())
        self.add = shortcut and c1 == c2

    def forward(self, x):
        ys = [x]
        for i in range(self.n):
            ys.append(getattr(self, f"m{i}")(ys[-1]))
        y = self.ec(self.sc(torch.cat(ys, 1)))
        return y + x if self.add else y


class RepC3(nn.Module):
    """CSP block with a RepConv chain: cv1 -> n RepConvs, plus cv2, then cv3 when c_ != c2."""

    def __init__(self, c1: int, c2: int, n: int = 3, e: float = 1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = Conv(c1, c_, 1, 1)
        for i in range(n):
            self.add_module(f"m{i}", RepConv(c_, c_))
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(c_, c2, 1) if c_ != c2 else None

    def forward(self, x):
        a = self.cv1(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        y = a + self.cv2(x)
        return self.cv3(y) if self.cv3 is not None else y


class ResNetBlock(nn.Module):
    """ResNet block: 1x1, 3x3/s, 1x1 to e * c2 (no activation on the last), or for e = 1 the
    two-3x3 basic block; ReLU of its sum with the input or a 1x1/s projection of it."""

    def __init__(self, c1: int, c2: int, s: int = 1, e: int = 4):
        super().__init__()
        c3 = e * c2
        if e == 1:
            self.cv1 = Conv(c1, c2, 3, s, p=1)
            self.cv2 = Conv(c2, c3, 3, 1, p=1, act=False)
            self.cv3 = None
        else:
            self.cv1 = Conv(c1, c2, 1, 1)
            self.cv2 = Conv(c2, c2, 3, s, p=1)
            self.cv3 = Conv(c2, c3, 1, act=False)
        self.shortcut_0 = Conv(c1, c3, 1, s, act=False) if s != 1 or c1 != c3 else None

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        if self.cv3 is not None:
            y = self.cv3(y)
        return F.relu(y + (self.shortcut_0(x) if self.shortcut_0 is not None else x))


class ResNetLayer(nn.Module):
    """ResNet stage: a 7x7/2 Conv and a 3x3/2 max-pool when is_first, else n ResNetBlocks (the
    first with stride s). c1 is the input's channels (the YAML's own c1 is not read)."""

    def __init__(self, c1: int, c2: int, s: int = 1, is_first: bool = False, n: int = 1,
                 e: int = 4):
        super().__init__()
        self.is_first, self.n = is_first, n
        if is_first:
            self.layer_0 = Conv(c1, c2, 7, 2, p=3)
        else:
            for j in range(n):
                self.add_module(f"layer_{j}", ResNetBlock(c1 if j == 0 else e * c2, c2,
                                                          s if j == 0 else 1, e))

    def forward(self, x):
        if self.is_first:
            return F.max_pool2d(self.layer_0(x), 3, 2, 1)
        for j in range(self.n):
            x = getattr(self, f"layer_{j}")(x)
        return x


class MaxSigmoidAttnBlock(nn.Module):
    """Text-guided max-sigmoid attention (YOLO-World): per head, the image embedding's
    similarity to each guide (text) row, the max over rows over sqrt(head width), plus a
    per-head bias, sigmoided, gates proj_conv(x) head by head."""

    def __init__(self, c1: int, c2: int, nh: int = 1, ec: int = 128, gc: int = 512,
                 scale: bool = False):
        super().__init__()
        self.nh, self.ec_dim = nh, ec
        self.gl = Linear(gc, ec)
        self.ec = Conv(c1, ec, 1, act=False) if c1 != ec else None
        self.bias = nn.Parameter(torch.zeros(nh))
        self.scale = nn.Parameter(torch.ones(1, nh, 1, 1)) if scale else None
        self.proj_conv = Conv(c1, c2, 3, act=False)

    def forward(self, x, guide):
        B, _, H, W = x.shape
        hc = self.ec_dim // self.nh
        g = self.gl(guide).reshape(B, -1, self.nh, hc)
        embed = self.ec(x) if self.ec is not None else x
        e = embed.reshape(B, self.nh, hc, H, W)
        aw = torch.einsum("bmchw,bnmc->bmhwn", e, g).amax(-1)
        aw = aw / _sqrt_in(hc, aw.dtype).to(aw.device)
        aw = torch.sigmoid(aw + self.bias[None, :, None, None].to(aw.dtype))
        if self.scale is not None:
            aw = aw * self.scale.to(aw.dtype)
        y = self.proj_conv(x)
        return (y.reshape(B, self.nh, -1, H, W) * aw[:, :, None]).reshape(B, -1, H, W)


class C2fAttn(_CSP2f):
    """C2f with a MaxSigmoidAttnBlock (`attn`) on the last inner map, its output the (3 + n)th
    map into cv2; forward(x, guide)."""

    def __init__(self, c1: int, c2: int, n: int = 1, ec: int = 128, nh: int = 1,
                 gc: int = 512, shortcut: bool = False, g: int = 1, e: float = 0.5):
        c = int(c2 * e)
        super().__init__(c1, c2, c, [Bottleneck(c, c, shortcut, g, (3, 3), 1.0)
                                     for _ in range(n)])
        self.cv2 = Conv((3 + n) * c, c2, 1)
        self.attn = MaxSigmoidAttnBlock(c, c, nh, ec, gc)

    def forward(self, x, guide):
        ys = list(self.cv1(x).split(self.c, 1))
        for i in range(self.n):
            ys.append(getattr(self, f"m{i}")(ys[-1]))
        ys.append(self.attn(ys[-1], guide))
        return self.cv2(torch.cat(ys, 1))


class ImagePoolingAttn(nn.Module):
    """YOLO-World's image-conditioned text update: each level's 1x1 projection (with bias)
    max-pooled to k x k cells (AdaptiveMaxPool2d's bounds), the text rows attending over
    those cells (LayerNorm then Linear for q, k, v; float32 softmax), projected to ct, plus
    the text. forward(xs, text) returns the new text (B, n, ct)."""

    def __init__(self, ec: int = 256, ch: tuple = (), ct: int = 512, nh: int = 8, k: int = 3,
                 scale: bool = False):
        super().__init__()
        self.ec, self.nh, self.k = ec, nh, k
        for i, c in enumerate(ch):
            self.add_module(f"projections_{i}", Conv2d(c, ec, 1, bias=True))
        self.nf = len(ch)
        self.query_ln, self.key_ln, self.value_ln = LayerNorm(ct), LayerNorm(ec), LayerNorm(ec)
        self.query_fc, self.key_fc, self.value_fc = Linear(ct, ec), Linear(ec, ec), Linear(ec, ec)
        self.proj = Linear(ec, ct)
        self.scale = nn.Parameter(torch.zeros(1)) if scale else None

    def forward(self, xs, text):
        B = xs[0].shape[0]
        hc = self.ec // self.nh
        img = torch.cat([F.adaptive_max_pool2d(getattr(self, f"projections_{i}")(x), self.k)
                         .flatten(2).transpose(1, 2) for i, x in enumerate(xs)], 1)
        q = self.query_fc(self.query_ln(text)).reshape(B, -1, self.nh, hc)
        kk = self.key_fc(self.key_ln(img)).reshape(B, -1, self.nh, hc)
        v = self.value_fc(self.value_ln(img)).reshape(B, -1, self.nh, hc)
        aw = torch.einsum("bnmc,bkmc->bmnk", q, kk) / _sqrt_in(hc, q.dtype).to(q.device)
        aw = aw.float().softmax(-1).to(v.dtype)
        o = self.proj(torch.einsum("bmnk,bkmc->bnmc", aw, v).reshape(B, -1, self.ec))
        if self.scale is not None:
            o = o * self.scale.to(o.dtype)
        return o + text
