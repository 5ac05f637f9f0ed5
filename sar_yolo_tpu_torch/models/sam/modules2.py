"""SAM2 modules (port of `sar_yolo_tpu/models/sam/modules2.py`): the Hiera trunk, the FPN
neck, the SAM2 mask decoder with its high-resolution skips and object score, and the video
memory: the memory encoder and the memory attention over a fixed-slot bank.

Submodules carry the Flax scope names of the JAX package (`trunk.block_3.attn.qkv`,
`neck.conv_0`, `memory_attention.layer_2.cross_attn_image.k_proj`, ...), so
`utils/convert.py::from_jax_variables` maps JAX's variables onto them mechanically.

Layout: image maps are NCHW at every module boundary: Hiera's four stage outputs, the neck's
levels, `encode`'s embeddings and high-resolution maps, the decoder's inputs and the memory
encoder's convolutions. Inside Hiera the blocks work on (B, H, W, C) grids, as JAX's do. A
memory is a token grid, (B, h, w, mem_dim) as in JAX, and the bank of Q objects is (Q, T, h,
w, mem_dim) with a (Q, T) validity mask.

The attention is plain torch ops (matmul, softmax in at least float32), as the JAX package
computes it with einsums outside any Pallas kernel. GELU is the tanh approximation wherever
the JAX package calls Flax's `nn.gelu` (Hiera's MLP, the decoder's upscaling, the mask
downsampler, the ConvNeXt blocks); Meta's SAM2 uses the exact form there.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from sar_yolo_tpu_torch.models.sam.modules import (MLP, PIXEL_MEAN, PIXEL_STD, LayerNorm2d,
                                                   PromptEncoder, TwoWayTransformer, softmax,
                                                   window_partition, window_unpartition)
from sar_yolo_tpu_torch.ops.masks import resize_linear

LOGITS_BUDGET = 8 << 30  # bytes of cross-attention logits per chunk of objects


def gelu(x):
    """Flax's default `nn.gelu`: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _interp_matrix_torch_bicubic(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 1-D interpolation matrix of torch's bicubic `F.interpolate`
    (A = -0.75, align_corners=False, borders replicated), built in numpy as the JAX package
    builds it."""
    A = -0.75

    def k(x):
        x = abs(x)
        if x <= 1:
            return (A + 2) * x ** 3 - (A + 3) * x ** 2 + 1
        if x < 2:
            return A * x ** 3 - 5 * A * x ** 2 + 8 * A * x - 4 * A
        return 0.0

    M = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    for o in range(n_out):
        src = (o + 0.5) * scale - 0.5
        i0 = math.floor(src)
        t = src - i0
        for d in (-1, 0, 1, 2):
            M[o, min(max(i0 + d, 0), n_in - 1)] += k(d - t)
    return M


def resize_bicubic_torch(x, size):
    """NHWC resize with torch-bicubic semantics as two dense products (Hiera's background
    position table)."""
    H, W = size
    if tuple(x.shape[1:3]) == (H, W):
        return x
    Mh, Mw = (torch.as_tensor(_interp_matrix_torch_bicubic(n, m), dtype=x.dtype,
                              device=x.device) for n, m in ((x.shape[1], H), (x.shape[2], W)))
    return torch.einsum("oh,bhwc,pw->bopc", Mh, x, Mw)


def max_pool2x2(x):
    """2x2 stride-2 max pool of a (B, H, W, C) grid, odd edges dropped (Flax's VALID)."""
    B, H, W, C = x.shape
    x = x[:, :H // 2 * 2, :W // 2 * 2]
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax((2, 4))


class MultiScaleAttention(nn.Module):
    """Attention over a (B, H, W, C) grid; with `q_pool` the queries are max-pooled 2x2 (inside
    each window, when the caller passes windows) before the product."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, q_pool: bool = False):
        super().__init__()
        self.dim_out, self.num_heads, self.q_pool = dim_out, num_heads, q_pool
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)

    def forward(self, x):
        B, H, W, _ = x.shape
        nh, hd = self.num_heads, self.dim_out // self.num_heads
        q, k, v = self.qkv(x).reshape(B, H * W, 3, nh, hd).unbind(2)
        if self.q_pool:
            q = max_pool2x2(q.reshape(B, H, W, nh * hd))
            H, W = q.shape[1:3]
            q = q.reshape(B, H * W, nh, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        out = torch.einsum("bhqk,bkhd->bqhd", softmax(attn), v).reshape(B, H, W, self.dim_out)
        return self.proj(out)


class MultiScaleBlock(nn.Module):
    """Hiera block: windowed (or global, `window_size` 0) attention, with the stage change's
    channel projection and 2x query pooling."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, mlp_ratio: float = 4.0,
                 q_pool: bool = False, window_size: int = 0):
        super().__init__()
        self.dim, self.dim_out, self.q_pool, self.window_size = dim, dim_out, q_pool, window_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, q_pool=q_pool)
        self.norm2 = nn.LayerNorm(dim_out, eps=1e-6)
        self.mlp_lin1 = nn.Linear(dim_out, int(dim_out * mlp_ratio))
        self.mlp_lin2 = nn.Linear(int(dim_out * mlp_ratio), dim_out)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.dim != self.dim_out:
            shortcut = self.proj(x)
        if self.q_pool:
            shortcut = max_pool2x2(shortcut)
        H, W = x.shape[1:3]
        ws = self.window_size
        if ws > 0:
            x, pad_hw = window_partition(x, ws)
        x = self.attn(x)
        if self.q_pool:  # the windows and the map halve: the padding is worked out again
            ws = self.window_size // 2 if ws > 0 else 0
            H, W = H // 2, W // 2
            pad_hw = (H + (ws - H % ws) % ws, W + (ws - W % ws) % ws) if ws else None
        if self.window_size > 0:
            x = window_unpartition(x, ws, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp_lin2(gelu(self.mlp_lin1(self.norm2(x))))


class Hiera(nn.Module):
    """Hierarchical ViT trunk: a 7x7 stride-4 patch conv, the bicubic-resized background
    position table plus the tiled window table, then the blocks; the stage changes at the
    stage ends (channels and heads double, the first block of a stage pools its queries and
    keeps the previous stage's window). (B, 3, S, S) -> the four stage outputs, NCHW, at
    strides 4, 8, 16 and 32."""

    def __init__(self, embed_dim: int = 96, num_heads: int = 1, stages=(2, 3, 16, 3),
                 window_spec=(8, 4, 14, 7), global_att_blocks=(12, 16, 20),
                 window_pos_bkg=(14, 14)):
        super().__init__()
        self.patch_embed = nn.Conv2d(3, embed_dim, 7, 4, 3)
        self.pos_embed = nn.Parameter(torch.zeros(1, *window_pos_bkg, embed_dim))
        self.pos_embed_window = nn.Parameter(
            torch.zeros(1, window_spec[0], window_spec[0], embed_dim))
        self.stage_ends = [sum(stages[:i]) - 1 for i in range(1, len(stages) + 1)]
        q_pool_blocks = [e + 1 for e in self.stage_ends[:-1]]
        self.depth = sum(stages)
        dim, heads, cur_stage = embed_dim, num_heads, 1
        for i in range(self.depth):
            window = 0 if i in global_att_blocks else window_spec[cur_stage - 1]
            dim_out = dim
            if i - 1 in self.stage_ends:
                dim_out, heads, cur_stage = dim * 2, heads * 2, cur_stage + 1
            self.add_module(f"block_{i}", MultiScaleBlock(dim, dim_out, heads,
                                                          q_pool=i in q_pool_blocks,
                                                          window_size=window))
            dim = dim_out

    def forward(self, x):
        x = self.patch_embed(x).permute(0, 2, 3, 1)                      # (B, H, W, C)
        H, W = x.shape[1:3]
        pos = resize_bicubic_torch(self.pos_embed, (H, W))
        win = self.pos_embed_window
        pos = pos + win.repeat(1, H // win.shape[1], W // win.shape[2], 1)
        x = x + pos.to(x.dtype)
        outs = []
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
            if i in self.stage_ends:
                outs.append(x.permute(0, 3, 1, 2))
        return outs


def sine_pos_encoding(h: int, w: int, dim: int = 256, temperature: int = 10000,
                      dtype=torch.float32, device=None):
    """2-D sine position encoding, (h, w, dim): the y half, then the x half, each interleaving
    sin and cos."""
    kw = dict(dtype=dtype, device=device)
    ys = torch.arange(1, h + 1, **kw)[:, None].expand(h, w)
    xs = torch.arange(1, w + 1, **kw)[None, :].expand(h, w)
    eps = 1e-6
    ys = ys / (ys[-1:, :] + eps) * 2 * math.pi
    xs = xs / (xs[:, -1:] + eps) * 2 * math.pi
    t = temperature ** (2 * (torch.arange(dim // 2, device=device) // 2) / (dim // 2)).to(dtype)
    px, py = xs[..., None] / t, ys[..., None] / t
    px = torch.stack([torch.sin(px[..., 0::2]), torch.cos(px[..., 1::2])], -1).reshape(h, w, -1)
    py = torch.stack([torch.sin(py[..., 0::2]), torch.cos(py[..., 1::2])], -1).reshape(h, w, -1)
    return torch.cat([py, px], -1)


class FpnNeck(nn.Module):
    """1x1 lateral convs to d_model over Hiera's outputs; the top-down sum (a nearest 2x
    upsample, a plain repeat) only at the levels of `fpn_top_down_levels`."""

    def __init__(self, d_model: int = 256, backbone_channel_list=(768, 384, 192, 96),
                 fpn_top_down_levels=(2, 3)):
        super().__init__()
        self.d_model, self.fpn_top_down_levels = d_model, tuple(fpn_top_down_levels)
        for j, ch in enumerate(backbone_channel_list):  # conv_0: the lowest resolution
            self.add_module(f"conv_{j}", nn.Conv2d(ch, d_model, 1))

    def forward(self, xs):
        """xs: NCHW maps from stride 4 to 32 -> (feats, pos) in the same order, pos (1, d, h,
        w)."""
        n = len(xs) - 1
        out, pos = [None] * len(xs), [None] * len(xs)
        prev = None
        for i in range(n, -1, -1):
            lat = getattr(self, f"conv_{n - i}")(xs[i])
            if i in self.fpn_top_down_levels and prev is not None:
                prev = lat + prev.repeat_interleave(2, 2).repeat_interleave(2, 3).to(lat.dtype)
            else:
                prev = lat
            out[i] = prev
            pos[i] = sine_pos_encoding(*prev.shape[2:], self.d_model, dtype=prev.dtype,
                                       device=prev.device).permute(2, 0, 1)[None]
        return out, pos


class SAM2MaskDecoder(nn.Module):
    """Mask decoder with an object-score token and high-resolution skips. Tokens: obj, iou,
    then the 4 masks. Returns (masks (B, 4, 4h, 4w), iou (B, 4), mask tokens (B, 4, C), object
    score (B, 1))."""

    def __init__(self, transformer_dim: int = 256, num_multimask_outputs: int = 3):
        super().__init__()
        C = transformer_dim
        self.n_tokens = n = num_multimask_outputs + 1
        self.obj_score_token = nn.Parameter(torch.zeros(1, C))
        self.iou_token = nn.Parameter(torch.zeros(1, C))
        self.mask_tokens = nn.Parameter(torch.zeros(n, C))
        self.transformer = TwoWayTransformer(2, C, 8, 2048)
        self.upscale_conv1 = nn.ConvTranspose2d(C, C // 4, 2, 2)
        self.upscale_ln = LayerNorm2d(C // 4, eps=1e-6)
        self.upscale_conv2 = nn.ConvTranspose2d(C // 4, C // 8, 2, 2)
        for i in range(n):
            self.add_module(f"hyper_mlp_{i}", MLP(C, C, C // 8, 3))
        self.iou_head = MLP(C, 256, n, 3, sigmoid_output=True)
        self.obj_score_head = MLP(C, C, 1, 3)

    def forward(self, image_embeddings, image_pe, sparse_prompt, dense_prompt,
                high_res_features=None):
        """image_embeddings (1 or B, C, h, w); high_res_features (stride 4 (1 or B, C/8, 4h,
        4w), stride 8 (1 or B, C/4, 2h, 2w)), broadcast over the B prompts."""
        B = sparse_prompt.shape[0]
        n = self.n_tokens
        out_tokens = torch.cat([self.obj_score_token, self.iou_token, self.mask_tokens], 0)
        tokens = torch.cat([out_tokens[None].expand(B, -1, -1),
                            sparse_prompt.to(out_tokens.dtype)], 1)
        src = image_embeddings.expand(B, -1, -1, -1) + dense_prompt
        h, w = src.shape[2:]
        hs, src = self.transformer(src, image_pe, tokens)
        obj_out, iou_out, mask_out = hs[:, 0], hs[:, 1], hs[:, 2:2 + n]
        src = src.transpose(1, 2).reshape(B, -1, h, w)
        up = self.upscale_conv1(src)
        if high_res_features is not None:
            up = up + high_res_features[1]
        up = gelu(self.upscale_ln(up))
        up = self.upscale_conv2(up)
        if high_res_features is not None:
            up = up + high_res_features[0]
        up = gelu(up)                                                    # (B, C/8, 4h, 4w)
        hyper = torch.stack([getattr(self, f"hyper_mlp_{i}")(mask_out[:, i])
                             for i in range(n)], 1)                     # (B, 4, C/8)
        masks = torch.einsum("bnc,bchw->bnhw", hyper, up)
        return masks, self.iou_head(iou_out), mask_out, self.obj_score_head(obj_out)


# ------------------------------------------------------------------------------ memory
class MaskDownSampler(nn.Module):
    """Masks 16x down into the memory space: 4 x (3x3 stride-2 conv, LayerNorm, GELU) with 4,
    16, 64, 256 channels (at most 256), then a 1x1 conv to `embed_dim`."""

    def __init__(self, embed_dim: int = 64):
        super().__init__()
        ch_in = 1
        for i in range(4):
            ch = min(4 ** (i + 1), 256)
            self.add_module(f"conv_{i}", nn.Conv2d(ch_in, ch, 3, 2, 1))
            self.add_module(f"ln_{i}", LayerNorm2d(ch, eps=1e-6))
            ch_in = ch
        self.proj = nn.Conv2d(ch_in, embed_dim, 1)

    def forward(self, m):
        for i in range(4):
            m = gelu(getattr(self, f"ln_{i}")(getattr(self, f"conv_{i}")(m)))
        return self.proj(m)


class CXBlock(nn.Module):
    """ConvNeXt block on an NCHW map: depthwise 7x7, LayerNorm, MLP, layer scale `gamma`."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        y = self.norm(self.dwconv(x).permute(0, 2, 3, 1))
        y = self.gamma * self.pwconv2(gelu(self.pwconv1(y)))
        return x + y.permute(0, 3, 1, 2)


class MemoryEncoder(nn.Module):
    """Pixel features fused with the downsampled mask: (B, in_dim, h, w) and masks (B, 1, 16h,
    16w), sigmoid-scaled -> (B, out_dim, h, w)."""

    def __init__(self, out_dim: int = 64, in_dim: int = 256):
        super().__init__()
        self.mask_downsampler = MaskDownSampler(in_dim)
        self.pix_feat_proj = nn.Conv2d(in_dim, in_dim, 1)
        self.fuser_0 = CXBlock(in_dim)
        self.fuser_1 = CXBlock(in_dim)
        self.out_proj = nn.Conv2d(in_dim, out_dim, 1)

    def forward(self, pix_feat, masks):
        x = self.pix_feat_proj(pix_feat) + self.mask_downsampler(masks)
        return self.out_proj(self.fuser_1(self.fuser_0(x)))


def _axial_rope(x, h: int, w: int, theta: float = 10000.0):
    """Axial rotary embedding of an (h w)-token grid, x (B, N = h w, nh, hd): the interleaved
    channel pairs (x[..., 0::2], x[..., 1::2]) rotate by the x angle for the first hd/4 pairs
    and by the y angle for the next hd/4 (tokens row-major, x fastest)."""
    B, N, nh, hd = x.shape
    quarter = hd // 4
    dt = torch.promote_types(x.dtype, torch.float32)
    f = 1.0 / (theta ** (torch.arange(quarter, dtype=dt, device=x.device) / quarter))
    ys = torch.arange(h, dtype=dt, device=x.device)[:, None].expand(h, w).reshape(-1)
    xs = torch.arange(w, dtype=dt, device=x.device)[None, :].expand(h, w).reshape(-1)
    ang = torch.cat([xs[:, None] * f[None], ys[:, None] * f[None]], -1)    # (hw, hd/2)
    cos, sin = torch.cos(ang)[:, None].to(x.dtype), torch.sin(ang)[:, None].to(x.dtype)
    x2 = x.reshape(B, N, nh, hd // 2, 2)
    xr = x2[..., 0] * cos - x2[..., 1] * sin
    xi = x2[..., 0] * sin + x2[..., 1] * cos
    return torch.stack([xr, xi], -1).reshape(B, N, nh, hd)


class RoPEAttention(nn.Module):
    """Attention with axial RoPE on the grid tokens: the queries' grid, and the keys' grid
    once for each of the frames they hold; trailing `n_skip_k` keys stay unrotated. Keys
    outside `key_mask` (B, Lk; True = attendable) get a -1e9 logit."""

    def __init__(self, embedding_dim: int, num_heads: int = 1, kv_in_dim: int | None = None):
        super().__init__()
        C, kv = embedding_dim, kv_in_dim or embedding_dim
        self.num_heads = num_heads
        self.q_proj = nn.Linear(C, C)
        self.k_proj = nn.Linear(kv, C)
        self.v_proj = nn.Linear(kv, C)
        self.out_proj = nn.Linear(C, C)

    def forward(self, q, k, v, grid_hw, n_skip_k: int = 0, key_mask=None):
        nh = self.num_heads
        qh = self.q_proj(q).unflatten(-1, (nh, -1))
        kh = self.k_proj(k).unflatten(-1, (nh, -1))
        vh = self.v_proj(v).unflatten(-1, (nh, -1))
        h, w = grid_hw
        n_grid = h * w
        qh = torch.cat([_axial_rope(qh[:, :n_grid], h, w), qh[:, n_grid:]], 1)
        nk = kh.shape[1] - n_skip_k
        if nk % n_grid == 0 and nk >= n_grid:
            B, reps = kh.shape[0], nk // n_grid
            kr = _axial_rope(kh[:, :nk].reshape(B * reps, n_grid, nh, -1), h, w)
            kh = torch.cat([kr.reshape(B, nk, nh, -1), kh[:, nk:]], 1)
        attn = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(qh.shape[-1])
        if key_mask is not None:
            attn.masked_fill_(~key_mask[:, None, None, :], -1e9)
        out = torch.einsum("bhqk,bkhd->bqhd", softmax(attn), vh).flatten(2)
        return self.out_proj(out)


class MemoryAttentionLayer(nn.Module):
    """Self-attention, cross-attention to the memory (keys and values at mem_dim into the
    projections), FFN; LayerNorm eps 1e-5."""

    def __init__(self, d_model: int = 256, dim_feedforward: int = 2048, mem_dim: int = 64):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.self_attn = RoPEAttention(d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn_image = RoPEAttention(d_model, kv_in_dim=mem_dim)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def forward(self, tgt, memory, pos, grid_hw, n_skip_k: int = 0, key_mask=None):
        t2 = self.norm1(tgt)
        tgt = tgt + self.self_attn(t2, t2, t2, grid_hw)
        t2 = self.norm2(tgt)
        tgt = tgt + self.cross_attn_image(t2, memory + pos, memory, grid_hw, n_skip_k=n_skip_k,
                                          key_mask=key_mask)
        return tgt + self.linear2(F.relu(self.linear1(self.norm3(tgt))))


class MemoryAttention(nn.Module):
    """Condition the current frame's tokens on the memory: the input is `curr + 0.1 curr_pos`,
    then the layers and a final LayerNorm (eps 1e-5)."""

    def __init__(self, d_model: int = 256, num_layers: int = 4, mem_dim: int = 64):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", MemoryAttentionLayer(d_model, mem_dim=mem_dim))
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, curr, curr_pos, memory, memory_pos, grid_hw, n_skip_k: int = 0,
                key_mask=None):
        x = (curr + 0.1 * curr_pos).expand(memory.shape[0], -1, -1)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, memory, memory_pos, grid_hw, n_skip_k=n_skip_k,
                                            key_mask=key_mask)
        return self.norm(x)


class SAM2Model(nn.Module):
    """SAM2: promptable image segmentation (Hiera, FPN, the decoder with high-resolution
    skips) and video tracking through a fixed-slot memory bank (`encode_memory`,
    `condition_on_memory`)."""

    def __init__(self, img_size: int = 1024, embed_dim: int = 96, stages=(1, 2, 7, 2),
                 num_heads: int = 1, global_att_blocks=(5, 7, 9), window_spec=(8, 4, 14, 7),
                 window_spatial_size=(14, 14), backbone_channel_list=(768, 384, 192, 96),
                 d_model: int = 256, mem_dim: int = 64, num_maskmem: int = 7):
        super().__init__()
        self.img_size, self.d_model = img_size, d_model
        self.mem_dim, self.num_maskmem = mem_dim, num_maskmem
        self.trunk = Hiera(embed_dim, num_heads, tuple(stages), tuple(window_spec),
                           tuple(global_att_blocks), tuple(window_spatial_size))
        self.neck = FpnNeck(d_model, tuple(backbone_channel_list))
        emb = img_size // 16
        self.sam_prompt_encoder = PromptEncoder(d_model, (emb, emb), (img_size, img_size))
        self.sam_mask_decoder = SAM2MaskDecoder(d_model)
        self.memory_encoder = MemoryEncoder(mem_dim, d_model)
        self.memory_attention = MemoryAttention(d_model, mem_dim=mem_dim)
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, d_model))
        self.maskmem_tpos_enc = nn.Parameter(torch.zeros(num_maskmem, 1, 1, mem_dim))
        self.hr_proj0 = nn.Conv2d(d_model, d_model // 8, 1)
        self.hr_proj1 = nn.Conv2d(d_model, d_model // 4, 1)
        self.register_buffer("pixel_mean", torch.tensor(PIXEL_MEAN), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(PIXEL_STD), persistent=False)

    def preprocess(self, x):
        """uint8 or float (B, S, S, 3) RGB pixels -> normalized (B, 3, S, S) in the model's
        dtype."""
        return ((x.to(self.pixel_mean.dtype) - self.pixel_mean) / self.pixel_std).permute(
            0, 3, 1, 2)

    def encode(self, x):
        """(B, S, S, 3) RGB pixels -> {"image_embed": the stride-16 level plus `no_mem_embed`
        (image mode), "raw_embed": the stride-16 level, "high_res_feats": (stride 4 (B, d/8,
        S/4, S/4), stride 8 (B, d/4, S/8, S/8)) projected for the decoder's skips}, NCHW. The
        stride-32 level only feeds the top-down sum."""
        s4, s8, s16 = self.neck(self.trunk(self.preprocess(x)))[0][:-1]
        return {"image_embed": s16 + self.no_mem_embed.reshape(1, -1, 1, 1).to(s16.dtype),
                "raw_embed": s16, "high_res_feats": (self.hr_proj0(s4), self.hr_proj1(s8))}

    def decode(self, features, points=None, labels=None, boxes=None, masks=None):
        """(masks (B, 4, 4h, 4w), iou (B, 4), mask tokens (B, 4, d), object score (B, 1)) of B
        prompt queries over `encode`'s features (batch 1, or B). Points (B, N, 2) and boxes
        (B, 4) in input pixels; masks (B, 1, 4h, 4w) logits."""
        sparse, dense = self.sam_prompt_encoder(points=points, labels=labels, boxes=boxes,
                                                masks=masks)
        pe = self.sam_prompt_encoder.get_dense_pe().to(dense.dtype)
        return self.sam_mask_decoder(features["image_embed"], pe, sparse, dense,
                                     high_res_features=features["high_res_feats"])

    def encode_memory(self, raw_embed, mask_logits):
        """The stride-16 features (1 or B, d, h, w) and mask logits (B, 1, 4h, 4w) -> memories
        (B, h, w, mem_dim): the logits resized 4x by JAX's bilinear rule, then sigmoid * 20 -
        10, into the memory encoder."""
        h, w = raw_embed.shape[2:]
        m = resize_linear(mask_logits, (16 * h, 16 * w))
        m = torch.sigmoid(m) * 20.0 - 10.0
        return self.memory_encoder(raw_embed, m).permute(0, 2, 3, 1)

    def condition_on_memory(self, raw_embed, mem_bank, mem_valid, mem_tpos=None):
        """The frame's stride-16 features (1 or Q, d, h, w) conditioned on each object's bank:
        mem_bank (Q, T, h, w, mem_dim), mem_valid (Q, T), mem_tpos (T,) frames back of each
        slot (0: the prompted frame) -> (Q, d, h, w).

        Invalid slots are masked out of the softmax (-1e9), not zeroed. The temporal table is
        indexed by recency, clip(num_maskmem - 1 - tpos, 0, num_maskmem - 1), and enters the
        positional stream only: the memory's positional term is the mem_dim sine encoding
        tiled over the T slots plus its slot's row. The memory stays at mem_dim into the k / v
        projections. Objects are conditioned in chunks whose logits fit LOGITS_BUDGET."""
        Q, T, h, w, _ = mem_bank.shape
        hw, dt, dev = h * w, raw_embed.dtype, raw_embed.device
        if mem_tpos is None:
            mem_tpos = torch.arange(T, device=dev)
        memory = mem_bank.reshape(Q, T * hw, self.mem_dim)
        idx = (self.num_maskmem - 1 - torch.as_tensor(mem_tpos, device=dev)).clamp(
            0, self.num_maskmem - 1)
        tpos = self.maskmem_tpos_enc[idx].reshape(T, self.mem_dim)
        mpos = sine_pos_encoding(h, w, self.mem_dim, dtype=dt, device=dev).reshape(1, hw, -1)
        mem_pos = (mpos.repeat(1, T, 1) + tpos.repeat_interleave(hw, 0)[None]).to(memory.dtype)
        key_mask = (mem_valid > 0).repeat_interleave(hw, 1)                # (Q, T hw)
        curr = raw_embed.flatten(2).transpose(1, 2)                        # (1 or Q, hw, d)
        curr_pos = sine_pos_encoding(h, w, self.d_model, dtype=dt, device=dev).reshape(1, hw, -1)
        chunk = max(1, LOGITS_BUDGET // (hw * T * hw * torch.finfo(dt).bits // 8))
        outs = []
        for i in range(0, Q, chunk):
            c = curr if curr.shape[0] == 1 else curr[i:i + chunk]
            outs.append(self.memory_attention(c, curr_pos, memory[i:i + chunk], mem_pos, (h, w),
                                              key_mask=key_mask[i:i + chunk]))
        return torch.cat(outs).transpose(1, 2).reshape(Q, -1, h, w)

    def forward(self, x, points=None, labels=None, boxes=None, masks=None):
        return self.decode(self.encode(x), points=points, labels=labels, boxes=boxes,
                           masks=masks)

