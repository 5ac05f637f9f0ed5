"""SAM (Segment Anything) modules (port of `sar_yolo_tpu/models/sam/modules.py`): the ViT
image encoder with decomposed relative positions, the prompt encoder, the two-way
transformer mask decoder and `SAMModel`.

Submodules carry the Flax scope names of the JAX package (`block_3.attn.qkv`,
`prompt_encoder.mask_conv1`, `mask_decoder.transformer.layer_0.self_attn.q_proj`, ...), so
`utils/convert.py::from_jax_variables` maps JAX's variables onto them mechanically. Image
tensors are NCHW; inside the encoder the blocks work on (B, H, W, C) token grids, as JAX's
do. The attention is plain torch ops (matmul, softmax in at least float32), as the JAX
package computes it with einsums outside any Pallas kernel: a global block at 1024 px holds
(B, heads, 4096, 4096) logits. The resizes that JAX does with `jax.image.resize` (the
position embedding, a rel-pos table for another grid) use its weights
(`ops/masks.py::resize_linear`), antialiased when they shrink, which `F.interpolate` is not.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from sar_yolo_tpu_torch.ops.masks import resize_linear

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


def softmax(x):
    """Softmax over the last axis in at least float32 (JAX's `softmax(x.astype(float32))`;
    a float64 model keeps float64)."""
    return F.softmax(x, -1, dtype=torch.promote_types(x.dtype, torch.float32)).to(x.dtype)


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW tensor (Flax's LayerNorm of an NHWC map)."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class MLPBlock(nn.Module):
    """Linear, exact GELU, Linear (a ViT block's MLP)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


class MLP(nn.Module):
    """n Linear layers `l0..l{n-1}` with ReLU between them; optional sigmoid output."""

    def __init__(self, dim: int, hidden: int, out: int, num_layers: int = 3,
                 sigmoid_output: bool = False):
        super().__init__()
        dims = [dim] + [hidden] * (num_layers - 1) + [out]
        for i in range(num_layers):
            self.add_module(f"l{i}", nn.Linear(dims[i], dims[i + 1]))
        self.num_layers, self.sigmoid_output = num_layers, sigmoid_output

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"l{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


def get_rel_pos(q_size: int, k_size: int, rel_pos):
    """The (2 max - 1, hd) rel-pos table as (q_size, k_size, hd); a table of another length is
    first resized along its rows with JAX's linear rule (antialiased when it shrinks)."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = resize_linear(rel_pos, (max_rel_dist,), dims=(0,))
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[torch.as_tensor(rel.astype(np.int32), dtype=torch.long, device=rel_pos.device)]


class RelPosAttention(nn.Module):
    """Multi-head attention over a (B, H, W, C) grid with decomposed relative positions: the
    H and W offsets' biases are two einsums of the queries with the sliced tables, added to
    the logits."""

    def __init__(self, dim: int, num_heads: int, input_size: tuple):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, H, W, C = x.shape
        nh, hd = self.num_heads, C // self.num_heads
        q, k, v = self.qkv(x).reshape(B, H * W, 3, nh, hd).unbind(2)   # (B, N, nh, hd) each
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        Rh = get_rel_pos(H, H, self.rel_pos_h).to(q.dtype)               # (H, H, hd)
        Rw = get_rel_pos(W, W, self.rel_pos_w).to(q.dtype)               # (W, W, hd)
        rq = q.reshape(B, H, W, nh, hd)
        bias_h = torch.einsum("bhwnd,hkd->bnhwk", rq, Rh)                # (B, nh, H, W, H)
        bias_w = torch.einsum("bhwnd,wkd->bnhwk", rq, Rw)                # (B, nh, H, W, W)
        grid = attn.view(B, nh, H, W, H, W)
        grid += bias_h[..., :, None]     # in place: the logits are the block's largest tensor
        grid += bias_w[..., None, :]
        out = torch.einsum("bhqk,bkhd->bqhd", softmax(attn), v).reshape(B, H, W, C)
        return self.proj(out)


def window_partition(x, window: int):
    """(B, H, W, C) -> (B nW, window, window, C), padded bottom-right with zeros; and the
    padded size."""
    B, H, W, C = x.shape
    ph, pw = (window - H % window) % window, (window - W % window) % window
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // window, window, Wp // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C), (Hp, Wp)


def window_unpartition(x, window: int, pad_hw, hw):
    """Inverse of `window_partition`, the padding cropped."""
    Hp, Wp = pad_hw
    H, W = hw
    B = x.shape[0] // ((Hp // window) * (Wp // window))
    x = x.reshape(B, Hp // window, Wp // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)[:, :H, :W]


class ViTBlock(nn.Module):
    """Pre-norm transformer block over a (B, H, W, C) grid; windowed attention (14 x 14
    windows) unless `window_size` is 0 (global attention over the whole grid)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, window_size: int,
                 input_size: tuple):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = RelPosAttention(dim, num_heads, (window_size, window_size)
                                    if window_size > 0 else input_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        hw = x.shape[1:3]
        if self.window_size > 0:
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, hw)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class ImageEncoderViT(nn.Module):
    """SAM's ViT: 16 x 16 patch embedding, absolute position embedding, windowed and global
    blocks, then a 1x1 + 3x3 conv neck to `out_chans`. (B, 3, S, S) normalized ->
    (B, out_chans, S / 16, S / 16)."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 out_chans: int = 256, window_size: int = 14, global_attn_indexes=()):
        super().__init__()
        g = img_size // patch_size
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, embed_dim))
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block_{i}", ViTBlock(
                embed_dim, num_heads, mlp_ratio,
                0 if i in global_attn_indexes else window_size, (g, g)))
        self.neck_conv1 = nn.Conv2d(embed_dim, out_chans, 1, bias=False)
        self.neck_ln1 = LayerNorm2d(out_chans, eps=1e-6)
        self.neck_conv2 = nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False)
        self.neck_ln2 = LayerNorm2d(out_chans, eps=1e-6)

    def forward(self, x):
        x = self.patch_embed(x).permute(0, 2, 3, 1)                       # (B, g, g, C)
        pos = self.pos_embed
        if pos.shape[1:3] != x.shape[1:3]:  # another input size: JAX's bilinear resize
            pos = resize_linear(pos, x.shape[1:3], dims=(1, 2))
        x = x + pos.to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        x = self.neck_ln1(self.neck_conv1(x.permute(0, 3, 1, 2)))
        return self.neck_ln2(self.neck_conv2(x))


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier position encoding; `gaussian_matrix` is a parameter, so converted and
    bridged weights restore it."""

    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.gaussian_matrix = nn.Parameter(torch.zeros(2, num_pos_feats))

    def forward(self, coords):
        """coords (..., 2) in [0, 1] -> (..., 2 num_pos_feats)."""
        c = ((2.0 * coords - 1.0) @ self.gaussian_matrix) * (2.0 * math.pi)
        return torch.cat([torch.sin(c), torch.cos(c)], -1)

    def grid(self, h: int, w: int):
        """The encoding of each cell centre of an h x w grid: (h, w, 2 num_pos_feats)."""
        dt, dev = self.gaussian_matrix.dtype, self.gaussian_matrix.device
        ys = (torch.arange(h, dtype=dt, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=dt, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        return self(torch.stack([gx, gy], -1))


class PromptEncoder(nn.Module):
    """Sparse (points, boxes) and dense (mask) prompt embeddings. Point labels: -1 pad
    (not-a-point), 0 negative, 1 positive, 2 / 3 box corners; a label's embedding is chosen by
    a one-hot product (a label outside -1..3 adds none), as in the JAX package."""

    def __init__(self, embed_dim: int = 256, image_embedding_size=(64, 64),
                 input_image_size=(1024, 1024), mask_in_chans: int = 16):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.Parameter(torch.zeros(4, embed_dim))
        self.not_a_point_embed = nn.Parameter(torch.zeros(embed_dim))
        self.no_mask_embed = nn.Parameter(torch.zeros(embed_dim))
        ch = mask_in_chans
        self.mask_conv1 = nn.Conv2d(1, ch // 4, 2, 2)
        self.mask_ln1 = LayerNorm2d(ch // 4, eps=1e-6)
        self.mask_conv2 = nn.Conv2d(ch // 4, ch, 2, 2)
        self.mask_ln2 = LayerNorm2d(ch, eps=1e-6)
        self.mask_conv3 = nn.Conv2d(ch, embed_dim, 1)

    def get_dense_pe(self):
        """(1, C, h, w) encoding of the image embedding's grid."""
        return self.pe_layer.grid(*self.image_embedding_size).permute(2, 0, 1)[None]

    def _normalized(self, xy):
        h, w = self.input_image_size
        return (xy + 0.5) / torch.tensor([w, h], dtype=xy.dtype, device=xy.device)

    def embed_points(self, points, labels):
        """points (B, N, 2) in input pixels, labels (B, N) -> (B, N, C)."""
        pe = self.pe_layer(self._normalized(points))
        lbl = labels.to(torch.int32)
        pe = torch.where((lbl == -1)[..., None], torch.zeros((), dtype=pe.dtype,
                                                             device=pe.device), pe)
        table = torch.cat([self.not_a_point_embed[None], self.point_embeddings], 0)
        one_hot = (lbl[..., None] + 1 == torch.arange(5, device=lbl.device)).to(table.dtype)
        return pe + one_hot @ table

    def embed_boxes(self, boxes):
        """boxes (B, 4) xyxy in input pixels -> (B, 2, C) corner tokens."""
        pe = self.pe_layer(self._normalized(boxes.reshape(-1, 2, 2)))
        return pe + self.point_embeddings[2:4][None]

    def embed_masks(self, masks):
        """masks (B, 1, 4 h, 4 w) -> (B, C, h, w)."""
        x = F.gelu(self.mask_ln1(self.mask_conv1(masks)))
        x = F.gelu(self.mask_ln2(self.mask_conv2(x)))
        return self.mask_conv3(x)

    def forward(self, points=None, labels=None, boxes=None, masks=None):
        """(sparse (B, Ns, C), dense (B, C, h, w)). Points without boxes carry one more
        (0, 0) / -1 pad token, as SAM's trained weights expect."""
        parts, bs = [], 1
        dt = self.point_embeddings.dtype
        if points is not None:
            points = points.to(dt)
            if boxes is None:
                points = torch.cat([points, points.new_zeros(points.shape[0], 1, 2)], 1)
                labels = torch.cat([labels, -labels.new_ones(labels.shape[0], 1)], 1)
            parts.append(self.embed_points(points, labels))
            bs = points.shape[0]
        if boxes is not None:
            parts.append(self.embed_boxes(boxes.to(dt)))
            bs = boxes.shape[0]
        sparse = torch.cat(parts, 1) if parts else self.point_embeddings.new_zeros(
            bs, 0, self.embed_dim)
        if masks is not None:
            dense = self.embed_masks(masks.to(dt))
        else:
            h, w = self.image_embedding_size
            dense = self.no_mask_embed.reshape(1, -1, 1, 1).expand(bs, -1, h, w)
        return sparse, dense


class DownsampleAttention(nn.Module):
    """The decoder's attention, its channels projected down by `downsample_rate`."""

    def __init__(self, embedding_dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        C = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embedding_dim, C)
        self.k_proj = nn.Linear(embedding_dim, C)
        self.v_proj = nn.Linear(embedding_dim, C)
        self.out_proj = nn.Linear(C, embedding_dim)

    def forward(self, q, k, v):
        nh = self.num_heads
        qh = self.q_proj(q).unflatten(-1, (nh, -1))
        kh = self.k_proj(k).unflatten(-1, (nh, -1))
        vh = self.v_proj(v).unflatten(-1, (nh, -1))
        attn = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(qh.shape[-1])
        out = torch.einsum("bhqk,bkhd->bqhd", softmax(attn), vh).flatten(2)
        return self.out_proj(out)


class TwoWayAttentionBlock(nn.Module):
    """Token self-attention, token-to-image cross-attention, MLP, image-to-token
    cross-attention (LayerNorm eps 1e-5)."""

    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        E = embedding_dim
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DownsampleAttention(E, num_heads)
        self.norm1 = nn.LayerNorm(E, eps=1e-5)
        self.cross_attn_token_to_image = DownsampleAttention(E, num_heads, 2)
        self.norm2 = nn.LayerNorm(E, eps=1e-5)
        self.mlp_lin1 = nn.Linear(E, mlp_dim)
        self.mlp_lin2 = nn.Linear(mlp_dim, E)
        self.norm3 = nn.LayerNorm(E, eps=1e-5)
        self.cross_attn_image_to_token = DownsampleAttention(E, num_heads, 2)
        self.norm4 = nn.LayerNorm(E, eps=1e-5)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        k = keys + key_pe
        queries = queries + self.cross_attn_token_to_image(queries + query_pe, k, keys)
        queries = self.norm2(queries)
        queries = self.norm3(queries + self.mlp_lin2(F.relu(self.mlp_lin1(queries))))
        q = queries + query_pe
        keys = keys + self.cross_attn_image_to_token(k, q, queries)
        return queries, self.norm4(keys)


class TwoWayTransformer(nn.Module):
    """Tokens <-> image embedding transformer of the mask decoder."""

    def __init__(self, depth: int = 2, embedding_dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"layer_{i}", TwoWayAttentionBlock(
                embedding_dim, num_heads, mlp_dim, skip_first_layer_pe=i == 0))
        self.final_attn_token_to_image = DownsampleAttention(embedding_dim, num_heads, 2)
        self.norm_final_attn = nn.LayerNorm(embedding_dim, eps=1e-5)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding (B, C, h, w), image_pe (1 or B, C, h, w), point_embedding (B, N, C)
        -> (queries (B, N, C), keys (B, h w, C))."""
        keys = image_embedding.flatten(2).transpose(1, 2)
        key_pe = image_pe.flatten(2).transpose(1, 2)
        queries = point_embedding
        for i in range(self.depth):
            queries, keys = getattr(self, f"layer_{i}")(queries, keys, point_embedding, key_pe)
        k = keys + key_pe
        queries = queries + self.final_attn_token_to_image(queries + point_embedding, k, keys)
        return self.norm_final_attn(queries), keys


class MaskDecoder(nn.Module):
    """Hypernetwork mask decoder: (masks (B, 4, 4 h, 4 w) logits, iou_pred (B, 4)); slot 0 is
    the single-mask output, slots 1-3 the multimask outputs (callers pick)."""

    def __init__(self, transformer_dim: int = 256, num_multimask_outputs: int = 3,
                 iou_head_depth: int = 3, iou_head_hidden_dim: int = 256,
                 transformer_depth: int = 2, transformer_heads: int = 8,
                 transformer_mlp_dim: int = 2048):
        super().__init__()
        C = transformer_dim
        self.n_tokens = n = num_multimask_outputs + 1
        self.iou_token = nn.Parameter(torch.zeros(1, C))
        self.mask_tokens = nn.Parameter(torch.zeros(n, C))
        self.transformer = TwoWayTransformer(transformer_depth, C, transformer_heads,
                                             transformer_mlp_dim)
        self.upscale_conv1 = nn.ConvTranspose2d(C, C // 4, 2, 2)
        self.upscale_ln = LayerNorm2d(C // 4, eps=1e-6)
        self.upscale_conv2 = nn.ConvTranspose2d(C // 4, C // 8, 2, 2)
        for i in range(n):
            self.add_module(f"hyper_mlp_{i}", MLP(C, C, C // 8, 3))
        self.iou_head = MLP(C, iou_head_hidden_dim, n, iou_head_depth)

    def forward(self, image_embeddings, image_pe, sparse_prompt, dense_prompt):
        """image_embeddings (1 or B, C, h, w); the prompts batched over B queries."""
        B = sparse_prompt.shape[0]
        out_tokens = torch.cat([self.iou_token, self.mask_tokens], 0)[None].expand(B, -1, -1)
        tokens = torch.cat([out_tokens, sparse_prompt.to(out_tokens.dtype)], 1)
        src = image_embeddings.expand(B, -1, -1, -1) + dense_prompt
        pos = image_pe.expand(B, -1, -1, -1)
        h, w = src.shape[2:]
        hs, src = self.transformer(src, pos, tokens)
        iou_out, mask_out = hs[:, 0], hs[:, 1:1 + self.n_tokens]
        src = src.transpose(1, 2).reshape(B, -1, h, w)
        up = F.gelu(self.upscale_ln(self.upscale_conv1(src)))
        up = F.gelu(self.upscale_conv2(up))                              # (B, C/8, 4h, 4w)
        hyper = torch.stack([getattr(self, f"hyper_mlp_{i}")(mask_out[:, i])
                             for i in range(self.n_tokens)], 1)          # (B, 4, C/8)
        masks = torch.einsum("bnc,bchw->bnhw", hyper, up)
        return masks, self.iou_head(iou_out)


class SAMModel(nn.Module):
    """SAM: `encode` runs the image tower once per image, `decode` the prompt encoder and mask
    decoder per prompt batch; `encoder="tiny"` takes MobileSAM's TinyViT."""

    def __init__(self, img_size: int = 1024, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, global_attn_indexes=(2, 5, 8, 11),
                 prompt_embed_dim: int = 256, decoder_heads: int = 8, encoder: str = "vit",
                 tiny_cfg: dict | None = None):
        super().__init__()
        self.img_size = img_size
        if encoder == "tiny":
            from sar_yolo_tpu_torch.models.sam.tiny_vit import TinyViT
            self.image_encoder = TinyViT(out_chans=prompt_embed_dim, **(tiny_cfg or {}))
        else:
            self.image_encoder = ImageEncoderViT(
                img_size=img_size, embed_dim=embed_dim, depth=depth, num_heads=num_heads,
                global_attn_indexes=tuple(global_attn_indexes), out_chans=prompt_embed_dim)
        emb = img_size // 16
        self.prompt_encoder = PromptEncoder(prompt_embed_dim, (emb, emb), (img_size, img_size))
        self.mask_decoder = MaskDecoder(prompt_embed_dim, transformer_heads=decoder_heads)
        self.register_buffer("pixel_mean", torch.tensor(PIXEL_MEAN), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(PIXEL_STD), persistent=False)

    def preprocess(self, x):
        """uint8 or float (B, S, S, 3) RGB pixels -> normalized (B, 3, S, S) in the model's
        dtype."""
        x = (x.to(self.pixel_mean.dtype) - self.pixel_mean) / self.pixel_std
        return x.permute(0, 3, 1, 2)

    def encode(self, x):
        """(B, S, S, 3) RGB pixels -> image embeddings (B, 256, S / 16, S / 16)."""
        return self.image_encoder(self.preprocess(x))

    def decode(self, embeddings, points=None, labels=None, boxes=None, masks=None):
        """Masks (B, 4, 4 h, 4 w) and IoU predictions (B, 4) of B prompt queries over
        embeddings of batch 1 (or B). Points (B, N, 2) and boxes (B, 4) in input pixels;
        masks (B, 1, 4 h, 4 w) logits."""
        sparse, dense = self.prompt_encoder(points=points, labels=labels, boxes=boxes,
                                            masks=masks)
        pe = self.prompt_encoder.get_dense_pe().to(embeddings.dtype)
        return self.mask_decoder(embeddings, pe, sparse, dense)

    def forward(self, x, points=None, labels=None, boxes=None, masks=None):
        return self.decode(self.encode(x), points=points, labels=labels, boxes=boxes,
                           masks=masks)
