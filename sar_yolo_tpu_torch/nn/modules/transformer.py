"""RT-DETR's transformer modules in NCHW / token layout (port of
`sar_yolo_tpu/nn/modules/transformer.py`): the AIFI encoder layer, multiscale deformable
attention, the deformable decoder layer and the RTDETRDecoder head with its top-k query
selection and contrastive denoising (CDN) queries.

Submodules carry the Flax scope names (`ma`, `norm1`, `fc1`, `cross_attn`,
`dec_layer_0`, `input_proj_bn_0`, `denoising_class_embed`, ...), so `utils/convert.py`
maps a JAX tree onto them. Precision follows the JAX modules: `Linear`, `Conv2d`,
`LayerNorm` and `Embed` output in the model's compute dtype; softmaxes run in float32;
anchors, reference boxes and the sampling locations stay float32, where JAX's type
promotion puts them.

The deformable sampling is the JAX package's gather formula term for term (not
`F.grid_sample`, whose rounding differs): x = loc W - 0.5, floor, four corner gathers with
the out-of-bounds corners zeroed, the bilinear weights summed in JAX's order.

CDN: the random draws of `_cdn_group` come in as an argument (`cdn_draws`): the trainer
draws them from its own `torch.Generator`, and the tests hand over JAX's.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .conv import BatchNorm2d, Conv2d, Linear


class LayerNorm(nn.Module):
    """Flax's LayerNorm: statistics in at least float32 with the fast variance
    max(E[x^2] - E[x]^2, 0); (x - mean) * (rsqrt(var + eps) * weight) + bias; the output in
    `compute_dtype` (None: the promoted dtype of the input and the parameters)."""

    compute_dtype = None
    follows_compute_dtype = True

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.compute_dtype or y.dtype)


class Embed(nn.Module):
    """Flax's Embed: rows of `embedding` (num, features), in `compute_dtype`."""

    compute_dtype = None
    follows_compute_dtype = True

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, features))

    def forward(self, idx):
        return self.embedding.to(self.compute_dtype or self.embedding.dtype)[idx]


class StandaloneBatchNorm(BatchNorm2d):
    """A BatchNorm that follows a bare conv or a head's embedding, with its own epsilon and
    momentum: `nn/fuse.py` leaves it as it is (the JAX package's `fuse_variables` folds only
    the Conv / DSConv patterns). Its output is in `compute_dtype` (None: the input's), as a
    Flax BatchNorm with `dtype` gives it (`follows_compute_dtype` False keeps it at the
    input's); eval mode normalizes in float32."""

    compute_dtype = None
    follows_compute_dtype = True

    def forward(self, x):
        if self.training:
            y = super().forward(x)
        else:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = (xf - self.running_mean[:, None, None]) * mul[:, None, None] + \
                self.bias[:, None, None]
        return y.to(self.compute_dtype or x.dtype)


@lru_cache(maxsize=16)
def _sincos_np(h: int, w: int, dim: int, temperature: float) -> np.ndarray:
    grid_w = np.arange(w, dtype=np.float64)
    grid_h = np.arange(h, dtype=np.float64)
    gw, gh = np.meshgrid(grid_w, grid_h, indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / (temperature ** (np.arange(pos_dim, dtype=np.float64) / pos_dim))
    out_w = gw.reshape(-1)[..., None] * omega[None]
    out_h = gh.reshape(-1)[..., None] * omega[None]
    pos = np.concatenate([np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], 1)
    return pos[None].astype(np.float32)


def sincos_pos_embed_2d(h: int, w: int, dim: int, temperature: float = 10000.0,
                        device=None) -> torch.Tensor:
    """(1, h w, dim) 2D sine-cosine embedding, computed in float64 on the host and rounded
    to float32. The grid is flattened w-major while the tokens are h-major: that pairing is
    the reference's, and trained weights depend on it."""
    return torch.from_numpy(_sincos_np(h, w, dim, temperature)).to(device)


def _sqrt_in(n: int, dtype) -> torch.Tensor:
    """sqrt(n) in float32, then in `dtype` (JAX's `jnp.sqrt(n).astype(dtype)`)."""
    return torch.tensor(float(n), dtype=torch.float32).sqrt().to(dtype)


class MultiHeadAttention(nn.Module):
    """Multi-head attention over (B, N, C) tokens; `mask` (N_q, N_k) True hides a key
    (its logit becomes -1e9, not -inf); the softmax runs in float32."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.h = num_heads
        self.q, self.k, self.v, self.out = (Linear(c, c) for _ in range(4))

    def forward(self, q, k, v, mask=None):
        B, Nq, C = q.shape
        hd = C // self.h
        qh = self.q(q).reshape(B, Nq, self.h, hd)
        kh = self.k(k).reshape(B, k.shape[1], self.h, hd)
        vh = self.v(v).reshape(B, v.shape[1], self.h, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / _sqrt_in(hd, qh.dtype).to(qh.device)
        if mask is not None:
            attn = attn.masked_fill(mask, -1e9)
        attn = attn.float().softmax(-1).to(vh.dtype)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(B, Nq, C))


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer: attention with q = k = x + pos, LayerNorm, exact-GELU FFN,
    LayerNorm."""

    def __init__(self, c: int, num_heads: int = 8, cm: int = 2048):
        super().__init__()
        self.ma = MultiHeadAttention(c, num_heads)
        self.norm1 = LayerNorm(c)
        self.fc1 = Linear(c, cm)
        self.fc2 = Linear(cm, c)
        self.norm2 = LayerNorm(c)

    def forward(self, x, pos=None):
        q = x + pos if pos is not None else x
        x = self.norm1(x + self.ma(q, q, x))
        return self.norm2(x + self.fc2(F.gelu(self.fc1(x))))


class AIFI(nn.Module):
    """Attention-based intra-scale feature interaction: one encoder layer over the tokens
    of a (B, C, H, W) map with the 2D sine-cosine position embedding."""

    def __init__(self, c1: int, cm: int = 1024, num_heads: int = 8):
        super().__init__()
        self.enc = TransformerEncoderLayer(c1, num_heads, cm)

    def forward(self, x):
        B, C, H, W = x.shape
        pos = sincos_pos_embed_2d(H, W, C, device=x.device).to(x.dtype)
        tokens = self.enc(x.flatten(2).transpose(1, 2), pos)
        return tokens.transpose(1, 2).reshape(B, C, H, W)


class MLP(nn.Module):
    """num_layers Linear layers (`l0`, `l1`, ...) with ReLU between them."""

    def __init__(self, c1: int, hidden: int, out: int, num_layers: int = 3):
        super().__init__()
        self.n = num_layers
        dims = [c1] + [hidden] * (num_layers - 1) + [out]
        for i in range(num_layers):
            self.add_module(f"l{i}", Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.n - 1):
            x = F.relu(getattr(self, f"l{i}")(x))
        return getattr(self, f"l{self.n - 1}")(x)


def ms_deformable_attention(value, shapes, sampling_locations, attention_weights):
    """Multiscale deformable attention core, the JAX package's formula term for term.

    value (B, Lv, nh, hd): the levels' tokens concatenated; shapes [(H, W), ...];
    sampling_locations (B, Q, nh, nl, np, 2) in [0, 1]; attention_weights (B, Q, nh, nl, np).
    Corners outside the map read zero (grid_sample's align_corners=False and zero padding).
    Returns (B, Q, nh hd) in the promoted dtype of the value and the weights.
    """
    B, Lv, nh, hd = value.shape
    _, Q, _, nl, npts, _ = sampling_locations.shape
    out = torch.zeros((B, Q, nh, hd), dtype=value.dtype, device=value.device)
    start = 0
    for lvl, (H, W) in enumerate(shapes):
        v = value[:, start:start + H * W].permute(0, 2, 1, 3)          # (B, nh, HW, hd)
        loc = sampling_locations[:, :, :, lvl]                          # (B, Q, nh, np, 2)
        x = loc[..., 0] * W - 0.5
        y = loc[..., 1] * H - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        dx = x - x0
        dy = y - y0
        xi, yi = x0.to(torch.int32), y0.to(torch.int32)

        def gather(xi, yi, v=v, H=H, W=W):
            inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()   # (B, Q, nh, np)
            idx = idx.permute(0, 2, 1, 3).reshape(B, nh, Q * npts, 1).expand(-1, -1, -1, hd)
            g = torch.gather(v, 2, idx).reshape(B, nh, Q, npts, hd).permute(0, 2, 1, 3, 4)
            return g * inb[..., None]

        w00 = ((1 - dx) * (1 - dy))[..., None]
        w01 = (dx * (1 - dy))[..., None]
        w10 = ((1 - dx) * dy)[..., None]
        w11 = (dx * dy)[..., None]
        sampled = (gather(xi, yi) * w00 + gather(xi + 1, yi) * w01 +
                   gather(xi, yi + 1) * w10 + gather(xi + 1, yi + 1) * w11)
        out = out + (sampled * attention_weights[:, :, :, lvl, :, None]).sum(3)
        start += H * W
    return out.reshape(B, Q, nh * hd)


class MSDeformAttn(nn.Module):
    """Multiscale deformable attention: per query, head, level and point an offset from
    the reference box (scaled by its half size over the point count) and a float32-softmaxed
    weight over levels x points."""

    def __init__(self, d_model: int = 256, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        self.nh, self.nl, self.np = n_heads, n_levels, n_points
        self.value_proj = Linear(d_model, d_model)
        self.sampling_offsets = Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = Linear(d_model, d_model)

    @torch.no_grad()
    def reset_offsets(self):
        """The JAX init: offset kernel 0 and the ring-pattern bias (head h's direction
        (cos, sin)(2 pi h / nh) over its max-norm, point p at p + 1 times it); attention
        weights kernel and bias 0."""
        nh, nl, npts = self.nh, self.nl, self.np
        thetas = torch.arange(nh, dtype=torch.float32) * (2.0 * math.pi / nh)
        grid = torch.stack([thetas.cos(), thetas.sin()], -1)
        grid = grid / grid.abs().amax(-1, keepdim=True)
        grid = grid[:, None, None, :].repeat(1, nl, npts, 1)
        scale = torch.arange(1, npts + 1, dtype=torch.float32)[None, None, :, None]
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_((grid * scale).reshape(-1))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()

    def forward(self, query, refer_bbox, value, shapes):
        """query (B, Q, C); refer_bbox (B, Q, 4) normalized cxcywh; value (B, Lv, C)."""
        B, Q, C = query.shape
        nh, nl, npts = self.nh, self.nl, self.np
        v = self.value_proj(value).reshape(B, -1, nh, C // nh)
        offsets = self.sampling_offsets(query).reshape(B, Q, nh, nl, npts, 2)
        attn = self.attention_weights(query).reshape(B, Q, nh, nl * npts)
        attn = attn.float().softmax(-1).to(query.dtype).reshape(B, Q, nh, nl, npts)
        add = offsets / npts * refer_bbox[:, :, None, None, None, 2:] * 0.5
        loc = refer_bbox[:, :, None, None, None, :2] + add
        return self.output_proj(ms_deformable_attention(v, shapes, loc, attn))


class DeformableTransformerDecoderLayer(nn.Module):
    """Self-attention (with the CDN block mask), deformable cross-attention into the
    encoder tokens, ReLU FFN; post-norm after each."""

    def __init__(self, d_model: int = 256, n_heads: int = 8, d_ffn: int = 1024,
                 n_levels: int = 3, n_points: int = 4):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_heads)
        self.norm1 = LayerNorm(d_model)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm2 = LayerNorm(d_model)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.norm3 = LayerNorm(d_model)

    def forward(self, embed, refer_bbox, feats, shapes, query_pos, attn_mask=None):
        q = embed + query_pos
        embed = self.norm1(embed + self.self_attn(q, q, embed, mask=attn_mask))
        embed = self.norm2(embed + self.cross_attn(embed + query_pos, refer_bbox, feats, shapes))
        return self.norm3(embed + self.linear2(F.relu(self.linear1(embed))))


def inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def cdn_sizes(M: int, num_dn: int = 100) -> tuple[int, int]:
    """(G, DN) of the CDN queries for M padded labels an image: G = max(1, num_dn // 2M)
    groups of [M positives | M negatives], DN = 2 G M queries."""
    G = max(1, num_dn // max(2 * M, 1))
    return G, G * 2 * M


def draw_cdn(B: int, M: int, nc: int, generator: torch.Generator, device=None) -> dict:
    """The CDN queries' random draws for B images of M padded labels, from `generator`
    (on `device`): `flip` (B, DN) uniform (the class flips where < 0.25), `cls` (B, DN)
    int in [0, nc) (the flipped classes), `sign` (B, DN, 4) uniform (a corner moves down
    where < 0.5), `part` (B, DN, 4) uniform (the share of the half size it moves)."""
    _, DN = cdn_sizes(M)
    kw = dict(generator=generator, device=device)
    return {"flip": torch.rand((B, DN), **kw),
            "cls": torch.randint(0, nc, (B, DN), **kw),
            "sign": torch.rand((B, DN, 4), **kw),
            "part": torch.rand((B, DN, 4), **kw)}


class RTDETRDecoder(nn.Module):
    """The RT-DETR head over P3-P5 maps.

    Eval mode returns (dec_bboxes (ndl, B, nq, 4) sigmoid cxcywh in [0, 1], dec_scores
    (ndl, B, nq, nc) logits, enc_bboxes (B, nq, 4), enc_scores (B, nq, nc)). In train mode
    with `batch_gt` ({"cls" (B, M), "bboxes" (B, M, 4) normalized xywh, "mask" (B, M)}) and
    `cdn_draws` (`draw_cdn`), DN denoising queries go first and a fifth element
    {"dn_bboxes", "dn_scores", "pos_flag", "G"} carries their outputs for the loss; the
    embed and reference inputs of the decoder are detached, as JAX's stop_gradient does.

    Query selection is the top nq of the valid tokens' best encoder score: a stable sort,
    so equal scores keep the lower token index first, as `lax.top_k` orders them.
    """

    def __init__(self, nc: int = 80, ch: tuple = (512, 1024, 2048), hd: int = 256,
                 nq: int = 300, ndp: int = 4, nh: int = 8, ndl: int = 6, d_ffn: int = 1024):
        super().__init__()
        self.nc, self.hd, self.nq, self.ndl = nc, hd, nq, ndl
        for i, c in enumerate(ch):
            self.add_module(f"input_proj_{i}", Conv2d(c, hd, 1, bias=False))
            self.add_module(f"input_proj_bn_{i}", StandaloneBatchNorm(hd, eps=1e-5,
                                                                      momentum=0.03))
        self.nlv = len(ch)
        self.enc_output = Linear(hd, hd)
        self.enc_norm = LayerNorm(hd)
        self.enc_score_head = Linear(hd, nc)
        self.enc_bbox_head = MLP(hd, hd, 4, 3)
        self.denoising_class_embed = Embed(nc, hd)
        self.query_pos_head = MLP(4, 2 * hd, hd, 2)
        for i in range(ndl):
            self.add_module(f"dec_layer_{i}", DeformableTransformerDecoderLayer(
                hd, nh, d_ffn, len(ch), ndp))
            self.add_module(f"dec_bbox_head_{i}", MLP(hd, hd, 4, 3))
            self.add_module(f"dec_score_head_{i}", Linear(hd, nc))

    @torch.no_grad()
    def reset_heads(self):
        """The JAX init of the score heads' bias (-4.6) and of the deformable offsets."""
        for i in range(self.ndl):
            getattr(self, f"dec_score_head_{i}").bias.fill_(-4.6)
            getattr(self, f"dec_layer_{i}").cross_attn.reset_offsets()
        self.enc_score_head.bias.fill_(-4.6)

    def _cdn_group(self, batch_gt: dict, draws: dict, cls_noise: float = 0.5,
                   box_noise: float = 1.0):
        """(dn_cls (B, DN) long, dn_box (B, DN, 4) normalized xywh, pos_flag (DN,), G) of the
        padded ground truth, noised with `draws` as the JAX package's `_cdn_group` does."""
        gt_cls = batch_gt["cls"].long()
        gt_box = batch_gt["bboxes"].float()
        B, M = gt_cls.shape
        G, DN = cdn_sizes(M)
        cls = gt_cls.repeat(1, 2 * G)
        box = gt_box.repeat(1, 2 * G, 1)
        pos_flag = torch.cat([torch.ones(M), torch.zeros(M)]).repeat(G).to(box.device)
        cls = torch.where(draws["flip"] < cls_noise * 0.5, draws["cls"].long(), cls)
        xy, wh = box[..., :2], box[..., 2:]
        corners = torch.cat([xy - wh / 2, xy + wh / 2], -1)
        diff = torch.cat([wh / 2, wh / 2], -1) * box_noise
        sign = torch.where(draws["sign"] < 0.5, -1.0, 1.0)
        part = draws["part"] + (1.0 - pos_flag)[None, :, None]
        corners = (corners + sign * part * diff).clamp(0.0, 1.0)
        x1y1, x2y2 = corners[..., :2], corners[..., 2:]
        return cls, torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1), pos_flag, G

    def _anchors(self, shapes, device):
        """(anchors (1, Lv, 4) cxcywh, valid (1, Lv, 1)) over the level grids, float32."""
        anchors = []
        for i, (h, w) in enumerate(shapes):
            sy = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
            sx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
            gy, gx = torch.meshgrid(sy, sx, indexing="ij")
            xy = torch.stack([gx, gy], -1).reshape(-1, 2)
            anchors.append(torch.cat([xy, torch.full_like(xy, 0.05 * (2.0 ** i))], -1))
        anchors = torch.cat(anchors, 0)[None]
        eps = 1e-2
        return anchors, ((anchors > eps) & (anchors < 1 - eps)).all(-1, keepdim=True)

    def forward(self, xs, batch_gt=None, cdn_draws=None):
        B = xs[0].shape[0]
        shapes = tuple((x.shape[2], x.shape[3]) for x in xs)
        feats = torch.cat([getattr(self, f"input_proj_bn_{i}")(
            getattr(self, f"input_proj_{i}")(x)).flatten(2).transpose(1, 2)
            for i, x in enumerate(xs)], 1)                              # (B, Lv, hd)
        anchors, valid = self._anchors(shapes, feats.device)
        anchors_logit = torch.where(valid, inverse_sigmoid(anchors), torch.inf)

        nq = min(self.nq, feats.shape[1])
        features = self.enc_norm(self.enc_output(feats * valid.to(feats.dtype)))
        enc_scores_all = self.enc_score_head(features)
        best = torch.where(valid[..., 0], enc_scores_all.amax(-1), -torch.inf)
        topk_idx = torch.sort(best, dim=1, descending=True, stable=True)[1][:, :nq]
        top_feats = torch.gather(features, 1,
                                 topk_idx[..., None].expand(-1, -1, features.shape[-1]))
        top_anchor_logit = torch.gather(anchors_logit.expand(B, -1, -1), 1,
                                        topk_idx[..., None].expand(-1, -1, 4))
        refer_logit = self.enc_bbox_head(top_feats) + top_anchor_logit
        enc_bboxes = torch.sigmoid(refer_logit)
        enc_scores = torch.gather(enc_scores_all, 1,
                                  topk_idx[..., None].expand(-1, -1, enc_scores_all.shape[-1]))
        train = self.training
        embed = top_feats.detach() if train else top_feats
        refer_logit = refer_logit.detach() if train else refer_logit

        DN, attn_mask, dn_meta = 0, None, None
        if train and batch_gt is not None:
            dn_cls, dn_box, pos_flag, G = self._cdn_group(batch_gt, cdn_draws)
            DN = dn_cls.shape[1]
            M2 = DN // G
            dn_embed = self.denoising_class_embed(dn_cls)
            embed = torch.cat([dn_embed.to(embed.dtype), embed], 1)
            refer_logit = torch.cat([inverse_sigmoid(dn_box).to(refer_logit.dtype), refer_logit], 1)
            idx = torch.arange(DN + nq, device=feats.device)
            grp = torch.where(idx < DN, idx // M2, G)
            attn_mask = (grp[:, None] != grp[None, :]) & (idx < DN)[None, :]
            dn_meta = {"pos_flag": pos_flag, "G": G}

        refer = torch.sigmoid(refer_logit)
        dec_bboxes, dec_scores = [], []
        out = embed
        for i in range(self.ndl):
            out = getattr(self, f"dec_layer_{i}")(out, refer, feats, shapes,
                                                  self.query_pos_head(refer), attn_mask)
            refined = torch.sigmoid(getattr(self, f"dec_bbox_head_{i}")(out) +
                                    inverse_sigmoid(refer))
            dec_bboxes.append(refined)
            dec_scores.append(getattr(self, f"dec_score_head_{i}")(out))
            refer = refined.detach() if train else refined
        dec_bboxes = torch.stack(dec_bboxes)
        dec_scores = torch.stack(dec_scores)
        if DN:
            dn_meta["dn_bboxes"] = dec_bboxes[:, :, :DN]
            dn_meta["dn_scores"] = dec_scores[:, :, :DN]
            return (dec_bboxes[:, :, DN:], dec_scores[:, :, DN:], enc_bboxes, enc_scores, dn_meta)
        return dec_bboxes, dec_scores, enc_bboxes, enc_scores
