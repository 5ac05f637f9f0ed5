"""SAM registry and builder (port of `sar_yolo_tpu/models/sam/build.py`).

No checkpoint is downloaded. `build_sam` takes a size name ("sam_b.pt", "sam_l",
"mobile_sam", "sam2_b", "sam2.1_t", ...) and optional weights: a state dict saved by this
package (`torch.save(model.state_dict(), path)`), or a Meta / Ultralytics `.pt` / `.pth` SAM,
MobileSAM or SAM2 state dict, translated by `convert.py`. Both are read with
`weights_only=True`. Without weights the parameters are drawn from a seeded
`torch.Generator`.
"""

from __future__ import annotations

from pathlib import Path

import torch

from sar_yolo_tpu_torch.models.sam.modules import SAMModel
from sar_yolo_tpu_torch.models.sam.modules2 import SAM2Model
from sar_yolo_tpu_torch.models.sam.tiny_vit import MOBILE_SAM_CONFIGS
from sar_yolo_tpu_torch.utils import LOGGER, select_device

# the image encoder: embed_dim, depth, num_heads, global_attn_indexes (Meta's ViT-H/L/B)
SAM_CONFIGS = {
    "sam_h": dict(embed_dim=1280, depth=32, num_heads=16, global_attn_indexes=(7, 15, 23, 31)),
    "sam_l": dict(embed_dim=1024, depth=24, num_heads=16, global_attn_indexes=(5, 11, 17, 23)),
    "sam_b": dict(embed_dim=768, depth=12, num_heads=12, global_attn_indexes=(2, 5, 8, 11)),
    # the JAX package's test size (not a published one)
    "sam_test": dict(embed_dim=64, depth=2, num_heads=2, global_attn_indexes=(1,),
                     img_size=128, prompt_embed_dim=32, decoder_heads=2),
}
# Hiera (embed_dim, stages, num_heads, global_att_blocks, window_spec) and the FPN's channels,
# low resolution first (Meta's SAM2 tiny / small / base+ / large)
SAM2_CONFIGS = {
    "sam2_t": dict(embed_dim=96, stages=(1, 2, 7, 2), num_heads=1,
                   global_att_blocks=(5, 7, 9), window_spec=(8, 4, 14, 7),
                   backbone_channel_list=(768, 384, 192, 96)),
    "sam2_s": dict(embed_dim=96, stages=(1, 2, 11, 2), num_heads=1,
                   global_att_blocks=(7, 10, 13), window_spec=(8, 4, 14, 7),
                   backbone_channel_list=(768, 384, 192, 96)),
    "sam2_b": dict(embed_dim=112, stages=(2, 3, 16, 3), num_heads=2,
                   global_att_blocks=(12, 16, 20), window_spec=(8, 4, 14, 7),
                   window_spatial_size=(14, 14), backbone_channel_list=(896, 448, 224, 112)),
    "sam2_l": dict(embed_dim=144, stages=(2, 6, 36, 4), num_heads=2,
                   global_att_blocks=(23, 33, 43), window_spec=(8, 4, 16, 8),
                   backbone_channel_list=(1152, 576, 288, 144)),
    # the JAX package's test size (not a published one; its global block is no stage change)
    "sam2_test": dict(embed_dim=16, stages=(1, 1, 2, 1), num_heads=1, global_att_blocks=(3,),
                      window_spec=(4, 4, 4, 4), window_spatial_size=(4, 4),
                      backbone_channel_list=(128, 64, 32, 16), img_size=128),
}


def _canon(name) -> str:
    """'sam_b.pt', 'SAM-B', 'path/to/mobile_sam.pth', 'sam2.1_t' -> 'sam_b', 'sam_b',
    'mobile_sam', 'sam2_t' (only real weight suffixes are stripped)."""
    s = str(name).lower().replace("-", "_")
    for suf in (".pt", ".pth"):
        if s.endswith(suf):
            s = s[: -len(suf)]
    return Path(s).name.replace("sam2.1", "sam2")


def build_sam(model="sam_b.pt", weights=None, dtype=torch.float32, imgsz: int | None = None,
              device=None):
    """(SAMModel or SAM2Model in eval mode on `device`, info dict). `device`: cuda unless given
    (raises without CUDA). Unknown names raise ValueError."""
    name, device = _canon(model), select_device(device)
    if name.startswith("sam2"):
        return build_sam2_module(name, weights=weights, dtype=dtype, imgsz=imgsz, device=device)
    if name.startswith("mobile_sam"):
        from sar_yolo_tpu_torch.models.sam.tiny_vit import build_mobile_sam
        return build_mobile_sam(name, weights=weights, dtype=dtype, imgsz=imgsz, device=device)
    if name not in SAM_CONFIGS:
        names = sorted(SAM_CONFIGS) + sorted(MOBILE_SAM_CONFIGS) + sorted(SAM2_CONFIGS)
        raise ValueError(f"unknown SAM variant '{model}'; choose from {names}")
    cfg = dict(SAM_CONFIGS[name])
    img_size = imgsz or cfg.pop("img_size", 1024)
    cfg.pop("img_size", None)
    return _finish(SAMModel(img_size=img_size, **cfg), name, weights, dtype, device)


def build_sam2_module(name: str, weights=None, dtype=torch.float32, imgsz: int | None = None,
                      device=None):
    """(SAM2Model in eval mode on `device`, info dict) of a SAM2_CONFIGS name."""
    if name not in SAM2_CONFIGS:
        raise ValueError(f"unknown SAM2 variant '{name}'; choose from {sorted(SAM2_CONFIGS)}")
    cfg = dict(SAM2_CONFIGS[name])
    img_size = imgsz or cfg.pop("img_size", 1024)
    cfg.pop("img_size", None)
    return _finish(SAM2Model(img_size=img_size, **cfg), name, weights, dtype, device)


def _finish(module, name: str, weights, dtype, device):
    _load_or_init(module, weights, name)
    module = module.to(device=device, dtype=dtype).eval()
    return module, {"name": name, "img_size": module.img_size,
                    "is_sam2": isinstance(module, SAM2Model)}


def init_sam_weights(module, generator: torch.Generator):
    """Seeded random weights: each matrix and conv kernel uniform in +-1/sqrt(fan_in) (the JAX
    conv init's range), biases, the position tables, the attention biases and SAM2's layer
    scales, `no_mem_embed` and temporal table normal(0, 0.02), norm scales 1, the prompt
    embeddings, tokens and the Fourier matrix normal(0, 1)."""
    unit = {"gaussian_matrix", "point_embeddings", "not_a_point_embed", "no_mask_embed",
            "iou_token", "mask_tokens", "obj_score_token"}
    with torch.no_grad():
        for pname, p in module.named_parameters():
            leaf = pname.rsplit(".", 1)[-1]
            owner = module.get_submodule(pname.rsplit(".", 1)[0]) if "." in pname else module
            if leaf in unit:
                p.copy_(torch.randn(p.shape, generator=generator))
            elif isinstance(owner, (torch.nn.LayerNorm, torch.nn.BatchNorm2d)):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "weight":
                fan_in = p[0].numel() if not isinstance(owner, torch.nn.ConvTranspose2d) \
                    else p.shape[0] * p[0, 0].numel()
                p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) / fan_in ** 0.5)
            else:  # biases, rel_pos_*, pos_embed*, attention_biases, gamma, SAM2's tables
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)


def _load_or_init(module, weights, name: str):
    if weights is None:
        LOGGER.info(f"SAM '{name}': seeded random weights (no checkpoint is bundled)")
        init_sam_weights(module, torch.Generator().manual_seed(0))
        return
    p = Path(weights)
    if not (p.is_file() and p.suffix in {".pt", ".pth"}):
        raise FileNotFoundError(f"SAM weights '{weights}' not found or not a .pt / .pth file")
    sd = torch.load(p, map_location="cpu", weights_only=True)
    own = module.state_dict()
    if set(sd) != set(own):  # not saved by this package: a Meta / Ultralytics state dict
        from sar_yolo_tpu_torch.models.sam.convert import (translate_sam2_state_dict,
                                                           translate_sam_state_dict)
        translate = (translate_sam2_state_dict if isinstance(module, SAM2Model)
                     else translate_sam_state_dict)
        sd, skipped = translate(sd)
        if skipped:
            LOGGER.warning(f"SAM convert: {len(skipped)} unmapped keys (first: {skipped[:4]})")
        for key in own:  # a checkpoint without BatchNorm's step counter
            if key.endswith("num_batches_tracked"):
                sd.setdefault(key, torch.zeros((), dtype=torch.long))
        LOGGER.info(f"SAM '{name}': converted checkpoint {p.name}")
    module.load_state_dict(sd, strict=True)
