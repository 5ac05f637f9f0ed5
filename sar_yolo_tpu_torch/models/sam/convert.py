"""Meta / Ultralytics SAM, MobileSAM and SAM2 state dicts -> this package's SAM modules (port
of `sar_yolo_tpu/models/sam/convert.py`).

Both sides are PyTorch, so tensors keep their layout; the keys are renamed to the Flax scope
names the port's modules carry, and four tensors change shape:

    prompt_encoder.point_embeddings.{0..3}.weight (1, C) -> prompt_encoder.point_embeddings (4, C)
    prompt_encoder.{not_a_point_embed, no_mask_embed}.weight (1, C) -> (C,)
    prompt_encoder.pe_layer.positional_encoding_gaussian_matrix -> pe_layer.gaussian_matrix
    mask_decoder.{iou_token, mask_tokens}.weight -> mask_decoder.{iou_token, mask_tokens}

`pixel_mean` / `pixel_std` are constants of `SAMModel.preprocess`, and TinyViT's
classification head (`head`, `norm_head`) is unused by SAM: both are dropped by design. Any
other key that no rule maps is returned in `skipped`.

SAM2 (`translate_sam2_state_dict`): Hiera's two position tables go from (1, C, h, w) to the
port's (1, h, w, C); the decoder's `conv_s0` / `conv_s1` are the model's `hr_proj0` /
`hr_proj1`; the keys of SAM2_UNMAPPED_OK (object pointers and the mask-as-output shortcut,
which the JAX package does not carry) are dropped by design.
"""

from __future__ import annotations

import re

import torch

_NECK = {"0": "neck_conv1", "1": "neck_ln1", "2": "neck_conv2", "3": "neck_ln2"}
_MASK_DOWN = {"0": "mask_conv1", "1": "mask_ln1", "3": "mask_conv2", "4": "mask_ln2",
              "6": "mask_conv3"}
_UPSCALE = {"0": "upscale_conv1", "1": "upscale_ln", "3": "upscale_conv2"}
_DROPPED = re.compile(r"^(pixel_mean|pixel_std|image_encoder\.(head|norm_head)\..*)$")


def _vit_key(rest: str) -> str | None:
    """An ImageEncoderViT key (after 'image_encoder.') -> the port's name."""
    if rest == "pos_embed":
        return rest
    if m := re.fullmatch(r"patch_embed\.proj\.(weight|bias)", rest):
        return f"patch_embed.{m[1]}"
    if m := re.fullmatch(r"blocks\.(\d+)\.(norm[12]\.(?:weight|bias)|attn\.(?:rel_pos_[hw]|"
                         r"(?:qkv|proj)\.(?:weight|bias))|mlp\.lin[12]\.(?:weight|bias))", rest):
        return f"block_{m[1]}.{m[2]}"
    if m := re.fullmatch(r"neck\.([0-3])\.(weight|bias)", rest):
        return f"{_NECK[m[1]]}.{m[2]}"
    return None


_CONVBN = r"((?:c\.weight)|(?:bn\.(?:weight|bias|running_mean|running_var|num_batches_tracked)))"


def _tiny_key(rest: str) -> str | None:
    """A TinyViT key (after 'image_encoder.') -> the port's name."""
    if m := re.fullmatch(rf"patch_embed\.seq\.([02])\.{_CONVBN}", rest):
        return f"pe_conv{1 if m[1] == '0' else 2}.{m[2]}"
    if m := re.fullmatch(rf"layers\.(\d+)\.downsample\.(conv[123])\.{_CONVBN}", rest):
        return f"merge{int(m[1]) + 1}.{m[2]}.{m[3]}"
    if m := re.fullmatch(rf"layers\.0\.blocks\.(\d+)\.(conv[123])\.{_CONVBN}", rest):
        return f"s0_mb{m[1]}.{m[2]}.{m[3]}"
    if m := re.fullmatch(r"layers\.([1-3])\.blocks\.(\d+)\.(.+)", rest):
        blk, sub = f"s{m[1]}_blk{m[2]}", m[3]
        if re.fullmatch(r"attn\.(attention_biases|(norm|qkv|proj)\.(weight|bias))", sub):
            return f"{blk}.{sub}"
        if n := re.fullmatch(rf"local_conv\.{_CONVBN}", sub):
            return f"{blk}.local_conv.{n[1]}"
        if n := re.fullmatch(r"mlp\.(norm|fc1|fc2)\.(weight|bias)", sub):
            return f"{blk}.mlp_{n[1]}.{n[2]}"
        return None
    if m := re.fullmatch(r"neck\.([0-3])\.(weight|bias)", rest):
        return f"{_NECK[m[1]]}.{m[2]}"
    return None


def _two_way_key(rest: str) -> str | None:
    """A TwoWayTransformer key (after 'mask_decoder.transformer.') -> the port's name; the MLP
    may be SAM's `mlp.lin{1,2}` or SAM2's `mlp.layers.{0,1}`."""
    attn = r"(?:self_attn|cross_attn_token_to_image|cross_attn_image_to_token)"
    if m := re.fullmatch(rf"layers\.(\d+)\.({attn}\.(?:q|k|v|out)_proj\.(?:weight|bias)|"
                         r"norm[1-4]\.(?:weight|bias))", rest):
        return f"layer_{m[1]}.{m[2]}"
    if m := re.fullmatch(r"layers\.(\d+)\.mlp\.(?:lin([12])|layers\.([01]))\.(weight|bias)", rest):
        n = m[2] or str(int(m[3]) + 1)
        return f"layer_{m[1]}.mlp_lin{n}.{m[4]}"
    if re.fullmatch(r"final_attn_token_to_image\.(q|k|v|out)_proj\.(weight|bias)|"
                    r"norm_final_attn\.(weight|bias)", rest):
        return rest
    return None


def _decoder_key(rest: str) -> str | None:
    """A MaskDecoder key (after 'mask_decoder.') -> the port's name."""
    if rest.startswith("transformer."):
        key = _two_way_key(rest[len("transformer."):])
        return key and f"transformer.{key}"
    if m := re.fullmatch(r"(iou_token|mask_tokens)\.weight", rest):
        return m[1]
    if m := re.fullmatch(r"output_upscaling\.([013])\.(weight|bias)", rest):
        return f"{_UPSCALE[m[1]]}.{m[2]}"
    if m := re.fullmatch(r"output_hypernetworks_mlps\.(\d+)\.layers\.(\d+)\.(weight|bias)", rest):
        return f"hyper_mlp_{m[1]}.l{m[2]}.{m[3]}"
    if m := re.fullmatch(r"iou_prediction_head\.layers\.(\d+)\.(weight|bias)", rest):
        return f"iou_head.l{m[1]}.{m[2]}"
    return None


def translate_sam_state_dict(state_dict, verbose: bool = False):
    """(the port's state dict, skipped keys) of a Meta `.pth` layout (flat state dict) or a
    {'model': module_or_state_dict} wrapper; MobileSAM (TinyViT encoder, `image_encoder.layers.*`)
    is detected by its keys."""
    if isinstance(state_dict, dict) and "model" in state_dict and not any(
            k.startswith(("image_encoder", "prompt_encoder", "mask_decoder")) for k in state_dict):
        inner = state_dict["model"]
        state_dict = inner.state_dict() if hasattr(inner, "state_dict") else inner
    is_tiny = any(k.startswith("image_encoder.layers.") for k in state_dict)
    out: dict[str, torch.Tensor] = {}
    skipped: list[str] = []
    point_rows: dict[int, torch.Tensor] = {}
    for key, t in state_dict.items():
        t = torch.as_tensor(t).detach().cpu()
        top, _, rest = key.partition(".")
        new = None
        if _DROPPED.match(key):
            continue
        if top == "image_encoder":
            new = (_tiny_key if is_tiny else _vit_key)(rest)
        elif top == "prompt_encoder":
            if m := re.fullmatch(r"point_embeddings\.(\d+)\.weight", rest):
                point_rows[int(m[1])] = t.reshape(-1)
                continue
            if m := re.fullmatch(r"(not_a_point_embed|no_mask_embed)\.weight", rest):
                new, t = m[1], t.reshape(-1)
            elif rest == "pe_layer.positional_encoding_gaussian_matrix":
                new = "pe_layer.gaussian_matrix"
            elif m := re.fullmatch(r"mask_downscaling\.([01346])\.(weight|bias)", rest):
                new = f"{_MASK_DOWN[m[1]]}.{m[2]}"
        elif top == "mask_decoder":
            new = _decoder_key(rest)
        if new is None:
            skipped.append(key)
        else:
            out[f"{top}.{new}"] = t
    if point_rows:
        out["prompt_encoder.point_embeddings"] = torch.stack(
            [point_rows[i] for i in sorted(point_rows)])
    if verbose and skipped:
        print(f"translate_sam_state_dict: {len(skipped)} unmapped keys: {skipped[:8]}")
    return out, skipped


# object-pointer tokens (sam.py obj_ptr_proj / obj_ptr_tpos_proj ...) and the mask-input-as-
# output shortcut (mask_downsample): the JAX package's video memory does not carry them
SAM2_UNMAPPED_OK = ("obj_ptr_proj", "obj_ptr_tpos_proj", "no_obj_ptr",
                    "no_obj_embed_spatial", "mask_downsample", "no_mem_pos_enc")
_WB = r"(weight|bias)"


def _sam2_trunk_key(rest: str) -> str | None:
    """A Hiera key (after 'image_encoder.trunk.') -> the port's name (after 'trunk.')."""
    if rest in ("pos_embed", "pos_embed_window"):
        return rest
    if m := re.fullmatch(rf"patch_embed\.proj\.{_WB}", rest):
        return f"patch_embed.{m[1]}"
    if m := re.fullmatch(rf"blocks\.(\d+)\.(norm[12]|attn\.qkv|attn\.proj|proj)\.{_WB}", rest):
        return f"block_{m[1]}.{m[2]}.{m[3]}"
    if m := re.fullmatch(rf"blocks\.(\d+)\.mlp\.layers\.([01])\.{_WB}", rest):
        return f"block_{m[1]}.mlp_lin{int(m[2]) + 1}.{m[3]}"
    return None


def _sam2_key(key: str) -> str | None:
    """A SAM2 key outside the prompt encoder -> the port's name."""
    if key in ("no_mem_embed", "maskmem_tpos_enc"):
        return key
    if key.startswith("image_encoder.trunk."):
        new = _sam2_trunk_key(key[len("image_encoder.trunk."):])
        return new and f"trunk.{new}"
    if m := re.fullmatch(rf"image_encoder\.neck\.convs\.(\d+)\.conv\.{_WB}", key):
        return f"neck.conv_{m[1]}.{m[2]}"
    if key.startswith("sam_mask_decoder."):
        rest = key[len("sam_mask_decoder."):]
        if m := re.fullmatch(rf"conv_s([01])\.{_WB}", rest):
            return f"hr_proj{m[1]}.{m[2]}"
        if m := re.fullmatch(r"(obj_score_token)\.weight", rest):
            return f"sam_mask_decoder.{m[1]}"
        if m := re.fullmatch(rf"pred_obj_score_head\.layers\.(\d+)\.{_WB}", rest):
            return f"sam_mask_decoder.obj_score_head.l{m[1]}.{m[2]}"
        new = _decoder_key(rest)
        return new and f"sam_mask_decoder.{new}"
    if m := re.fullmatch(rf"memory_attention\.layers\.(\d+)\.((?:self_attn|cross_attn_image)\."
                         rf"(?:q|k|v|out)_proj|linear[12]|norm[1-3])\.{_WB}", key):
        return f"memory_attention.layer_{m[1]}.{m[2]}.{m[3]}"
    if re.fullmatch(rf"memory_attention\.norm\.{_WB}", key):
        return key
    if m := re.fullmatch(rf"memory_encoder\.mask_downsampler\.encoder\.(\d+)\.{_WB}", key):
        i = int(m[1])
        name = "proj" if i == 12 else f"conv_{i // 3}" if i % 3 == 0 else f"ln_{i // 3}"
        return f"memory_encoder.mask_downsampler.{name}.{m[2]}"
    if re.fullmatch(rf"memory_encoder\.(pix_feat_proj|out_proj)\.{_WB}", key):
        return key
    if m := re.fullmatch(rf"memory_encoder\.fuser\.layers\.(\d+)\.(gamma|(?:dwconv|norm|"
                         rf"pwconv[12])\.{_WB})", key):
        return f"memory_encoder.fuser_{m[1]}.{m[2]}"
    return None


def translate_sam2_state_dict(state_dict, verbose: bool = False):
    """(the port's state dict, skipped keys) of a Meta SAM2 / SAM2.1 state dict (flat, or
    wrapped as {'model': module_or_state_dict}); SAM2_UNMAPPED_OK keys and the pixel
    constants are dropped without a mention."""
    if isinstance(state_dict, dict) and "model" in state_dict and not any(
            "." in k for k in state_dict if isinstance(k, str)):
        inner = state_dict["model"]
        state_dict = inner.state_dict() if hasattr(inner, "state_dict") else inner
    out: dict[str, torch.Tensor] = {}
    skipped: list[str] = []
    point_rows: dict[int, torch.Tensor] = {}
    for key, t in state_dict.items():
        t = torch.as_tensor(t).detach().cpu()
        top, _, rest = key.partition(".")
        if top.startswith(SAM2_UNMAPPED_OK) or top in ("pixel_mean", "pixel_std"):
            continue
        new = None
        if top == "sam_prompt_encoder":
            if m := re.fullmatch(r"point_embeddings\.(\d+)\.weight", rest):
                point_rows[int(m[1])] = t.reshape(-1)
                continue
            if m := re.fullmatch(r"(not_a_point_embed|no_mask_embed)\.weight", rest):
                new, t = m[1], t.reshape(-1)
            elif rest == "pe_layer.positional_encoding_gaussian_matrix":
                new = "pe_layer.gaussian_matrix"
            elif m := re.fullmatch(rf"mask_downscaling\.([01346])\.{_WB}", rest):
                new = f"{_MASK_DOWN[m[1]]}.{m[2]}"
            new = new and f"{top}.{new}"
        else:
            new = _sam2_key(key)
            if new in ("trunk.pos_embed", "trunk.pos_embed_window"):
                t = t.permute(0, 2, 3, 1).contiguous()
        if new is None:
            skipped.append(key)
        else:
            out[new] = t
    if point_rows:
        out["sam_prompt_encoder.point_embeddings"] = torch.stack(
            [point_rows[i] for i in sorted(point_rows)])
    if verbose and skipped:
        print(f"translate_sam2_state_dict: {len(skipped)} unmapped keys: {skipped[:8]}")
    return out, skipped
