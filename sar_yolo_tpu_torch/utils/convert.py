"""Weight bridge from the JAX package's variables to this package's state dicts.

The port names its submodules after the Flax scopes, so the map is mechanical:

    params/blocks_6/m0_0/attn/qk/conv/kernel  (1, 1, I/g, O)  -> blocks.6.m0_0.attn.qk.conv.weight (O, I/g, 1, 1)
    params/blocks_11/conv/kernel (transposed conv, (k, k, O, I)) -> blocks.11.conv.weight (I, O, k, k)
    params/.../state_fc1/kernel               (in, out)       -> ....state_fc1.weight (out, in)
    params/blocks_9/linear/kernel (Classify)  (in, out)       -> blocks.9.linear.weight (out, in)
    params/.../bn/{scale, bias}                               -> ....bn.{weight, bias}
    params/.../{norm1, enc_norm, query_ln, input_proj_bn_0, cv4_0_norm}/scale -> ....weight
    batch_stats/.../<BatchNorm>/{mean, var}                   -> ....{running_mean, running_var}
    params/.../{gate, gamma, prototype_base, embedding}       -> unchanged
    params/text_embeddings, params/blocks_22/cv4_0_{bias, logit_scale} -> unchanged
    SAM's tables, embeddings and tokens (rel_pos_h, pos_embed (1, g, g, C), gaussian_matrix,
    point_embeddings, iou_token, TinyViT's attention_biases, SAM2's pos_embed_window,
    obj_score_token, no_mem_embed, maskmem_tpos_enc, ...) -> unchanged

A transposed conv's kernel (Flax `ConvTranspose(transpose_kernel=True)`: the kernel of the
conv it is the gradient of) takes the same transpose, with no spatial flip. A v10 head's
one2one copy keeps its `o2o_` names. Each BatchNorm also gets torch's
`num_batches_tracked` counter (0). Unfused
and `fuse_variables`-fused trees both convert; `load_jax_variables` loads the
result with `strict=True`, so a key left over or missing on either side raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_SCALARS = {"gate", "gamma", "prototype_base", "embedding", "text_embeddings", "scale",
            # SAM (models/sam/): kept in their JAX layout by the port's modules
            "rel_pos_h", "rel_pos_w", "pos_embed", "gaussian_matrix", "point_embeddings",
            "not_a_point_embed", "no_mask_embed", "iou_token", "mask_tokens", "attention_biases",
            # SAM2's: Hiera's window table, the object-score token, the memory's tables
            "pos_embed_window", "obj_score_token", "no_mem_embed", "maskmem_tpos_enc"}
# BatchNorm / LayerNorm scopes (SAM's: neck_ln1, mask_ln2, upscale_ln, norm_final_attn; SAM2's
# mask downsampler: ln_0..ln_3)
_NORM_SCOPE = re.compile(r"(^bn$|norm\d*$|_ln\d*$|^ln_\d+$|_bn_\d+$|^norm_final_attn$)")
_HEAD_SCALAR = re.compile(r"^cv4_\d+_(bias|logit_scale)$")    # WorldDetect's contrastive heads


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, (*prefix, key))
        else:
            yield (*prefix, key), val


def _module_path(scope: tuple) -> str:
    return ".".join(re.sub(r"^blocks_(\d+)$", r"blocks.\1", s) for s in scope)


def from_jax_variables(variables) -> dict[str, torch.Tensor]:
    """{"params", "batch_stats"} tree of arrays -> torch state dict (float32 CPU tensors)."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"from_jax_variables: unexpected collections {sorted(unknown)}")
    out: dict[str, torch.Tensor] = {}
    for path, val in _flatten(variables.get("params", {})):
        arr = np.asarray(val, dtype=np.float32)
        *scope, leaf = path
        mod = _module_path(tuple(scope))
        if leaf == "kernel" and arr.ndim == 4:     # conv (kh, kw, I/g, O) -> (O, I/g, kh, kw)
            name, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and arr.ndim == 2:   # dense (in, out) -> (out, in)
            name, arr = "weight", arr.T
        elif leaf == "bias":
            name = "bias"
        elif leaf == "scale" and scope and _NORM_SCOPE.search(scope[-1]):
            name = "weight"
        elif leaf in _SCALARS or _HEAD_SCALAR.match(leaf):
            name = leaf
        else:
            raise KeyError(f"from_jax_variables: no rule for params/{'/'.join(path)}")
        out[f"{mod}.{name}" if mod else name] = torch.tensor(arr)
    for path, val in _flatten(variables.get("batch_stats", {})):
        *scope, leaf = path
        if leaf not in ("mean", "var") or not scope or not _NORM_SCOPE.search(scope[-1]):
            raise KeyError(f"from_jax_variables: no rule for batch_stats/{'/'.join(path)}")
        mod = _module_path(tuple(scope))
        out[f"{mod}.running_{leaf}"] = torch.tensor(np.asarray(val, dtype=np.float32))
        out[f"{mod}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return out
