"""SAM2's image path in the PyTorch port against the JAX package, at the JAX tests' `sam2_test`
size (img 128, Hiera embed 16, stages (1, 1, 2, 1), global attention at block 3, windows 4,
a 4 x 4 background position table; d_model 256, mem_dim 64, 7 memory slots; float32;
numpy-seeded weights bridged from JAX's variables and numpy-seeded inputs).

(a) `_interp_matrix_torch_bicubic` equals JAX's bit for bit; `_axial_rope` within 1e-6;
(b) within 2e-4 (the SAM tests' limit; IoU predictions within 1e-4): Hiera's four maps at
128 px and at 96 px, the FPN neck (its features and position maps), `encode` (the embedding
with `no_mem_embed`, the raw one, both high-resolution maps), `decode` of points, boxes,
both, and a mask prompt (masks, IoU, mask tokens, object score), the whole model's call;
(c) `SAMPredictor.prompt_inference` through `SAM("sam2_test")` against JAX's predictor: masks
equal wherever JAX's logit is not within 1e-4 of 0, scores within 1e-4;
(d) the `.pth` route: a state dict with Meta's SAM2 keys and shapes (the object-pointer keys
of SAM2_UNMAPPED_OK included), translated by the port and by JAX then bridged, every tensor
equal, no key skipped; `build_sam(weights=...)` of it and of a state dict saved by the port;
(e) the parameter counts of sam2_t / s / b / l against JAX's `jax.eval_shape` of `init_all`.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.models.sam.build import SAM2_CONFIGS as JAX_SAM2_CONFIGS
from sar_yolo_tpu.models.sam.convert import SAM2_UNMAPPED_OK
from sar_yolo_tpu.models.sam.convert import translate_sam2_state_dict as jax_translate2
from sar_yolo_tpu.models.sam.modules2 import SAM2Model as JaxSAM2Model
from sar_yolo_tpu.models.sam.modules2 import _axial_rope as jax_axial_rope
from sar_yolo_tpu.models.sam.modules2 import \
    _interp_matrix_torch_bicubic as jax_bicubic_matrix
from sar_yolo_tpu.models.sam.predict import SAMPredictor as JaxSAMPredictor
from sar_yolo_tpu_torch.models.sam import build_sam
from sar_yolo_tpu_torch.models.sam.build import SAM2_CONFIGS
from sar_yolo_tpu_torch.models.sam.convert import translate_sam2_state_dict
from sar_yolo_tpu_torch.models.sam.modules2 import (SAM2Model, _axial_rope,
                                                    _interp_matrix_torch_bicubic)
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from test_torch_port_sam import (ATOL, INFER, IOU_TOL, _assert_masks_match, _frame, _jax_logits,
                                 _nhwc, port_sam)
from torch_port_common import fill_variables, one_torch_thread  # noqa: F401 (autouse fixture)


def _jax_module(name: str):
    cfg = dict(JAX_SAM2_CONFIGS[name])
    S = cfg.pop("img_size", 1024)
    return JaxSAM2Model(img_size=S, **cfg), S


def jax_sam2_shapes(name: str):
    """(JAX SAM2Model, its variables' shapes from `eval_shape` of `init_all`)."""
    module, S = _jax_module(name)
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), points=jnp.zeros((1, 1, 2)),
        labels=jnp.ones((1, 1)), masks=jnp.zeros((1, S // 4, S // 4, 1)), method="init_all"))
    return module, shapes


def jax_sam2(seed: int = 0):
    """(JAX sam2_test module, numpy-filled variables)."""
    module, shapes = jax_sam2_shapes("sam2_test")
    return module, fill_variables(shapes, np.random.default_rng(seed))


@pytest.fixture(scope="module")
def models():
    module, variables = jax_sam2()
    return module, variables, port_sam("sam2_test", variables)


def _img(side: int, seed: int):
    return np.random.default_rng(seed).integers(0, 256, (1, side, side, 3)).astype(np.float32)


# ---- (a) the bicubic matrices and the rotary embedding ------------------------------------

@pytest.mark.parametrize("n_in,n_out", [(14, 256), (4, 32), (14, 64), (7, 24), (4, 4), (32, 20)])
def test_bicubic_matrix_equals_jax(n_in, n_out):
    np.testing.assert_array_equal(_interp_matrix_torch_bicubic(n_in, n_out),
                                  np.asarray(jax_bicubic_matrix(n_in, n_out)))


@pytest.mark.parametrize("h,w,nh,hd", [(8, 8, 1, 256), (6, 10, 2, 32), (64, 64, 1, 256)])
def test_axial_rope_matches_jax(h, w, nh, hd):
    x = np.random.default_rng(h * w).standard_normal((2, h * w, nh, hd)).astype(np.float32)
    want = np.asarray(jax_axial_rope(jnp.asarray(x), h, w))
    got = _axial_rope(torch.from_numpy(x), h, w).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---- (b) the modules ---------------------------------------------------------------------

def test_bridge_maps_every_sam2_leaf(models):
    _, variables, sam = models
    bridged = from_jax_variables(variables)
    own = sam.model.state_dict()
    assert set(bridged) == set(own)
    assert all(bridged[k].shape == own[k].shape for k in own)


@pytest.mark.parametrize("side", [128, 96])
def test_hiera_matches_jax(models, side):
    module, variables, sam = models
    img = _img(side, side)
    want = jax.jit(lambda v, x: module.apply(v, x, method=lambda m, x: m.trunk(m.preprocess(x))))(
        variables, jnp.asarray(img))
    with torch.no_grad():
        got = sam.model.trunk(sam.model.preprocess(torch.from_numpy(img)))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape[1] == 16 * 2 ** i and g.shape[2] == side // 4 // 2 ** i
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=ATOL, err_msg=f"stage {i}")


def test_fpn_neck_matches_jax(models):
    module, variables, sam = models
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((2, 32 // 2 ** i, 32 // 2 ** i, 16 * 2 ** i)).astype(np.float32)
          for i in range(4)]
    feats, pos = module.apply(variables, [jnp.asarray(x) for x in xs],
                              method=lambda m, xs: m.neck(xs))
    with torch.no_grad():
        pf, pp = sam.model.neck([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs])
    for i in range(4):
        np.testing.assert_allclose(_nhwc(pf[i]), np.asarray(feats[i]), atol=ATOL)
        np.testing.assert_allclose(_nhwc(pp[i]), np.asarray(pos[i]), atol=1e-6)


def test_encode_matches_jax(models):
    module, variables, sam = models
    img = _img(128, 7)
    want = jax.jit(lambda v, x: module.apply(v, x, method="encode"))(variables, jnp.asarray(img))
    with torch.no_grad():
        got = sam.model.encode(torch.from_numpy(img))
    for key in ("image_embed", "raw_embed"):
        assert got[key].shape == (1, 256, 8, 8)
        np.testing.assert_allclose(_nhwc(got[key]), np.asarray(want[key]), atol=ATOL, err_msg=key)
    for g, w, shape in zip(got["high_res_feats"], want["high_res_feats"],
                           [(1, 32, 32, 32), (1, 64, 16, 16)]):
        assert g.shape == shape
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=ATOL)


PROMPTS = {
    "points": dict(points=[[[40.0, 60.0], [100.5, 7.25]], [[3.0, 120.0], [0.0, 0.0]]],
                   labels=[[1.0, 0.0], [1.0, -1.0]]),
    "boxes": dict(boxes=[[20.0, 30.0, 90.0, 100.0], [0.0, 0.0, 127.0, 60.0]]),
    "points_boxes": dict(points=[[[40.0, 60.0]], [[10.0, 10.0]]], labels=[[1.0], [0.0]],
                         boxes=[[20.0, 30.0, 90.0, 100.0], [0.0, 0.0, 50.0, 60.0]]),
    "mask": dict(boxes=[[20.0, 30.0, 90.0, 100.0]], masks="random"),
}


def _features(seed: int):
    rng = np.random.default_rng(seed)
    return {"image_embed": rng.standard_normal((1, 8, 8, 256)).astype(np.float32),
            "high_res_feats": (rng.standard_normal((1, 32, 32, 32)).astype(np.float32),
                               rng.standard_normal((1, 16, 16, 64)).astype(np.float32))}


def _port_features(f: dict) -> dict:
    t = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    return {"image_embed": t(f["image_embed"]),
            "high_res_feats": tuple(t(a) for a in f["high_res_feats"])}


@pytest.mark.parametrize("kind", sorted(PROMPTS))
def test_decode_matches_jax(models, kind):
    module, variables, sam = models
    arrays = {}
    for k, v in PROMPTS[kind].items():
        if k == "masks":
            v = np.random.default_rng(3).standard_normal((len(PROMPTS[kind]["boxes"]), 32, 32, 1))
        arrays[k] = np.asarray(v, np.float32)
    feats = _features(5)
    want = jax.jit(lambda v, f, **k: module.apply(v, f, method="decode", **k))(
        variables, jax.tree.map(jnp.asarray, feats), **{k: jnp.asarray(v) for k, v in
                                                         arrays.items()})
    port = {k: torch.from_numpy(v) for k, v in arrays.items()}
    if "masks" in port:
        port["masks"] = port["masks"].permute(0, 3, 1, 2)
    with torch.no_grad():
        got = sam.model.decode(_port_features(feats), **port)
    B = len(next(iter(arrays.values())))
    shapes = [(B, 4, 32, 32), (B, 4), (B, 4, 256), (B, 1)]
    for g, w, shape, tol, what in zip(got, want, shapes, (ATOL, IOU_TOL, ATOL, ATOL),
                                      ("masks", "iou", "mask tokens", "object score")):
        assert g.shape == w.shape == shape, what
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, err_msg=what)


def test_sam2_model_call_matches_jax(models):
    module, variables, sam = models
    img = _img(128, 9)
    arrays = {k: np.asarray(v, np.float32) for k, v in PROMPTS["points_boxes"].items()}
    masks, iou, tok, obj = jax.jit(lambda v, x, **k: module.apply(v, x, **k))(
        variables, jnp.asarray(img), **{k: jnp.asarray(v) for k, v in arrays.items()})
    with torch.no_grad():
        pm, pi, pt, po = sam.model(torch.from_numpy(img),
                                   **{k: torch.from_numpy(v) for k, v in arrays.items()})
    np.testing.assert_allclose(pm.numpy(), np.asarray(masks), atol=ATOL)
    np.testing.assert_allclose(pi.numpy(), np.asarray(iou), atol=IOU_TOL)
    np.testing.assert_allclose(pt.numpy(), np.asarray(tok), atol=ATOL)
    np.testing.assert_allclose(po.numpy(), np.asarray(obj), atol=ATOL)


# ---- (c) the image predictor ----------------------------------------------------------

@pytest.fixture(scope="module")
def predictors(models):
    module, variables, sam = models
    return JaxSAMPredictor(module, variables, imgsz=128), sam.predictor


@pytest.mark.parametrize("kind", sorted(INFER))
@pytest.mark.parametrize("hw", [(96, 160), (60, 100)], ids=["enlarge", "shrink"])
def test_prompt_inference_matches_jax(predictors, monkeypatch, hw, kind):
    jp, pp = predictors
    img = _frame(*hw, seed=hw[0])
    jp.set_image(img)
    pp.set_image(img)
    captured = []
    orig = jp._masks_to_original
    monkeypatch.setattr(jp, "_masks_to_original",
                        lambda low: captured.append(low) or orig(low))
    jm, js = jp.prompt_inference(**INFER[kind])
    pm, ps = pp.prompt_inference(**INFER[kind])
    _assert_masks_match(pm, _jax_logits(jp, captured[0]), f"{hw} {kind}")
    np.testing.assert_allclose(ps, js, atol=IOU_TOL)


def test_facade_call_and_generate_run(models):
    sam = models[2]
    img = _frame(96, 160, seed=11)
    res = sam(img, bboxes=[[10, 10, 80, 50], [30, 5, 90, 55]])[0]
    assert res.masks.data.shape == (2, 96, 160) and res.boxes.data.shape == (2, 6)
    masks, scores, boxes = sam.predictor.generate(points_per_side=4, points_per_batch=8,
                                                  conf=0.0, stability_thresh=0.0)
    assert masks.shape[1:] == (96, 160) and len(scores) == len(boxes) == len(masks)


# ---- (d) the .pth route -------------------------------------------------------------

_TO_META = [  # the port's names -> Meta's (sam2 / ultralytics SAM2 modules)
    (r"^trunk\.patch_embed\.", "image_encoder.trunk.patch_embed.proj."),
    (r"^trunk\.block_(\d+)\.mlp_lin1\.", r"image_encoder.trunk.blocks.\1.mlp.layers.0."),
    (r"^trunk\.block_(\d+)\.mlp_lin2\.", r"image_encoder.trunk.blocks.\1.mlp.layers.1."),
    (r"^trunk\.block_(\d+)\.", r"image_encoder.trunk.blocks.\1."),
    (r"^trunk\.", "image_encoder.trunk."),
    (r"^neck\.conv_(\d+)\.", r"image_encoder.neck.convs.\1.conv."),
    (r"^hr_proj(\d)\.", r"sam_mask_decoder.conv_s\1."),
    (r"^sam_prompt_encoder\.pe_layer\.gaussian_matrix$",
     "sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
    (r"^sam_prompt_encoder\.(not_a_point_embed|no_mask_embed)$", r"sam_prompt_encoder.\1.weight"),
    (r"^sam_prompt_encoder\.mask_conv1\.", "sam_prompt_encoder.mask_downscaling.0."),
    (r"^sam_prompt_encoder\.mask_ln1\.", "sam_prompt_encoder.mask_downscaling.1."),
    (r"^sam_prompt_encoder\.mask_conv2\.", "sam_prompt_encoder.mask_downscaling.3."),
    (r"^sam_prompt_encoder\.mask_ln2\.", "sam_prompt_encoder.mask_downscaling.4."),
    (r"^sam_prompt_encoder\.mask_conv3\.", "sam_prompt_encoder.mask_downscaling.6."),
    (r"transformer\.layer_(\d+)\.mlp_lin1\.", r"transformer.layers.\1.mlp.layers.0."),
    (r"transformer\.layer_(\d+)\.mlp_lin2\.", r"transformer.layers.\1.mlp.layers.1."),
    (r"transformer\.layer_(\d+)\.", r"transformer.layers.\1."),
    (r"^sam_mask_decoder\.(iou_token|mask_tokens|obj_score_token)$", r"sam_mask_decoder.\1.weight"),
    (r"^sam_mask_decoder\.upscale_conv1\.", "sam_mask_decoder.output_upscaling.0."),
    (r"^sam_mask_decoder\.upscale_ln\.", "sam_mask_decoder.output_upscaling.1."),
    (r"^sam_mask_decoder\.upscale_conv2\.", "sam_mask_decoder.output_upscaling.3."),
    (r"^sam_mask_decoder\.hyper_mlp_(\d+)\.l(\d+)\.",
     r"sam_mask_decoder.output_hypernetworks_mlps.\1.layers.\2."),
    (r"^sam_mask_decoder\.iou_head\.l(\d+)\.", r"sam_mask_decoder.iou_prediction_head.layers.\1."),
    (r"^sam_mask_decoder\.obj_score_head\.l(\d+)\.",
     r"sam_mask_decoder.pred_obj_score_head.layers.\1."),
    (r"^memory_attention\.layer_(\d+)\.", r"memory_attention.layers.\1."),
    (r"^memory_encoder\.mask_downsampler\.conv_(\d)\.",
     lambda m: f"memory_encoder.mask_downsampler.encoder.{3 * int(m[1])}."),
    (r"^memory_encoder\.mask_downsampler\.ln_(\d)\.",
     lambda m: f"memory_encoder.mask_downsampler.encoder.{3 * int(m[1]) + 1}."),
    (r"^memory_encoder\.mask_downsampler\.proj\.", "memory_encoder.mask_downsampler.encoder.12."),
    (r"^memory_encoder\.fuser_(\d+)\.", r"memory_encoder.fuser.layers.\1."),
]
_META_EXTRA = {  # keys the JAX package drops by design (SAM2_UNMAPPED_OK) and the constants
    "obj_ptr_proj.layers.0.weight": (256, 256), "obj_ptr_proj.layers.0.bias": (256,),
    "obj_ptr_tpos_proj.weight": (64, 256), "obj_ptr_tpos_proj.bias": (64,),
    "no_obj_ptr": (1, 256), "no_obj_embed_spatial": (1, 64),
    "mask_downsample.weight": (1, 1, 4, 4), "mask_downsample.bias": (1,),
    "pixel_mean": (3, 1, 1), "pixel_std": (3, 1, 1),
}


def meta_sam2_state_dict(model, seed: int) -> dict:
    """A seeded state dict with Meta's SAM2 keys and shapes for the port's `model`
    configuration: 4 point embeddings as nn.Embedding(1, C), the vectors and tokens as
    Embedding weights, Hiera's tables (1, C, h, w), and the keys of _META_EXTRA."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, t in model.state_dict().items():
        if key == "sam_prompt_encoder.point_embeddings":
            for i in range(t.shape[0]):
                out[f"sam_prompt_encoder.point_embeddings.{i}.weight"] = (1, t.shape[1])
            continue
        meta = key
        for pat, rep in _TO_META:
            meta = re.sub(pat, rep, meta)
        shape = tuple(t.shape)
        if meta.endswith(("_embed.weight", "iou_token.weight", "obj_score_token.weight")):
            shape = (1, t.numel()) if t.ndim == 1 else shape
        elif meta.startswith("image_encoder.trunk.pos_embed"):
            shape = (1, shape[3], shape[1], shape[2])
        out[meta] = shape
    out.update(_META_EXTRA)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in out.items()}


def test_translate_sam2_state_dict_matches_jax(models):
    model = models[2].model
    meta = meta_sam2_state_dict(model, seed=4)
    assert meta["image_encoder.trunk.pos_embed"].shape == (1, 16, 4, 4)
    assert meta["memory_encoder.mask_downsampler.encoder.12.weight"].shape == (256, 256, 1, 1)
    assert meta["memory_attention.layers.0.cross_attn_image.k_proj.weight"].shape == (256, 64)
    port, skipped = translate_sam2_state_dict(meta)
    jvars, jskipped = jax_translate2(meta)
    assert not skipped and not jskipped, (skipped[:4], jskipped[:4])
    bridged = from_jax_variables(jvars)
    own = model.state_dict()
    assert set(port) == set(bridged) == set(own)
    for key in own:
        assert port[key].shape == own[key].shape, key
        assert torch.equal(port[key], bridged[key]), key
    dropped = {k for k in meta if k.split(".")[0].startswith(SAM2_UNMAPPED_OK)}
    assert len(dropped) == 8
    port, skipped = translate_sam2_state_dict({"model": {**meta, "unknown.weight": meta[
        "no_mem_embed"]}})   # the {"model": ...} wrapper; an unknown key is reported
    assert skipped == ["unknown.weight"] and set(port) == set(own)


def test_build_sam2_loads_pth_and_port_checkpoint(models, tmp_path):
    meta = meta_sam2_state_dict(models[2].model, seed=6)
    path = tmp_path / "sam2_test.pth"
    torch.save(meta, path)
    model, info = build_sam("sam2_test", weights=path, device="cpu")
    want, _ = translate_sam2_state_dict(meta)
    assert info == {"name": "sam2_test", "img_size": 128, "is_sam2": True}
    assert all(torch.equal(model.state_dict()[k], want[k]) for k in want)
    own = tmp_path / "port.pt"
    torch.save(model.state_dict(), own)
    again, _ = build_sam("sam2_test.pt", weights=own, device="cpu")
    assert all(torch.equal(again.state_dict()[k], v) for k, v in model.state_dict().items())


# ---- (e) the published sizes ----------------------------------------------------------

@pytest.mark.parametrize("name", ["sam2_t", "sam2_s", "sam2_b", "sam2_l", "sam2_test"])
def test_parameter_count_matches_jax(name):
    _, shapes = jax_sam2_shapes(name)
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    cfg = dict(SAM2_CONFIGS[name])
    with torch.device("meta"):
        model = SAM2Model(img_size=cfg.pop("img_size", 1024), **cfg)
    assert sum(p.numel() for p in model.parameters()) == want
