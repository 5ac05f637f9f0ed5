"""SAM of the PyTorch port against the JAX package, at the JAX tests' `sam_test` size (img 128,
embed 64, depth 2, global attention at block 1, prompt dim 32; float32; numpy-seeded weights
bridged from JAX's variables and numpy-seeded inputs).

(a) `ops/masks.py::resize_weights` equals JAX's `compute_weight_mat` bit for bit, and
`resize_linear` JAX's `jax.image.resize(..., "linear")` within 2e-5 (JAX's own float32 product
lies ~6e-6 from the exact one);
(b) the image encoder at 128 px and at 96 / 160 px (the position embedding and the global
block's rel-pos table resized with JAX's rule, antialiased where they shrink), the prompt
encoder (points with a negative and a pad label, boxes, points with boxes, a mask prompt) and
the mask decoder: embeddings and mask logits within 2e-4, IoU predictions within 1e-4;
(c) `SAMPredictor.prompt_inference` on a frame whose masks enlarge (96x160) and one whose
masks shrink (60x100) back to it: the masks equal wherever JAX's logit is not within 1e-4 of
0 (those pixels are counted and must be few), the scores within 1e-4; the Results of the
facade's call against the JAX predictor's;
(d) `generate` with thresholds in gaps of the scores (the hypernetworks' last layers scaled
by MASK_GAIN so that the masks have structure): the same survivors, scores within 1e-4,
boxes within 1 px;
(e) the `amg` helpers against JAX's on random masks, `remove_small_regions` against JAX's
(OpenCV's connected components);
(f) the `.pth` route: a state dict with Meta's `sam_test` keys and shapes, translated by the
port and by JAX then bridged, with no key skipped on either side and every tensor equal;
`build_sam(weights=...)` of it and of a state dict saved by the port.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

from sar_yolo_tpu.models.sam import amg as jax_amg
from sar_yolo_tpu.models.sam.build import SAM_CONFIGS as JAX_SAM_CONFIGS
from sar_yolo_tpu.models.sam.convert import translate_sam_state_dict as jax_translate
from sar_yolo_tpu.models.sam.modules import SAMModel as JaxSAMModel
from sar_yolo_tpu.models.sam.predict import SAMPredictor as JaxSAMPredictor
from sar_yolo_tpu_torch.models.sam import SAM, amg, build_sam
from sar_yolo_tpu_torch.models.sam.convert import translate_sam_state_dict
from sar_yolo_tpu_torch.ops.masks import resize_linear, resize_weights
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from torch_port_common import fill_variables, one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = 2e-4
IOU_TOL = 1e-4
LOGIT_MARGIN = 1e-4
MASK_GAIN = 100.0  # on the hypernetwork MLPs' last layers for (d)


def jax_sam(name: str, cfgs: dict, encoder: str = "vit", seed: int = 0):
    """(JAX SAMModel, numpy-filled variables) of a config, shapes from `eval_shape` (no init
    compile)."""
    cfg = dict(cfgs[name])
    S = cfg.pop("img_size")
    module = JaxSAMModel(img_size=S, encoder=encoder, **cfg)
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), points=jnp.zeros((1, 1, 2)),
        labels=jnp.ones((1, 1)), masks=jnp.zeros((1, S // 4, S // 4, 1))))
    return module, fill_variables(shapes, np.random.default_rng(seed))


def port_sam(name: str, variables) -> SAM:
    sam = SAM(name, device="cpu")
    sam.load_jax_variables(variables)
    return sam


@pytest.fixture(scope="module")
def models():
    module, variables = jax_sam("sam_test", JAX_SAM_CONFIGS)
    return module, variables, port_sam("sam_test", variables)


def _frame(h: int, w: int, seed: int, block: int = 4) -> np.ndarray:
    """A BGR uint8 frame of block x block tiles of seeded colours."""
    small = np.random.default_rng(seed).integers(0, 256, (h // block, w // block, 3),
                                                 dtype=np.uint8)
    return np.kron(small, np.ones((block, block, 1), np.uint8))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---- (a) JAX's resize rule ---------------------------------------------------------------

@pytest.mark.parametrize("n_in,n_out", [(8, 6), (15, 11), (27, 41), (77, 60), (128, 100),
                                        (256, 1024), (576, 720), (8, 10)])
def test_resize_weights_equal_jax(n_in, n_out):
    want = np.asarray(compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                         _fill_triangle_kernel, True))
    np.testing.assert_array_equal(resize_weights(n_in, n_out), want)


@pytest.mark.parametrize("shape,size", [((2, 77, 128), (60, 100)), ((2, 77, 128), (96, 160)),
                                        ((3, 8, 8), (6, 6))])
def test_resize_linear_matches_jax(shape, size):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (shape[0], *size), "linear"))
    np.testing.assert_allclose(resize_linear(torch.from_numpy(x), size).numpy(), want, atol=2e-5)


# ---- (b) encoder, prompt encoder, decoder ------------------------------------------------

def test_bridge_maps_every_sam_leaf(models):
    _, variables, sam = models
    bridged = from_jax_variables(variables)
    own = sam.model.state_dict()
    assert set(bridged) == set(own)
    assert all(bridged[k].shape == own[k].shape for k in own)


@pytest.mark.parametrize("side", [128, 96, 160])
def test_encoder_matches_jax(models, side):
    """At another input side JAX resizes the position embedding itself, while its global
    block declares a rel-pos table of the input's grid: it gets the 128 px table resized by
    `jax.image.resize`, which the port does inside `get_rel_pos`."""
    module, variables, sam = models
    jv = variables
    if side != 128:
        jv = jax.tree.map(np.copy, variables)
        attn = jv["params"]["image_encoder"]["block_1"]["attn"]
        for name in ("rel_pos_h", "rel_pos_w"):
            rows = 2 * (side // 16) - 1
            attn[name] = np.asarray(jax.image.resize(attn[name], (rows, 32), "linear"))
    img = np.random.default_rng(side).integers(0, 256, (1, side, side, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: module.apply(v, x, method="encode"))(
        jv, jnp.asarray(img)))
    with torch.no_grad():
        got = _nhwc(sam.model.encode(torch.from_numpy(img)))
    assert got.shape == (1, side // 16, side // 16, 32)
    np.testing.assert_allclose(got, want, atol=ATOL)


PROMPTS = {
    "points": dict(points=[[[40.0, 60.0], [100.5, 7.25]]], labels=[[1.0, 0.0]]),
    "points_pad": dict(points=[[[40.0, 60.0], [0.0, 0.0], [90, 30]], [[3, 120], [64, 64],
                                                                        [0, 0]]],
                       labels=[[1.0, -1.0, 0.0], [1.0, 1.0, -1.0]]),
    "boxes": dict(boxes=[[20.0, 30.0, 90.0, 100.0], [0.0, 0.0, 127.0, 60.0]]),
    "points_boxes": dict(points=[[[40.0, 60.0]], [[10.0, 10.0]]], labels=[[1.0], [0.0]],
                         boxes=[[20.0, 30.0, 90.0, 100.0], [0.0, 0.0, 50.0, 60.0]]),
    "mask": dict(boxes=[[20.0, 30.0, 90.0, 100.0]], masks="random"),
}


def _prompt_arrays(kind: str, side: int = 128) -> dict:
    out = {}
    for k, v in PROMPTS[kind].items():
        if k == "masks":
            n = len(PROMPTS[kind]["boxes"])
            v = np.random.default_rng(3).standard_normal((n, side // 4, side // 4, 1))
        out[k] = np.asarray(v, np.float32)
    return out


def _port_prompts(arrays: dict) -> dict:
    out = {k: torch.from_numpy(v) for k, v in arrays.items()}
    if "masks" in out:
        out["masks"] = out["masks"].permute(0, 3, 1, 2)
    return out


@pytest.mark.parametrize("kind", sorted(PROMPTS))
def test_prompt_encoder_matches_jax(models, kind):
    module, variables, sam = models
    arrays = _prompt_arrays(kind)
    sparse, dense = module.apply(variables, method=lambda m, **k: m.prompt_encoder(**k),
                                 **{k: jnp.asarray(v) for k, v in arrays.items()})
    with torch.no_grad():
        ps, pd = sam.model.prompt_encoder(**_port_prompts(arrays))
    np.testing.assert_allclose(ps.numpy(), np.asarray(sparse), atol=ATOL)
    np.testing.assert_allclose(_nhwc(pd), np.asarray(dense), atol=ATOL)


@pytest.mark.parametrize("kind", sorted(PROMPTS))
def test_decoder_matches_jax(models, kind):
    module, variables, sam = models
    emb = np.random.default_rng(5).standard_normal((1, 8, 8, 32)).astype(np.float32)
    arrays = _prompt_arrays(kind)
    masks, iou = jax.jit(lambda v, e, **k: module.apply(v, e, method="decode", **k))(
        variables, jnp.asarray(emb), **{k: jnp.asarray(v) for k, v in arrays.items()})
    with torch.no_grad():
        pm, pi = sam.model.decode(torch.from_numpy(emb).permute(0, 3, 1, 2),
                                  **_port_prompts(arrays))
    assert pm.shape == masks.shape == (len(next(iter(arrays.values()))), 4, 32, 32)
    np.testing.assert_allclose(pm.numpy(), np.asarray(masks), atol=ATOL)
    np.testing.assert_allclose(pi.numpy(), np.asarray(iou), atol=IOU_TOL)


def test_sam_model_call_matches_jax(models):
    module, variables, sam = models
    img = np.random.default_rng(9).integers(0, 256, (1, 128, 128, 3)).astype(np.float32)
    arrays = _prompt_arrays("points")
    masks, iou = jax.jit(lambda v, x, **k: module.apply(v, x, **k))(
        variables, jnp.asarray(img), **{k: jnp.asarray(v) for k, v in arrays.items()})
    with torch.no_grad():
        pm, pi = sam.model(torch.from_numpy(img), **_port_prompts(arrays))
    np.testing.assert_allclose(pm.numpy(), np.asarray(masks), atol=ATOL)
    np.testing.assert_allclose(pi.numpy(), np.asarray(iou), atol=IOU_TOL)


# ---- (c) prompt_inference and the facade ------------------------------------------------

@pytest.fixture(scope="module")
def predictors(models):
    module, variables, sam = models
    return JaxSAMPredictor(module, variables, imgsz=128), sam.predictor


def _jax_logits(jp, low_res):
    """JAX's `_masks_to_original` before its threshold."""
    h, w, nh, nw = jp._im_meta
    n = low_res.shape[0]
    up = jax.image.resize(jnp.asarray(low_res), (n, jp.imgsz, jp.imgsz), "bilinear")
    return np.asarray(jax.image.resize(up[:, :nh, :nw], (n, h, w), "bilinear"))


def _assert_masks_match(got, want_logits, label: str, max_share: float = 1e-2):
    want = want_logits > 0
    assert got.shape == want.shape, label
    near = np.abs(want_logits) <= LOGIT_MARGIN
    assert not (got != want)[~near].any(), f"{label}: masks differ away from the margin"
    assert near.mean() <= max_share, f"{label}: {near.sum()} pixels within the margin"


INFER = {"points": dict(points=[[40, 30], [70, 50]]),
         "boxes": dict(bboxes=[[10, 10, 80, 50], [30, 5, 90, 55]]),
         "multimask": dict(points=[[[40, 30], [10, 5]]], labels=[[1, 0]],
                           multimask_output=True)}


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


def test_facade_results_match_jax(models, predictors):
    jp, _ = predictors
    sam = models[2]
    img = _frame(96, 160, seed=11)
    want = jp(img, bboxes=[[10, 10, 80, 50]])[0]
    got = sam(img, bboxes=[[10, 10, 80, 50]])[0]
    assert got.masks.data.shape == want.masks.data.shape == (1, 96, 160)
    assert (got.masks.data != want.masks.data).mean() < 1e-3
    np.testing.assert_allclose(got.boxes.data[:, 4], want.boxes.data[:, 4], atol=IOU_TOL)
    np.testing.assert_allclose(got.boxes.data[:, :4], want.boxes.data[:, :4], atol=1.0)
    assert set(got.speed) == {"preprocess", "inference", "postprocess"}
    sam.predictor.set_prompts({"points": [[40, 30]]})
    try:
        assert len(sam(img)[0].masks) == 1   # the stored prompt, not segment-everything
    finally:
        sam.predictor.set_prompts({})


# ---- (d) generate -----------------------------------------------------------------------

def _gap_threshold(values: np.ndarray, lo: int, hi: int) -> float:
    """The middle of the widest gap between the lo-th and hi-th largest values."""
    v = np.sort(values)[::-1][lo:hi + 1]
    i = int(np.argmax(v[:-1] - v[1:]))
    return float(v[i] + v[i + 1]) / 2


@pytest.fixture(scope="module")
def gained(models):
    """JAX and port predictors of the same weights with the hypernetworks' last layers scaled
    by MASK_GAIN."""
    module, variables, _ = models
    v = jax.tree.map(np.copy, variables)
    for i in range(4):
        layer = v["params"]["mask_decoder"][f"hyper_mlp_{i}"]["l2"]
        layer["kernel"] = layer["kernel"] * MASK_GAIN
        layer["bias"] = layer["bias"] * MASK_GAIN
    return JaxSAMPredictor(module, v, imgsz=128), port_sam("sam_test", v).predictor


@pytest.mark.parametrize("iou_thres,max_det", [(0.7, 300), (1.0, 40)])
def test_generate_matches_jax(gained, iou_thres, max_det):
    jp, pp = gained
    img = _frame(96, 160, seed=21, block=8)
    jp.set_image(img)
    pp.set_image(img)
    _, iou, stab, boxes = pp.score_grid(8, 16)
    ok = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    stab_thr = _gap_threshold(stab[ok], 20, 60)
    conf = _gap_threshold(iou[ok & (stab > stab_thr)], 10, 30)
    jp.iou_thres = pp.iou_thres = iou_thres
    kw = dict(points_per_side=8, points_per_batch=16, max_det=max_det, conf=conf,
              stability_thresh=stab_thr)
    jm, js, jb = jp.generate(**kw)
    pm, ps, pb = pp.generate(**kw)
    assert len(js) >= (2 if iou_thres == 1.0 else 1) and len(ps) == len(js)
    np.testing.assert_allclose(ps, js, atol=IOU_TOL)
    np.testing.assert_allclose(pb, jb, atol=1.0)
    assert pm.shape == jm.shape and (pm != jm).mean() < 2e-3
    assert set(pp.generate_ms) == {"score", "nms", "decode"}


# ---- (e) the amg helpers --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_amg_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((3, 5, 24, 20)) * 3).astype(np.float32)
    logits[0, 1] = -5.0                                   # an empty mask: a zero box
    t = torch.from_numpy(logits)
    np.testing.assert_array_equal(amg.stability_score(t).numpy(),
                                  np.asarray(jax_amg.stability_score(jnp.asarray(logits))))
    np.testing.assert_array_equal(amg.batched_mask_to_box(t > 0).numpy(),
                                  np.asarray(jax_amg.batched_mask_to_box(jnp.asarray(logits) > 0)))
    n = int(rng.integers(2, 40))
    np.testing.assert_array_equal(amg.build_point_grid(n), jax_amg.build_point_grid(n))


@pytest.mark.parametrize("mode", ["holes", "islands"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_remove_small_regions_matches_jax(mode, seed):
    rng = np.random.default_rng(seed)
    small = rng.random((int(rng.integers(4, 20)), int(rng.integers(4, 20)))) < 0.45
    mask = np.kron(small, np.ones((3, 3), bool))[1:, 2:]
    for area in (4, 10, 30, 1e9):
        got, changed = amg.remove_small_regions(mask, area, mode)
        want, jchanged = jax_amg.remove_small_regions(mask, area, mode)
        assert changed == jchanged
        np.testing.assert_array_equal(got, want)


# ---- (f) the .pth route --------------------------------------------------------------

_TO_META = [  # the port's names -> Meta's (segment_anything / ultralytics SAM modules)
    (r"image_encoder\.patch_embed\.", "image_encoder.patch_embed.proj."),
    (r"image_encoder\.block_(\d+)\.", r"image_encoder.blocks.\1."),
    (r"image_encoder\.pe_conv1\.", "image_encoder.patch_embed.seq.0."),
    (r"image_encoder\.pe_conv2\.", "image_encoder.patch_embed.seq.2."),
    (r"image_encoder\.s0_mb(\d+)\.", r"image_encoder.layers.0.blocks.\1."),
    (r"image_encoder\.merge(\d+)\.", lambda m: f"image_encoder.layers.{int(m[1]) - 1}.downsample."),
    (r"image_encoder\.s(\d)_blk(\d+)\.mlp_(norm|fc1|fc2)\.",
     r"image_encoder.layers.\1.blocks.\2.mlp.\3."),
    (r"image_encoder\.s(\d)_blk(\d+)\.", r"image_encoder.layers.\1.blocks.\2."),
    (r"image_encoder\.neck_conv1\.", "image_encoder.neck.0."),
    (r"image_encoder\.neck_ln1\.", "image_encoder.neck.1."),
    (r"image_encoder\.neck_conv2\.", "image_encoder.neck.2."),
    (r"image_encoder\.neck_ln2\.", "image_encoder.neck.3."),
    (r"prompt_encoder\.pe_layer\.gaussian_matrix$",
     "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
    (r"prompt_encoder\.(not_a_point_embed|no_mask_embed)$", r"prompt_encoder.\1.weight"),
    (r"prompt_encoder\.mask_conv1\.", "prompt_encoder.mask_downscaling.0."),
    (r"prompt_encoder\.mask_ln1\.", "prompt_encoder.mask_downscaling.1."),
    (r"prompt_encoder\.mask_conv2\.", "prompt_encoder.mask_downscaling.3."),
    (r"prompt_encoder\.mask_ln2\.", "prompt_encoder.mask_downscaling.4."),
    (r"prompt_encoder\.mask_conv3\.", "prompt_encoder.mask_downscaling.6."),
    (r"transformer\.layer_(\d+)\.mlp_lin(\d)\.", r"transformer.layers.\1.mlp.lin\2."),
    (r"transformer\.layer_(\d+)\.", r"transformer.layers.\1."),
    (r"mask_decoder\.(iou_token|mask_tokens)$", r"mask_decoder.\1.weight"),
    (r"mask_decoder\.upscale_conv1\.", "mask_decoder.output_upscaling.0."),
    (r"mask_decoder\.upscale_ln\.", "mask_decoder.output_upscaling.1."),
    (r"mask_decoder\.upscale_conv2\.", "mask_decoder.output_upscaling.3."),
    (r"mask_decoder\.hyper_mlp_(\d+)\.l(\d+)\.",
     r"mask_decoder.output_hypernetworks_mlps.\1.layers.\2."),
    (r"mask_decoder\.iou_head\.l(\d+)\.", r"mask_decoder.iou_prediction_head.layers.\1."),
]


def meta_state_dict(model, seed: int, tiny: bool = False) -> dict:
    """A seeded state dict with Meta's keys and shapes for the port's `model` configuration
    (its point embeddings as 4 nn.Embedding(1, C), its vectors as (1, C) Embedding weights,
    the pixel constants, and TinyViT's classification head)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, t in model.state_dict().items():
        if key == "prompt_encoder.point_embeddings":
            for i in range(t.shape[0]):
                out[f"prompt_encoder.point_embeddings.{i}.weight"] = t.new_empty(1, t.shape[1])
            continue
        meta = key
        for pat, rep in _TO_META:
            meta = re.sub(pat, rep, meta)
        out[meta] = t.reshape(1, -1) if meta.endswith(("_embed.weight",)) else t.clone()
    out["pixel_mean"] = torch.tensor([123.675, 116.28, 103.53]).view(3, 1, 1)
    out["pixel_std"] = torch.tensor([58.395, 57.12, 57.375]).view(3, 1, 1)
    if tiny:
        out["image_encoder.norm_head.weight"] = torch.ones(320)
        out["image_encoder.norm_head.bias"] = torch.zeros(320)
        out["image_encoder.head.weight"] = torch.zeros(1000, 320)
        out["image_encoder.head.bias"] = torch.zeros(1000)
    for key, t in out.items():
        if t.is_floating_point():
            shape = t.shape
            out[key] = torch.from_numpy(rng.standard_normal(tuple(shape)).astype(np.float32))
            if key.endswith("running_var"):
                out[key] = out[key].abs() + 0.5
    return out


def assert_translations_agree(meta: dict, model):
    port, skipped = translate_sam_state_dict(meta)
    jvars, jskipped = jax_translate(meta)
    assert not skipped and not jskipped, (skipped[:4], jskipped[:4])
    bridged = from_jax_variables(jvars)
    own = model.state_dict()
    assert set(port) == set(bridged) == set(own)
    for key in own:
        assert port[key].shape == own[key].shape, key
        assert torch.equal(port[key], bridged[key]), key


def test_translate_sam_state_dict_matches_jax(models):
    meta = meta_state_dict(models[2].model, seed=4)
    assert "image_encoder.blocks.1.attn.rel_pos_h" in meta
    assert meta["image_encoder.blocks.0.attn.rel_pos_h"].shape == (27, 32)   # 14 x 14 windows
    assert meta["mask_decoder.output_upscaling.0.weight"].shape == (32, 8, 2, 2)
    assert meta["prompt_encoder.not_a_point_embed.weight"].shape == (1, 32)
    assert_translations_agree(meta, models[2].model)
    port, _ = translate_sam_state_dict({"model": meta})  # the {"model": ...} wrapper
    assert set(port) == set(models[2].model.state_dict())


def test_build_sam_loads_pth_and_port_checkpoint(models, tmp_path):
    meta = meta_state_dict(models[2].model, seed=6)
    path = tmp_path / "sam_test.pth"
    torch.save(meta, path)
    model, info = build_sam("sam_test", weights=path, device="cpu")
    want, _ = translate_sam_state_dict(meta)
    assert info == {"name": "sam_test", "img_size": 128, "is_sam2": False}
    assert all(torch.equal(model.state_dict()[k], want[k]) for k in want)
    own = tmp_path / "port.pt"
    torch.save(model.state_dict(), own)
    again, _ = build_sam("sam_test.pt", weights=own, device="cpu")
    assert all(torch.equal(again.state_dict()[k], v) for k, v in model.state_dict().items())
    with pytest.raises(FileNotFoundError):
        build_sam("sam_test", weights=tmp_path / "missing.pth", device="cpu")
