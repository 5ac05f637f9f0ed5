"""MobileSAM, FastSAM and NAS of the PyTorch port against the JAX package (float32;
numpy-seeded weights and inputs).

(a) MobileSAM at the JAX tests' `mobile_sam_test` size (TinyViT dims 16/32/40/320, one block
a stage, 4 x 4 windows, img 128; the prompt heads at width 256), its BatchNorm statistics
bridged from JAX's batch_stats: the image embedding within 2e-4, decoded masks within 2e-4
and IoU within 1e-4 for points, boxes and a mask prompt, `prompt_inference` masks equal
wherever JAX's logit is not within 1e-4 of 0;
(b) the `.pth` route for a MobileSAM state dict with Meta's TinyViT keys (its classification
head included): the port's translation and JAX's (bridged) equal, no key skipped;
(c) FastSAM's box and point filters against JAX's `_prompt` on the same rows; text prompts
raise; FastSAM-s.yaml serves through the segment task with a box prompt (the plain YOLO
path's Results, filtered); NAS is a detect model whose `train` raises;
(d) the names and refusals: sam2_t and sam2.1_b.pt build SAM2 models on the CPU, unknown
SAM and SAM2 names raise ValueError, `SAM.track` of a SAM model ValueError, and SAM, FastSAM
and NAS raise without CUDA unless given device="cpu"; the packages (SAM2's modules included)
import neither JAX, the JAX package, cv2, PIL nor yaml.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.engine.results import Results as JaxResults
from sar_yolo_tpu.models.fastsam import FastSAM as JaxFastSAM
from sar_yolo_tpu.models.sam.predict import SAMPredictor as JaxSAMPredictor
from sar_yolo_tpu.models.sam.tiny_vit import MOBILE_SAM_CONFIGS as JAX_MOBILE_CONFIGS
from sar_yolo_tpu_torch import NAS, SAM, YOLO, FastSAM
from sar_yolo_tpu_torch.engine.results import Results
from test_torch_port_sam import (ATOL, IOU_TOL, _assert_masks_match, _frame, _jax_logits,
                                 _nhwc, assert_translations_agree, jax_sam, meta_state_dict,
                                 port_sam)
from torch_port_common import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def mobile():
    module, variables = jax_sam("mobile_sam_test", JAX_MOBILE_CONFIGS, encoder="tiny")
    return module, variables, port_sam("mobile_sam_test", variables)


# ---- (a) MobileSAM -------------------------------------------------------------------

def test_mobile_sam_encoder_matches_jax(mobile):
    module, variables, sam = mobile
    assert "batch_stats" in variables
    img = np.random.default_rng(0).integers(0, 256, (2, 128, 128, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: module.apply(v, x, method="encode"))(
        variables, jnp.asarray(img)))
    with torch.no_grad():
        got = _nhwc(sam.model.encode(torch.from_numpy(img)))
    assert got.shape == (2, 8, 8, 256)
    np.testing.assert_allclose(got, want, atol=ATOL)


MOBILE_PROMPTS = {
    "points": dict(points=[[[40.0, 60.0], [100.0, 7.0]]], labels=[[1.0, 0.0]]),
    "boxes": dict(boxes=[[20.0, 30.0, 90.0, 100.0], [0.0, 0.0, 127.0, 60.0]]),
    "mask": dict(boxes=[[20.0, 30.0, 90.0, 100.0]]),
}


@pytest.mark.parametrize("kind", sorted(MOBILE_PROMPTS))
def test_mobile_sam_decoder_matches_jax(mobile, kind):
    module, variables, sam = mobile
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((1, 8, 8, 256)).astype(np.float32)
    arrays = {k: np.asarray(v, np.float32) for k, v in MOBILE_PROMPTS[kind].items()}
    if kind == "mask":
        arrays["masks"] = rng.standard_normal((1, 32, 32, 1)).astype(np.float32)
    masks, iou = jax.jit(lambda v, e, **k: module.apply(v, e, method="decode", **k))(
        variables, jnp.asarray(emb), **{k: jnp.asarray(v) for k, v in arrays.items()})
    port = {k: torch.from_numpy(v) for k, v in arrays.items()}
    if "masks" in port:
        port["masks"] = port["masks"].permute(0, 3, 1, 2)
    with torch.no_grad():
        pm, pi = sam.model.decode(torch.from_numpy(emb).permute(0, 3, 1, 2), **port)
    np.testing.assert_allclose(pm.numpy(), np.asarray(masks), atol=ATOL)
    np.testing.assert_allclose(pi.numpy(), np.asarray(iou), atol=IOU_TOL)


@pytest.mark.parametrize("hw", [(96, 160), (60, 100)], ids=["enlarge", "shrink"])
def test_mobile_sam_prompt_inference_matches_jax(mobile, monkeypatch, hw):
    module, variables, sam = mobile
    jp, pp = JaxSAMPredictor(module, variables, imgsz=128), sam.predictor
    img = _frame(*hw, seed=7)
    jp.set_image(img)
    pp.set_image(img)
    captured = []
    orig = jp._masks_to_original
    monkeypatch.setattr(jp, "_masks_to_original", lambda low: captured.append(low) or orig(low))
    kw = dict(bboxes=[[10, 10, 80, 50], [30, 5, 90, 55]])
    jm, js = jp.prompt_inference(**kw)
    pm, ps = pp.prompt_inference(**kw)
    _assert_masks_match(pm, _jax_logits(jp, captured[0]), f"mobile {hw}")
    np.testing.assert_allclose(ps, js, atol=IOU_TOL)


# ---- (b) the .pth route ----------------------------------------------------------------

def test_mobile_sam_translate_matches_jax(mobile, tmp_path):
    model = mobile[2].model
    meta = meta_state_dict(model, seed=8, tiny=True)
    assert "image_encoder.layers.1.blocks.0.attn.attention_biases" in meta
    assert "image_encoder.layers.0.downsample.conv2.bn.running_var" in meta
    assert "image_encoder.patch_embed.seq.2.c.weight" in meta
    assert_translations_agree(meta, model)
    path = tmp_path / "mobile_sam_test.pt"
    torch.save(meta, path)
    sam = SAM("mobile_sam_test", weights=path, device="cpu")
    assert sam.info()["params"] == sum(t.numel() for k, t in model.state_dict().items()
                                       if not k.endswith("num_batches_tracked"))


# ---- (c) FastSAM and NAS --------------------------------------------------------------

def _rows(seed: int, n: int = 6, hw=(64, 96), mhw=(32, 48)):
    """n rows [box, conf, cls] in an hw frame and their masks at mhw (each box's region)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.6, (n, 2)) * [hw[1], hw[0]]
    wh = rng.uniform(0.15, 0.4, (n, 2)) * [hw[1], hw[0]]
    boxes = np.concatenate([xy, xy + wh, rng.uniform(0.3, 1, (n, 1)), np.zeros((n, 1))], 1)
    masks = np.zeros((n, *mhw), bool)
    sy, sx = mhw[0] / hw[0], mhw[1] / hw[1]
    for i, (x1, y1, x2, y2) in enumerate(boxes[:, :4]):
        masks[i, int(y1 * sy):int(y2 * sy) + 1, int(x1 * sx):int(x2 * sx) + 1] = True
    return np.zeros((*hw, 3), np.uint8), boxes.astype(np.float32), masks


FILTERS = {"box": dict(bboxes=[[10, 10, 50, 40]]),
           "boxes": dict(bboxes=[[10, 10, 50, 40], [40, 20, 90, 60], [0, 0, 96, 64]]),
           "point": dict(points=[[30, 20]]),
           "points_labels": dict(points=[[30, 20], [60, 40], [20, 50]], labels=[1, 1, 0]),
           "boxes_points": dict(bboxes=[[10, 10, 50, 40]], points=[[60, 40]], labels=[0])}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", sorted(FILTERS))
def test_fastsam_filters_match_jax(kind, seed):
    img, boxes, masks = _rows(seed)
    kw = {**dict(bboxes=None, points=None, labels=None, texts=None, text_embeddings=None),
          **FILTERS[kind]}
    want = JaxFastSAM._prompt(JaxResults(img, "x.jpg", {0: "object"}, boxes=boxes.copy(),
                                         masks=masks.copy()), **kw)
    got = FastSAM._prompt(Results(img, "x.jpg", {0: "object"}, boxes=boxes.copy(),
                                  masks=masks.copy()), **kw)
    np.testing.assert_array_equal(got.boxes.data, want.boxes.data)
    np.testing.assert_array_equal(got.masks.data, np.asarray(want.masks.data))


def test_fastsam_text_prompts_raise():
    img, boxes, masks = _rows(0)
    r = Results(img, "x.jpg", {0: "object"}, boxes=boxes, masks=masks)
    with pytest.raises(ValueError, match="text encoder"):
        FastSAM._prompt(r, None, None, None, ["a person"], None)
    with pytest.raises(NotImplementedError, match="CLIP"):
        FastSAM._prompt(r, None, None, None, ["a person"], lambda t: np.zeros(4))


def test_fastsam_serves_segment_and_nas_detect():
    fast = FastSAM("FastSAM-s.yaml", device="cpu")
    assert fast.task == "segment" and fast.meta["nc"] == 1
    plain = YOLO("FastSAM-s.yaml", device="cpu")
    fast._ensure_variables()
    plain._ensure_variables()
    frames = [_frame(96, 128, seed=s, block=8) for s in (0, 1)]
    kw = dict(imgsz=64, conf=0.001, max_det=30)
    box = [[20, 20, 100, 80]]
    got = fast.predict(frames, bboxes=box, **kw)
    want = [FastSAM._prompt(r, box, None, None, None, None) for r in plain.predict(frames, **kw)]
    assert len(got) == 2
    for g, w in zip(got, want):
        assert len(g.boxes) == len(w.boxes) >= 1
        np.testing.assert_array_equal(g.boxes.data, w.boxes.data)
        np.testing.assert_array_equal(g.masks.data, w.masks.data)
    nas = NAS("yolo_nas.yaml", device="cpu")
    assert nas.task == "detect"
    with pytest.raises(NotImplementedError, match="predict/val"):
        nas.train(data="synthetic")


# ---- (d) refusals and imports ----------------------------------------------------------

def test_refusals(monkeypatch):
    for name, size in (("sam2_t", "sam2_t"), ("sam2.1_b.pt", "sam2_b")):
        sam = SAM(name, device="cpu")
        assert sam.is_sam2 is True and sam.info_dict["is_sam2"] is True
        assert sam.info_dict["name"] == size and sam.device.type == "cpu"
    with pytest.raises(ValueError, match="unknown SAM2 variant"):
        SAM("sam2_q", device="cpu")
    with pytest.raises(ValueError, match="unknown SAM variant"):
        SAM("sam_q", device="cpu")
    with pytest.raises(ValueError, match="SAM2"):
        SAM("sam_test", device="cpu").track("frames/")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: SAM("sam_test"), lambda: SAM("mobile_sam_test"),
                  lambda: FastSAM(), lambda: NAS(), lambda: SAM("sam_test", device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


def test_sam_packages_import_no_jax():
    banned = {"jax", "jaxlib", "flax", "sar_yolo_tpu", "cv2", "PIL", "yaml"}
    files = [p for d in ("models/sam", "models/fastsam", "models/nas")
             for p in sorted((REPO / "sar_yolo_tpu_torch" / d).glob("*.py"))]
    assert len(files) == 11 and any(p.name == "modules2.py" for p in files)
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            assert not [m for m in mods if m.split(".")[0] in banned], (path, mods)
