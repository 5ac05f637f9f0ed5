"""The fork's CBAM JDE configs in the PyTorch port against the JAX package.

(a) `ChannelAttention`, `SpatialAttention`, `CBAM`, `C3k2_CBAM` and `DSC3k2_CBAM` on maps
of odd sizes, 1e-5 absolute in float32, with `fill_variables` weights (the bridge maps
`cbam/channel_attention/fc/{kernel,bias}` and `cbam/spatial_attention/cv1/kernel`);
(b) `parse_model` of the four configs (`v13/yolov13-JDE_CBAM`, `v13/yolov13-P24_CBAM_JDE`,
`11/yolo11-JDE_CBAM`, `11/yolo11-P24_CBAM_JDE`) at scales n and l against JAX's, and
their scale-n forward maps, unfused and BN-folded (CBAM's convolutions have no BN and
stay as they are), 1e-4 absolute at 64 px (the P24 models at 128);
(c) yolov13n-JDE_CBAM's first-step gradient: a float64 copy of the port against JAX's
float32 gradient on the same batch, within 1e-3 relative L2, as
`test_torch_port_train_v13.py` holds yolov13n-JDE's;
(d) `predict_batched` of yolov13n-JDE_CBAM against JAX's: the same kept rows, boxes
within 1e-3 px, scores and embeddings within 1e-4, at a threshold in a gap of the scores.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.nn.fuse import fuse as jax_fuse
from sar_yolo_tpu.nn.modules import block as JB
from sar_yolo_tpu.nn.modules import conv as JC
from sar_yolo_tpu.nn.tasks import build_model as jax_build_model
from sar_yolo_tpu.nn.tasks import parse_model as jax_parse_model
from sar_yolo_tpu.nn.tasks import yaml_model_load
from sar_yolo_tpu.utils import ROOT as JAX_ROOT
from sar_yolo_tpu.utils.loss import jde_loss
from sar_yolo_tpu_torch.cfg.models import model_config
from sar_yolo_tpu_torch.nn.fuse import fuse_model, half_model
from sar_yolo_tpu_torch.nn.modules import block as PB
from sar_yolo_tpu_torch.nn.modules import conv as PC
from sar_yolo_tpu_torch.nn.tasks import build_model, parse_model
from sar_yolo_tpu_torch.ops.decode import decode_detect
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from torch_port_common import (fill_variables, jax_and_port_yolo, jax_jde_trainer,  # noqa: F401
                               one_torch_thread, port_trainer_like)

FRAMES = JAX_ROOT.parent / "tests" / "data" / "jpeg" / "frames"

# ---- (a) modules -----------------------------------------------------------------------------

MODULE_CASES = {
    "ChannelAttention": lambda: (JC.ChannelAttention(), PC.ChannelAttention(24), 24),
    "SpatialAttention": lambda: (JC.SpatialAttention(7), PC.SpatialAttention(7), 24),
    "SpatialAttention_k3": lambda: (JC.SpatialAttention(3), PC.SpatialAttention(3), 16),
    "CBAM": lambda: (JC.CBAM(7), PC.CBAM(24, 7), 24),
    "C3k2_CBAM": lambda: (JB.C3k2_CBAM(64, 1, False, 0.25), PB.C3k2_CBAM(32, 64, 1, False, 0.25),
                          32),
    "C3k2_CBAM_c3k": lambda: (JB.C3k2_CBAM(64, 2, True), PB.C3k2_CBAM(48, 64, 2, True), 48),
    "DSC3k2_CBAM": lambda: (JB.DSC3k2_CBAM(32, 2, False, 0.25),
                            PB.DSC3k2_CBAM(16, 32, 2, False, 0.25), 16),
    "DSC3k2_CBAM_dsc3k": lambda: (JB.DSC3k2_CBAM(32, 1, True), PB.DSC3k2_CBAM(16, 32, 1, True), 16),
}


@pytest.mark.parametrize("hw", [(7, 9), (13, 5)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("case", list(MODULE_CASES))
def test_module_matches_jax(case, hw):
    jax_module, port_module, c = MODULE_CASES[case]()
    x = np.random.default_rng(1).standard_normal((2, *hw, c)).astype(np.float32)
    jx = jnp.asarray(x)
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), jx, train=False))
    variables = fill_variables(shapes, np.random.default_rng(0))
    port_module.load_state_dict(from_jax_variables(variables), strict=True)
    want = np.asarray(jax_module.apply(variables, jx, train=False)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = port_module.eval()(torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_cbam_convs_stay_unfolded_and_go_bf16():
    """BN folding leaves CBAM's convolutions (no BN) as they are; `half_model` casts them."""
    model = PB.C3k2_CBAM(16, 32, 1)
    before = {k: v.clone() for k, v in model.cbam.state_dict().items()}
    fuse_model(model)
    for k, v in model.cbam.state_dict().items():
        assert torch.equal(v, before[k]), k
    half_model(model)
    assert {p.dtype for p in model.cbam.parameters()} == {torch.bfloat16}
    assert model.cbam.channel_attention.fc.compute_dtype == torch.bfloat16


# ---- (b) the four configs --------------------------------------------------------------------

CONFIGS = {"yolov13n-JDE_CBAM.yaml": 64, "yolov13n-P24_CBAM_JDE.yaml": 128,
           "yolo11n-JDE_CBAM.yaml": 64, "yolo11n-P24_CBAM_JDE.yaml": 128}


@pytest.mark.parametrize("name", [*CONFIGS, "yolov13l-JDE_CBAM.yaml", "yolo11l-P24_CBAM_JDE.yaml"])
def test_parse_model_matches_jax(name):
    jd = yaml_model_load(name)
    pd = model_config(name)
    assert pd == {k: v for k, v in jd.items() if k != "yaml_file"}
    j_specs, j_save, j_meta = jax_parse_model(jd)
    p_specs, p_save, p_meta = parse_model(pd)

    def rows(specs):
        return [(s.i, s.f, s.name, s.args, s.c2, s.kwargs) for s in specs]

    assert rows(p_specs) == rows(j_specs)
    assert (p_save, p_meta) == (j_save, j_meta)
    assert any(s.name in ("C3k2_CBAM", "DSC3k2_CBAM") for s in p_specs)


@pytest.fixture(scope="module", params=list(CONFIGS), ids=lambda n: n.removesuffix(".yaml"))
def pair(request):
    """(jax model, variables, port model with the same weights, its meta, input)."""
    name = request.param
    jmodel, jmeta = jax_build_model(name)
    x0 = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x0, train=False))
    variables = fill_variables(shapes, np.random.default_rng(0))
    pmodel, meta = build_model(name)
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in pmodel.parameters()) == n_jax
    imgsz = CONFIGS[name]
    x = np.random.default_rng(1).uniform(0, 1, (2, imgsz, imgsz, 3)).astype(np.float32)
    return jmodel, variables, pmodel, meta, x


def _compare(jax_maps, port_model, x):
    with torch.no_grad():
        port_maps = port_model(torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    assert len(jax_maps) == len(port_maps) in (3, 4)
    for w, g in zip(jax_maps, port_maps):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4)


@pytest.mark.parametrize("folded", [False, True], ids=["unfused", "folded"])
def test_forward_matches_jax(pair, folded):
    jmodel, variables, pmodel, meta, x = pair
    assert meta["task"] == "jde" and meta["scale"] == "n"
    assert meta["strides"] == ([4, 8, 16, 32] if len(meta["head_ch"]) == 4 else [8, 16, 32])
    if folded:
        jmodel, variables = jax_fuse(jmodel, variables)
        pmodel = fuse_model(copy.deepcopy(pmodel))
        assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in pmodel.modules())
        bridged = from_jax_variables(jax.device_get(variables))
        assert set(bridged) == set(pmodel.state_dict())
    forward = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=False))  # faster than eager here
    _compare(forward(variables, jnp.asarray(x)), pmodel, x)


# ---- (c) the first-step gradient -------------------------------------------------------------

COMMON = dict(model="yolov13n-JDE_CBAM.yaml", data="synthetic", imgsz=64, batch=2, nbs=2,
              workers=1, max_labels=16, seed=0, optimizer="SGD", warmup_epochs=0.0, lr0=1e-4)


def test_yolov13n_cbam_first_step_gradient_matches_jax(tmp_path, monkeypatch):
    jtr = jax_jde_trainer({**COMMON, "mesh_shape": [1], "plots": False, "val": False,
                           "save": False, "project": str(tmp_path)}, seed=11,
                          monkeypatch=monkeypatch)
    jtr.train_loader.set_epoch(0)
    batch = next(iter(jtr.train_loader))
    meta, batch_stats = jtr.meta, jtr.state.batch_stats
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(params):
        feats, _ = jtr.model.apply({"params": params, "batch_stats": batch_stats},
                                   jb["img"].astype(jnp.float32) / 255.0, train=True,
                                   mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return jde_loss(feats, jb, jtr.args, nc=meta["nc"], reg_max=meta["reg_max"],
                        strides=tuple(meta["strides"]), embed_dim=meta["embed_dim"],
                        state_classes=meta["state_classes"],
                        cb_counts=jnp.zeros(meta["state_classes"])).total

    want = from_jax_variables({"params": jax.device_get(jax.jit(jax.grad(loss))(
        jax.device_get(jtr.state.params)))})
    ptr = port_trainer_like(jtr, {**COMMON, "project": str(tmp_path)})
    model = copy.deepcopy(ptr.model).double()
    b = ptr.to_device(batch)
    ptr.loss(model(b["img"].double()), b)[0].backward()
    got = {n: p.grad for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    assert any(".cbam." in n for n in got)

    def flat(g):
        return torch.cat([g[n].double().flatten() for n in got])

    rel_l2 = ((flat(got) - flat(want)).norm() / flat(want).norm()).item()
    assert rel_l2 < 1e-3, f"gradient {rel_l2:.3g} from JAX's (relative L2)"
    cbam = [n for n in got if ".cbam." in n]
    rel = ((torch.cat([got[n].flatten() for n in cbam]) - torch.cat([want[n].double().flatten()
                                                                     for n in cbam])).norm()
           / torch.cat([want[n].double().flatten() for n in cbam]).norm()).item()
    assert rel < 1e-3, f"CBAM gradients {rel:.3g} from JAX's (relative L2)"


# ---- (d) predict_batched ---------------------------------------------------------------------

def _sorted_rows(d):
    """Kept rows ordered by box (rows of near-equal score may swap places)."""
    d = d[d[:, 4] > 0]
    return d[np.lexsort((d[:, 3], d[:, 2], d[:, 1], d[:, 0], d[:, 5]))]


def test_predict_batched_matches_jax():
    """Two 480x640 crops of the JPEG fixtures at 128 px; BN statistics calibrated and box
    logits scaled by 0.1, so that the outputs depend on the image and NMS does not pick
    among tied rows; the threshold in the widest gap of the top scores."""
    import cv2
    jyolo, pyolo = jax_and_port_yolo("yolov13n-JDE_CBAM.yaml", 5, box_gain=0.1, calibrate=128)
    frames = np.stack([cv2.imread(str(FRAMES / f"frame_{i:02d}.jpg"))[100:580, 300:940]
                       for i in (0, 6)])
    predictor = pyolo._get_predictor({"imgsz": 128})
    x, _, _ = predictor.preprocess(frames)
    meta = pyolo.meta
    with torch.no_grad():
        scores = decode_detect(predictor.model(x), meta["strides"], meta["nc"], meta["reg_max"],
                               extra_sigmoid=meta["state_classes"],
                               split_extras=meta["embed_dim"])[0][..., 4]
    top = np.sort(scores.flatten().numpy())[::-1][:120]
    i = 10 + int(np.argmax(-np.diff(top[10:])))
    conf = float((top[i] + top[i + 1]) / 2)
    assert top[i] - top[i + 1] > 1e-5
    kw = dict(imgsz=128, conf=conf, max_det=300)
    want = np.asarray(jyolo.predict_batched(frames, **kw))
    got = pyolo.predict_batched(frames, **kw)
    assert got.shape == want.shape == (2, 300, 6 + 256 + 6)
    for b in range(2):
        g, w = _sorted_rows(got[b]), _sorted_rows(want[b])
        assert len(g) == len(w) > 0
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g[:, 4:5], w[:, 4:5], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g[:, 6:], w[:, 6:], rtol=0, atol=1e-4)
    assert (got[..., 4] > 0).sum() > 4
