"""Every RT-DETR and YOLO-World graph of the PyTorch port against the JAX package.

(a) `test_graph_matches_jax`: rtdetr-l, rtdetr-x, rtdetr-resnet50, rtdetr-resnet101,
yolov8-rtdetr, yolov8-world and yolov8-worldv2 at each of their scales, tinyrtdetr and
tinyworld: the port's specs (C2fAttn's embed channels and head count scaled), save list and
meta equal JAX's; the graph, built on the `meta` device, has JAX's parameter count (an
RT-DETR graph initialized through its denoising path, as the JAX package's `init_model`
does, so that `denoising_class_embed` exists), task and `nl`;
(b) `test_forward_matches_jax`: the eval forward of tinyrtdetr, tinyworld, rtdetr-l,
rtdetr-resnet50, yolov8n-rtdetr, yolov8n-world and yolov8n-worldv2 at 64 px from
`fill_variables` weights through the strict bridge, within 1e-4 absolute: the four RT-DETR
outputs, or the World maps;
(c) `test_fused_forward_matches_jax`: tinyrtdetr and tinyworld folded by `nn/fuse.py`
against JAX's `fuse_variables` + `fused=True`: the same state-dict keys (the input
projections' and the contrastive heads' BatchNorms kept, as JAX keeps them) and outputs
within 1e-4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.nn.fuse import fuse_variables
from sar_yolo_tpu.nn.tasks import build_model as jax_build_model
from sar_yolo_tpu.nn.tasks import parse_model as jax_parse_model
from sar_yolo_tpu.nn.tasks import yaml_model_load
from sar_yolo_tpu_torch.cfg.models import model_config
from sar_yolo_tpu_torch.nn.fuse import fuse_model
from sar_yolo_tpu_torch.nn.modules import head as PH
from sar_yolo_tpu_torch.nn.modules import transformer as PT
from sar_yolo_tpu_torch.nn.tasks import build_model, parse_model
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from torch_port_common import fill_variables, one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = 1e-4
KEY = jax.random.PRNGKey(0)
ALL = (["rtdetr-l.yaml", "rtdetr-x.yaml", "rtdetr-resnet50.yaml", "rtdetr-resnet101.yaml"] +
       [f"yolov8{s}-{kind}.yaml" for kind in ("rtdetr", "world", "worldv2") for s in "nsmlx"] +
       ["tinyrtdetr.yaml", "tinyworld.yaml"])


def _jax_shapes(model, meta, imgsz: int):
    """eval_shape of the JAX init (through the denoising path for an RT-DETR head)."""
    x = jnp.zeros((1, imgsz, imgsz, 3), jnp.float32)
    if meta.get("head") == "RTDETRDecoder":
        gt = {"cls": jnp.zeros((1, 4), jnp.int32), "bboxes": jnp.full((1, 4, 4), 0.5),
              "mask": jnp.zeros((1, 4))}
        return jax.eval_shape(lambda: model.init({"params": KEY, "dropout": KEY, "dn": KEY}, x,
                                                 train=True, batch_gt=gt))
    return jax.eval_shape(lambda: model.init(KEY, x, train=False))


@pytest.mark.parametrize("name", ALL)
def test_graph_matches_jax(name):
    jd = yaml_model_load(name)
    pd = model_config(name)
    assert pd == {k: v for k, v in jd.items() if k != "yaml_file"}
    j_specs, j_save, j_meta = jax_parse_model(jd)
    p_specs, p_save, p_meta = parse_model(pd)

    def rows(specs):
        return [(s.i, s.f, s.name, s.args, s.c2, s.kwargs) for s in specs]

    assert rows(p_specs) == rows(j_specs)
    assert p_save == j_save and p_meta == j_meta
    jmodel, jmeta = jax_build_model(jd)
    shapes = _jax_shapes(jmodel, jmeta, 32)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    with torch.device("meta"):
        model, meta = build_model(pd)
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert meta["task"] == jmeta["task"] == "detect" and meta["nl"] == jmeta["nl"] == 3
    head = model.blocks[-1]
    if meta["head"] == "RTDETRDecoder":
        assert isinstance(head, PT.RTDETRDecoder) and meta["strides"] == [8, 16, 32]
    else:
        assert isinstance(head, PH.WorldDetect) and model.text_embeddings.shape[0] == pd["nc"]


FORWARD = ["tinyrtdetr.yaml", "tinyworld.yaml", "rtdetr-l.yaml", "rtdetr-resnet50.yaml",
           "yolov8n-rtdetr.yaml", "yolov8n-world.yaml", "yolov8n-worldv2.yaml"]


def _pair(name, seed=0):
    jmodel, jmeta = jax_build_model(name)
    variables = fill_variables(_jax_shapes(jmodel, jmeta, 64), np.random.default_rng(seed))
    pmodel, meta = build_model(name)
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    return jmodel, pmodel, variables, meta


def _compare(got, want, meta):
    if meta["head"] == "RTDETRDecoder":
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    else:
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), rtol=0,
                                       atol=ATOL)


@pytest.mark.parametrize("name", FORWARD)
def test_forward_matches_jax(name):
    jmodel, pmodel, variables, meta = _pair(name)
    x = np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = pmodel(torch.tensor(x.transpose(0, 3, 1, 2).copy()))
    want = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=False))(variables, jnp.asarray(x))
    _compare(got, want, meta)


@pytest.mark.parametrize("name", ["tinyrtdetr.yaml", "tinyworld.yaml"])
def test_fused_forward_matches_jax(name):
    jmodel, pmodel, variables, meta = _pair(name, seed=3)
    fused = fuse_model(copy.deepcopy(pmodel).eval())
    kept = [m for m in fused.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert kept and all(isinstance(m, PT.StandaloneBatchNorm) for m in kept)
    fvars = fuse_variables(variables)
    assert set(from_jax_variables(jax.device_get(fvars))) == set(fused.state_dict())
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    fmodel = jmodel.clone(fused=True)
    want = jax.jit(lambda v, xx: fmodel.apply(v, xx, train=False))(fvars, jnp.asarray(x))
    with torch.no_grad():
        got = fused(torch.tensor(x.transpose(0, 3, 1, 2).copy()))
    _compare(got, want, meta)
