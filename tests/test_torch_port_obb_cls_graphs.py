"""The OBB and Classify heads and every OBB and classify graph of the PyTorch port against the
JAX package.

(a) `test_head_matches_jax`: OBB (1 angle channel, the v8 and the depthwise cls branch) and
Classify (one input and a list of two, concatenated on channels) from `fill_variables`
weights, in eval mode and in train mode (the outputs and the BN statistics after the step),
1e-5 absolute in float32; `test_fused_heads_match_jax`: both folded by `nn/fuse.py` against
JAX's `fuse_variables` + `fused=True`.
(b) `test_graph_matches_jax`: every OBB and classify file (yolov8-obb, yolo11-obb,
yolov8-cls, yolov8-cls-resnet50, yolov8-cls-resnet101, yolo11-cls, yolo11-cls-resnet18 at n,
s, m, l, x; tinyobb, tinycls): the port's specs (Classify's class count not width-scaled),
save list and meta equal JAX's; the graph, built on the `meta` device, has JAX's parameter
count, task and `nl` (none for classify, whose strides are []).
(c) `test_forward_matches_jax`: the eval forward of tinyobb, yolov8n-obb, yolov8s-obb,
yolo11n-obb and yolov8n-cls-resnet50 at 64 px from `fill_variables` weights through the
strict bridge: maps or logits within 1e-4 absolute.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.nn.fuse import fuse_variables
from sar_yolo_tpu.nn.modules import conv as JC
from sar_yolo_tpu.nn.modules import head as JH
from sar_yolo_tpu.nn.tasks import build_model as jax_build_model
from sar_yolo_tpu.nn.tasks import parse_model as jax_parse_model
from sar_yolo_tpu.nn.tasks import yaml_model_load
from sar_yolo_tpu_torch.cfg.models import model_config
from sar_yolo_tpu_torch.nn.fuse import fuse_model
from sar_yolo_tpu_torch.nn.modules import head as PH
from sar_yolo_tpu_torch.nn.tasks import build_model, parse_model
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from test_torch_port_pose_seg_graphs import _compare, _feats, _nchw, _to_jax, _to_port, _x
from torch_port_common import fill_variables, one_torch_thread  # noqa: F401 (autouse fixture)

HEAD_ATOL = 1e-5
ATOL = 1e-4
CH = (16, 32, 32)


def _compare_logits(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


HEADS = {  # name: (JAX module, port module, inputs)
    "OBB": lambda: (JH.OBB(nc=3, ch=CH, ne=1), PH.OBB(nc=3, ne=1, ch=CH), _feats()),
    "OBB_legacy": lambda: (JH.OBB(nc=15, ch=CH, ne=1, legacy=True),
                           PH.OBB(nc=15, ne=1, ch=CH, legacy=True), _feats(4)),
    "Classify": lambda: (JH.Classify(nc=10), PH.Classify(16, 10), _x(2, 8, 8, 16)),
    "Classify_list": lambda: (JH.Classify(nc=5, c_=64), PH.Classify(48, 5, c_=64),
                              [_x(2, 4, 4, 16), _x(2, 4, 4, 32, seed=2)]),
}


def _variables(jax_module, jx, seed: int = 0):
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), jx, train=False))
    return fill_variables(shapes, np.random.default_rng(seed))


def _check(case, got, want, atol):
    if case.startswith("Classify"):
        _compare_logits(got, want, atol)
    else:
        _compare(got, want, atol)


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("case", list(HEADS))
def test_head_matches_jax(case, mode):
    jax_module, port_module, xs = HEADS[case]()
    jx = _to_jax(xs)
    variables = _variables(jax_module, jx)
    port_module.load_state_dict(from_jax_variables(variables), strict=True)
    train = mode == "train"
    port_module.train(train)
    with torch.no_grad():
        got = port_module(_to_port(xs))
    if case.startswith("OBB"):
        assert len(got) == 3 and got[0].shape[1] == 64 + port_module.nc + 1
    if not train:
        _check(case, got, jax_module.apply(variables, jx, train=False), HEAD_ATOL)
        return
    # Flax's Dropout needs its rng in train mode; the rate is 0 here, as in the port
    want, updates = jax_module.apply(variables, jx, train=True, mutable=["batch_stats"],
                                     rngs={"dropout": jax.random.PRNGKey(0)})
    _check(case, got, want, HEAD_ATOL)
    own = port_module.state_dict()
    for k, w in from_jax_variables(jax.device_get(dict(updates))).items():
        if "running_" in k:
            np.testing.assert_allclose(own[k].numpy(), w.numpy(), rtol=0, atol=HEAD_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("case", ["OBB", "Classify_list"])
def test_fused_heads_match_jax(case):
    jax_module, port_module, xs = HEADS[case]()
    jx = _to_jax(xs)
    variables = _variables(jax_module, jx)
    port_module.load_state_dict(from_jax_variables(variables), strict=True)
    fused = fuse_model(copy.deepcopy(port_module).eval())
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in fused.modules())
    fvars = fuse_variables(variables)
    with JC.fused_mode(True):
        want = jax_module.apply(fvars, jx, train=False)
    with torch.no_grad():
        _check(case, fused(_to_port(xs)), want, HEAD_ATOL)
    assert set(from_jax_variables(jax.device_get(fvars))) == set(fused.state_dict())


# ---- (b) every file at every scale -----------------------------------------------------------

SCALED = ("yolov8-obb", "yolo11-obb", "yolov8-cls", "yolov8-cls-resnet50",
          "yolov8-cls-resnet101", "yolo11-cls", "yolo11-cls-resnet18")
ALL = [f"{stem[:stem.index('-')]}{s}{stem[stem.index('-'):]}.yaml" for stem in SCALED
       for s in "nsmlx"] + ["tinyobb.yaml", "tinycls.yaml"]


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
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                                train=False))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    with torch.device("meta"):
        model, meta = build_model(pd)
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert meta["task"] == jmeta["task"] and meta.get("nl") == jmeta.get("nl")
    head = model.blocks[-1]
    if meta["task"] == "obb":
        assert isinstance(head, PH.OBB) and meta["nl"] == len(meta["strides"]) == 3
    else:
        assert isinstance(head, PH.Classify) and meta["strides"] == [] and "nl" not in meta
        assert head.linear.out_features == pd["nc"] == p_specs[-1].c2


# ---- (c) forward maps ------------------------------------------------------------------------

FORWARD = ["tinyobb.yaml", "yolov8n-obb.yaml", "yolov8s-obb.yaml", "yolo11n-obb.yaml",
           "yolov8n-cls-resnet50.yaml"]


@pytest.mark.parametrize("name", FORWARD)
def test_forward_matches_jax(name):
    jmodel, jmeta = jax_build_model(name)
    x = np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                train=False))
    variables = fill_variables(shapes, np.random.default_rng(0))
    pmodel, meta = build_model(name)
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = pmodel(_nchw(x))
    want = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=False))(variables, jnp.asarray(x))
    if meta["task"] == "classify":
        _compare_logits(got, want, ATOL)
    else:
        assert len(got) == meta["nl"] == 3
        _compare(got, want, ATOL)
