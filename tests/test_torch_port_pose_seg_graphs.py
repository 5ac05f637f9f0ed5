"""The pose and segment heads and graphs of the PyTorch port against the JAX package.

(a) `test_head_matches_jax`: Pose (17 x 3 and 5 x 2 keypoints), Proto and Segment from
`fill_variables` weights, in eval mode and in train mode (the outputs and the BN statistics
after the step), 1e-5 absolute in float32; Segment returns (maps, protos) and Proto's
upsample is the biased transposed conv, bridged mechanically (`proto.upsample.conv`).
`test_fused_segment_matches_jax`: Segment folded by `nn/fuse.py` (Proto's Convs included)
against JAX's `fuse_variables` + `fused=True`.
(b) `test_parse_model_matches_jax`: every pose and segment file (yolov8-pose, -pose-p6,
yolo11-pose, yolov8-seg, -seg-p6, yolo11-seg at n, s, m, l, x; yolov9c-seg, yolov9e-seg;
FastSAM at s and x; tinypose, tinyseg): the port's specs (Segment's width-scaled proto
channels), save list and meta equal JAX's, and the graph builds on the `meta` device with
the task, `kpt_shape` or `nm` of JAX's `build_model`.
(c) `test_forward_matches_jax`: the eval forward of each file at scale n and at one larger
scale per family, 64 px, from `fill_variables` weights through the strict bridge: maps and
prototypes within 1e-4 absolute, parameter counts equal.
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
from torch_port_common import fill_variables, one_torch_thread  # noqa: F401 (autouse fixture)

HEAD_ATOL = 1e-5
ATOL = 1e-4
CH = (16, 32, 32)


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [m for o in out for m in _leaves(o)]
    return [out]


def _compare(port_out, jax_out, atol):
    got, want = _leaves(port_out), _leaves(jax_out)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=atol)


def _feats(seed=1):
    return [_x(2, 16, 16, CH[0], seed=seed), _x(2, 8, 8, CH[1], seed=seed + 1),
            _x(2, 4, 4, CH[2], seed=seed + 2)]


HEADS = {  # name: (JAX module, port module, inputs)
    "Pose17x3": lambda: (JH.Pose(nc=1, ch=CH, kpt_shape=(17, 3)),
                         PH.Pose(nc=1, kpt_shape=(17, 3), ch=CH), _feats()),
    "Pose5x2_legacy": lambda: (JH.Pose(nc=3, ch=CH, kpt_shape=(5, 2), legacy=True),
                               PH.Pose(nc=3, kpt_shape=(5, 2), ch=CH, legacy=True), _feats(4)),
    "Proto": lambda: (JH.Proto(24, 8), PH.Proto(16, 24, 8), _x(2, 8, 8, 16)),
    "Segment": lambda: (JH.Segment(nc=3, ch=CH, nm=8, npr=24),
                        PH.Segment(nc=3, nm=8, npr=24, ch=CH), _feats(7)),
}


def _to_jax(xs):
    return [jnp.asarray(x) for x in xs] if isinstance(xs, list) else jnp.asarray(xs)


def _to_port(xs):
    return [_nchw(x) for x in xs] if isinstance(xs, list) else _nchw(xs)


def _variables(jax_module, jx, seed: int = 0):
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), jx, train=False))
    return fill_variables(shapes, np.random.default_rng(seed))


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
    if case == "Segment":
        assert isinstance(got, tuple) and len(got[0]) == 3 and got[1].shape == (2, 8, 32, 32)
    if not train:
        _compare(got, jax_module.apply(variables, jx, train=False), HEAD_ATOL)
        return
    want, updates = jax_module.apply(variables, jx, train=True, mutable=["batch_stats"])
    _compare(got, want, HEAD_ATOL)
    own = port_module.state_dict()
    for k, w in from_jax_variables(jax.device_get(dict(updates))).items():
        if "running_" in k:
            np.testing.assert_allclose(own[k].numpy(), w.numpy(), rtol=0, atol=HEAD_ATOL,
                                       err_msg=k)


def test_fused_segment_matches_jax():
    jax_module, port_module, xs = HEADS["Segment"]()
    jx = _to_jax(xs)
    variables = _variables(jax_module, jx)
    port_module.load_state_dict(from_jax_variables(variables), strict=True)
    fused = fuse_model(copy.deepcopy(port_module).eval())
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in fused.modules())
    fvars = fuse_variables(variables)
    with JC.fused_mode(True):
        want = jax_module.apply(fvars, jx, train=False)
    with torch.no_grad():
        _compare(fused(_to_port(xs)), want, HEAD_ATOL)
    assert set(from_jax_variables(jax.device_get(fvars))) == set(fused.state_dict())


# ---- (b) parse_model at every scale ----------------------------------------------------------

SCALED = ("yolov8-pose", "yolov8-pose-p6", "yolov8-seg", "yolov8-seg-p6", "yolo11-pose",
          "yolo11-seg")
ALL = [f"{stem[:stem.index('-')]}{s}{stem[stem.index('-'):]}.yaml" for stem in SCALED
       for s in "nsmlx"] + ["yolov9c-seg.yaml", "yolov9e-seg.yaml", "FastSAM-s.yaml",
                            "FastSAM-s.yaml@x", "tinypose.yaml", "tinyseg.yaml"]


def _configs(name: str):
    """(JAX config dict, port config dict) of a file name; `@x` picks another scale of the
    file (FastSAM-s.yaml lists s and x)."""
    name, _, scale = name.partition("@")
    jd = yaml_model_load(name)
    pd = model_config(name)
    assert pd == {k: v for k, v in jd.items() if k != "yaml_file"}
    if scale:
        jd, pd = {**jd, "scale": scale}, {**pd, "scale": scale}
    return jd, pd


@pytest.mark.parametrize("name", ALL)
def test_parse_model_matches_jax(name):
    jd, pd = _configs(name)
    j_specs, j_save, j_meta = jax_parse_model(jd)
    p_specs, p_save, p_meta = parse_model(pd)

    def rows(specs):
        return [(s.i, s.f, s.name, s.args, s.c2, s.kwargs) for s in specs]

    assert rows(p_specs) == rows(j_specs)
    assert p_save == j_save and p_meta == j_meta
    with torch.device("meta"):
        model, meta = build_model(pd)
    head = p_specs[-1]
    assert meta["task"] == {"Pose": "pose", "Segment": "segment"}[head.name]
    assert len(meta["strides"]) == meta["nl"]
    if head.name == "Pose":
        assert meta["kpt_shape"] == tuple(pd["kpt_shape"]) and isinstance(model.blocks[-1], PH.Pose)
    else:
        assert meta["nm"] == head.args[1] and model.blocks[-1].proto.cv1.conv.out_channels == \
            head.args[2]


# ---- (c) forward maps ------------------------------------------------------------------------

FORWARD = ["yolov8n-pose.yaml", "yolov8m-pose.yaml", "yolov8n-pose-p6.yaml", "yolo11n-pose.yaml",
           "yolo11s-pose.yaml", "yolov8n-seg.yaml", "yolov8s-seg.yaml", "yolov8n-seg-p6.yaml",
           "yolo11n-seg.yaml", "yolo11m-seg.yaml", "yolov9c-seg.yaml", "yolov9e-seg.yaml",
           "FastSAM-s.yaml", "tinypose.yaml", "tinyseg.yaml"]


@pytest.mark.parametrize("name", FORWARD)
def test_forward_matches_jax(name):
    jd, pd = _configs(name)
    jmodel, jmeta = jax_build_model(jd)
    x = np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                train=False))
    variables = fill_variables(shapes, np.random.default_rng(0))
    pmodel, meta = build_model(pd)
    assert meta["task"] == jmeta["task"] and meta.get("kpt_shape") == jmeta.get("kpt_shape") \
        and meta.get("nm") == jmeta.get("nm")
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in pmodel.parameters()) == n_jax
    with torch.no_grad():
        got = pmodel(_nchw(x))
    want = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=False))(variables, jnp.asarray(x))
    if meta["task"] == "segment":
        assert isinstance(got, tuple) and len(got[0]) == meta["nl"]
    _compare(got, want, ATOL)
