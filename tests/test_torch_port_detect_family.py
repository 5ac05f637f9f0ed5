"""The rest of the detect family in the PyTorch port against the JAX package: the conv and
block modules of YOLOv3, v5, v6, v8-ghost / p2 / p6, v9 and v10, the PPHGNetV2 and ResNet
backbone blocks, and the whole v3-v10 detect graphs.

(a) `test_module_matches_jax`: each new module of `nn/modules/conv.py` and `block.py` (and
v10Detect) from `fill_variables` weights, in eval mode and in train mode (the outputs and
the BN statistics after the step), 1e-4 absolute in float32: ConvTranspose2d with an
asymmetric random kernel at k=2, s=2 (and k=3, s=2, p=1), CBFuse resizing down and up by
`jax.image.resize`'s nearest rule, CBLinear's tuple of chunks.
(b) `test_fused_module_matches_jax`: Conv2, RepConv, RepVGGDW (alone and in a CIB) and
RepC3 folded by `nn/fuse.py` against JAX's `fuse_variables` + `fused=True`, 1e-4
absolute; the bridged fused tree equals the port's own folded state dict (1e-5 relative).
(c) `test_parse_model_matches_jax`: every v3, v5, v6, v8-ghost, v8-p6, v9 and v10 file at
every scale its `scales` has: the port's specs, save list and meta equal JAX's, and the
graph builds (on the `meta` device).
The forward maps of the whole graphs are in `test_torch_port_detect_family_graphs.py` and,
for the v10 files, `test_torch_port_v10.py`.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.nn.fuse import fuse_variables
from sar_yolo_tpu.nn.modules import block as JB
from sar_yolo_tpu.nn.modules import conv as JC
from sar_yolo_tpu.nn.modules import head as JH
from sar_yolo_tpu.nn.tasks import parse_model as jax_parse_model
from sar_yolo_tpu.nn.tasks import yaml_model_load
from sar_yolo_tpu_torch.cfg.models import model_config
from sar_yolo_tpu_torch.nn.fuse import fuse_model
from sar_yolo_tpu_torch.nn.modules import block as PB
from sar_yolo_tpu_torch.nn.modules import conv as PC
from sar_yolo_tpu_torch.nn.modules import head as PH
from sar_yolo_tpu_torch.nn.tasks import build_model, parse_model
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from torch_port_common import fill_variables, one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = 1e-4


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _to_port(xs):
    if isinstance(xs, tuple):
        return tuple(_to_port(x) for x in xs)
    if isinstance(xs, list):
        return [_to_port(x) for x in xs]
    return _nchw(xs)


def _to_jax(xs):
    if isinstance(xs, (list, tuple)):
        return type(xs)(_to_jax(x) for x in xs)
    return jnp.asarray(xs)


def _leaves(out):
    """The maps of a module output (a map, a list or tuple of maps, or v10Detect's dict)."""
    if isinstance(out, dict):
        return [m for k in sorted(out) for m in _leaves(out[k])]
    if isinstance(out, (list, tuple)):
        return [m for o in out for m in _leaves(o)]
    return [out]


def _compare(port_out, jax_out):
    got, want = _leaves(port_out), _leaves(jax_out)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=ATOL)


def _variables(jax_module, jx, seed: int = 0):
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), jx, train=False))
    return fill_variables(shapes, np.random.default_rng(seed))


# ---- (a) modules -----------------------------------------------------------------------------

def _cbl():
    """Two CBLinear outputs (9x9 and 4x4 maps) and a target: CBFuse shrinks chunk 1 of the
    first (9 -> 6) and grows chunk 0 of the second (4 -> 6)."""
    return [(_x(2, 9, 9, 8), _x(2, 9, 9, 16, seed=2)), (_x(2, 4, 4, 16, seed=3),),
            _x(2, 6, 6, 16, seed=4)]


MODULE_CASES = {
    # conv.py
    "LightConv": lambda: (JC.LightConv(16, 3), PC.LightConv(8, 16, 3), _x(2, 8, 8, 8)),
    "RepConv": lambda: (JC.RepConv(16, 3, 2), PC.RepConv(8, 16, 3, 2), _x(2, 9, 9, 8)),
    "Conv2": lambda: (JC.Conv2(16, 3, 1), PC.Conv2(8, 16, 3, 1), _x(2, 8, 8, 8)),
    "Conv2_stride2_groups": lambda: (JC.Conv2(16, 3, 2, g=2), PC.Conv2(8, 16, 3, 2, g=2),
                                     _x(2, 9, 9, 8)),
    "GhostConv": lambda: (JC.GhostConv(16, 3, 2), PC.GhostConv(8, 16, 3, 2), _x(2, 9, 9, 8)),
    "GhostConv_linear": lambda: (JC.GhostConv(16, 1, 1, act=False),
                                 PC.GhostConv(8, 16, 1, 1, act=False), _x(2, 8, 8, 8)),
    "Index": lambda: (JC.Index(16, 1), PC.Index(16, 1), [_x(2, 4, 4, 8), _x(2, 4, 4, 16, seed=2)]),
    "ConvTranspose2d_k2s2": lambda: (JC.ConvTranspose2d(16, 2, 2, 0),
                                     PC.ConvTranspose2d(8, 16, 2, 2, 0), _x(2, 5, 7, 8)),
    "ConvTranspose2d_k3s2p1": lambda: (JC.ConvTranspose2d(16, 3, 2, 1),
                                       PC.ConvTranspose2d(8, 16, 3, 2, 1), _x(2, 5, 7, 8)),
    "MaxPool2d": lambda: (JC.MaxPool2d(2, 2, 0), PC.MaxPool2d(2, 2, 0), _x(2, 9, 8, 4)),
    "MaxPool2d_k3p1": lambda: (JC.MaxPool2d(3, 2, 1), PC.MaxPool2d(3, 2, 1), _x(2, 9, 8, 4)),
    "ZeroPad2d": lambda: (JC.ZeroPad2d((1, 2, 3, 0)), PC.ZeroPad2d((1, 2, 3, 0)), _x(2, 5, 6, 4)),
    "Identity": lambda: (JC.Identity(), PC.Identity(), _x(2, 5, 6, 4)),
    # block.py: v10
    "SCDown": lambda: (JB.SCDown(32, 3, 2), PB.SCDown(16, 32, 3, 2), _x(2, 9, 9, 16)),
    "RepVGGDW": lambda: (JB.RepVGGDW(16), PB.RepVGGDW(16), _x(2, 9, 9, 16)),
    "CIB": lambda: (JB.CIB(32, True, 0.5, False), PB.CIB(32, 32, True, 0.5, False), _x(2, 8, 8, 32)),
    "CIB_lk": lambda: (JB.CIB(32, True, 1.0, True), PB.CIB(16, 32, True, 1.0, True),
                       _x(2, 8, 8, 16)),
    "C2fCIB": lambda: (JB.C2fCIB(32, 2, True, True), PB.C2fCIB(16, 32, 2, True, True),
                       _x(2, 8, 8, 16)),
    "PSA": lambda: (JB.PSA(128), PB.PSA(128, 128), _x(2, 4, 4, 128)),
    # v5, v8-p6, v8-ghost
    "C2": lambda: (JB.C2(32, 2), PB.C2(16, 32, 2), _x(2, 8, 8, 16)),
    "C3": lambda: (JB.C3(32, 2), PB.C3(16, 32, 2), _x(2, 8, 8, 16)),
    "C3_no_shortcut": lambda: (JB.C3(32, 1, False, 1, 0.25), PB.C3(16, 32, 1, False, 1, 0.25),
                               _x(2, 8, 8, 16)),
    "GhostBottleneck": lambda: (JB.GhostBottleneck(32, 3, 1), PB.GhostBottleneck(32, 32, 3, 1),
                                _x(2, 8, 8, 32)),
    "GhostBottleneck_s2": lambda: (JB.GhostBottleneck(32, 3, 2), PB.GhostBottleneck(16, 32, 3, 2),
                                   _x(2, 9, 9, 16)),
    "C3Ghost": lambda: (JB.C3Ghost(32, 2), PB.C3Ghost(16, 32, 2), _x(2, 8, 8, 16)),
    # v9
    "RepBottleneck": lambda: (JB.RepBottleneck(16, True, 1, (3, 3), 1.0),
                              PB.RepBottleneck(16, 16, True, 1, (3, 3), 1.0), _x(2, 8, 8, 16)),
    "RepCSP": lambda: (JB.RepCSP(32, 2), PB.RepCSP(16, 32, 2), _x(2, 8, 8, 16)),
    "RepNCSPELAN4": lambda: (JB.RepNCSPELAN4(32, 32, 16, 1), PB.RepNCSPELAN4(16, 32, 32, 16, 1),
                             _x(2, 8, 8, 16)),
    "ELAN1": lambda: (JB.ELAN1(32, 32, 16), PB.ELAN1(16, 32, 32, 16), _x(2, 8, 8, 16)),
    "AConv": lambda: (JB.AConv(32), PB.AConv(16, 32), _x(2, 9, 9, 16)),
    "ADown": lambda: (JB.ADown(32), PB.ADown(16, 32), _x(2, 9, 9, 16)),
    "SPPELAN": lambda: (JB.SPPELAN(32, 16), PB.SPPELAN(16, 32, 16), _x(2, 8, 8, 16)),
    "CBLinear": lambda: (JB.CBLinear((8, 16)), PB.CBLinear(16, (8, 16)), _x(2, 8, 8, 16)),
    "CBLinear_k3s2": lambda: (JB.CBLinear((8, 8, 16), 3, 2), PB.CBLinear(16, (8, 8, 16), 3, 2),
                              _x(2, 9, 9, 16)),
    "CBFuse_shrink_and_grow": lambda: (JB.CBFuse((1, 0)), PB.CBFuse((1, 0)), _cbl()),
    # v3, RT-DETR, ResNet backbones
    "SPP": lambda: (JB.SPP(32, (5, 9, 13)), PB.SPP(16, 32, (5, 9, 13)), _x(2, 8, 8, 16)),
    "HGStem": lambda: (JB.HGStem(16, 32), PB.HGStem(3, 16, 32), _x(2, 16, 16, 3)),
    "HGBlock": lambda: (JB.HGBlock(16, 64, 3, 2), PB.HGBlock(32, 16, 64, 3, 2), _x(2, 8, 8, 32)),
    "HGBlock_light_shortcut": lambda: (JB.HGBlock(16, 32, 5, 2, True, True),
                                       PB.HGBlock(32, 16, 32, 5, 2, True, True), _x(2, 8, 8, 32)),
    "RepC3": lambda: (JB.RepC3(32, 2), PB.RepC3(16, 32, 2), _x(2, 8, 8, 16)),
    "RepC3_e05": lambda: (JB.RepC3(32, 1, 0.5), PB.RepC3(16, 32, 1, 0.5), _x(2, 8, 8, 16)),
    "ResNetBlock": lambda: (JB.ResNetBlock(16, 2, 4), PB.ResNetBlock(32, 16, 2, 4), _x(2, 9, 9, 32)),
    "ResNetBlock_basic": lambda: (JB.ResNetBlock(16, 1, 1), PB.ResNetBlock(16, 16, 1, 1),
                                  _x(2, 8, 8, 16)),
    "ResNetLayer_first": lambda: (JB.ResNetLayer(3, 16, 1, True, 1), PB.ResNetLayer(3, 16, 1, True, 1),
                                  _x(2, 16, 16, 3)),
    "ResNetLayer": lambda: (JB.ResNetLayer(16, 8, 2, False, 2), PB.ResNetLayer(16, 8, 2, False, 2),
                            _x(2, 8, 8, 16)),
    # head.py
    "v10Detect": lambda: (JH.v10Detect(nc=3, ch=(16, 32, 64), legacy=False),
                          PH.v10Detect(3, ch=(16, 32, 64), legacy=False),
                          [_x(2, 8, 8, 16), _x(2, 4, 4, 32, seed=2), _x(2, 2, 2, 64, seed=3)]),
}


@functools.lru_cache(maxsize=None)
def _case_variables(case):
    """The JAX variables of a case (shared by its eval and train runs)."""
    jax_module, _, xs = MODULE_CASES[case]()
    return _variables(jax_module, _to_jax(xs))


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("case", list(MODULE_CASES))
def test_module_matches_jax(case, mode):
    jax_module, port_module, xs = MODULE_CASES[case]()
    jx = _to_jax(xs)
    variables = _case_variables(case)
    port_module.load_state_dict(from_jax_variables(variables), strict=True)
    train = mode == "train"
    port_module.train(train)
    with torch.no_grad():
        got = port_module(_to_port(xs))
    if not train:
        _compare(got, jax_module.apply(variables, jx, train=False))
        return
    want, updates = jax_module.apply(variables, jx, train=True, mutable=["batch_stats"])
    _compare(got, want)
    stats = from_jax_variables(jax.device_get(dict(updates)))
    own = port_module.state_dict()
    assert set(stats) == {k for k in own if "running_" in k or "num_batches" in k}
    for k, w in stats.items():
        if "running_" in k:
            np.testing.assert_allclose(own[k].numpy(), w.numpy(), rtol=0, atol=ATOL, err_msg=k)


# ---- (b) fused modules -----------------------------------------------------------------------

FUSED_CASES = ("Conv2", "Conv2_stride2_groups", "RepConv", "RepVGGDW", "CIB_lk", "RepC3",
               "RepNCSPELAN4")


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_module_matches_jax(case):
    jax_module, port_module, x = MODULE_CASES[case]()
    jx = jnp.asarray(x)
    variables = _case_variables(case)
    port_module.load_state_dict(from_jax_variables(variables), strict=True)
    fused = fuse_model(port_module.eval())
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in fused.modules())
    fvars = fuse_variables(variables)
    with JC.fused_mode(True):
        want = jax_module.apply(fvars, jx, train=False)
    with torch.no_grad():
        _compare(fused(_nchw(x)), want)
    bridged = from_jax_variables(jax.device_get(fvars))
    own = fused.state_dict()
    assert set(bridged) == set(own)
    for k, v in bridged.items():
        torch.testing.assert_close(own[k], v, rtol=1e-5, atol=1e-6, msg=k)


# ---- (c) graphs: parse_model at every scale --------------------------------------------------

SCALED = ("yolov5", "yolov5-p6", "yolov6", "yolov8-ghost", "yolov8-ghost-p2", "yolov8-ghost-p6",
          "yolov8-p6")
UNSCALED = ("yolov3", "yolov3-spp", "yolov3-tiny", "yolov9t", "yolov9s", "yolov9m", "yolov9c",
            "yolov9e", "yolov10n", "yolov10s", "yolov10m", "yolov10b", "yolov10l", "yolov10x",
            "tinyv10")
ALL_NAMES = [f"{stem[:6]}{s}{stem[6:]}.yaml" for stem in SCALED for s in "nsmlx"] + \
    [f"{stem}.yaml" for stem in UNSCALED]


@pytest.mark.parametrize("name", ALL_NAMES)
def test_parse_model_matches_jax(name):
    jd = yaml_model_load(name)
    pd = model_config(name)
    assert pd == {k: v for k, v in jd.items() if k != "yaml_file"}
    j_specs, j_save, j_meta = jax_parse_model(jd)
    p_specs, p_save, p_meta = parse_model(pd)

    def rows(specs):
        return [(s.i, s.f, s.name, s.args, s.c2, s.kwargs) for s in specs]

    assert rows(p_specs) == rows(j_specs)
    assert p_save == j_save
    assert p_meta == j_meta
    with torch.device("meta"):
        model, meta = build_model(name)
    assert meta["task"] == "detect" and len(meta["strides"]) == meta["nl"]


def test_cbfuse_resize_is_jax_nearest():
    """`resize_nearest` equals `jax.image.resize(..., "nearest")` on shrinking, growing and
    non-integer ratios, where `F.interpolate(mode="nearest")` picks other pixels."""
    x = _x(1, 11, 7, 2)
    for h, w in ((6, 4), (16, 12), (11, 3), (5, 7)):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (1, h, w, 2), "nearest"))
        got = PB.resize_nearest(_nchw(x), h, w).numpy().transpose(0, 2, 3, 1)
        np.testing.assert_array_equal(got, want)
    plain = torch.nn.functional.interpolate(_nchw(x), size=(6, 4), mode="nearest")
    assert not np.array_equal(plain.numpy().transpose(0, 2, 3, 1),
                              np.asarray(jax.image.resize(jnp.asarray(x), (1, 6, 4, 2), "nearest")))


def test_repeat_copies_take_flax_names():
    """yolov6n's repeated Convs and yolov3's repeated Bottlenecks sit in a `Repeat` whose
    copies carry Flax's automatic names, so the bridge maps them one to one."""
    model, _ = build_model("yolov6n.yaml")
    assert [n for n, _ in model.blocks[2].named_children()] == ["Conv_0", "Conv_1"]
    m3 = copy.deepcopy(model_config("yolov3.yaml"))
    specs, _, _ = parse_model(m3)
    assert dict(specs[4].kwargs)["repeat"] == 2 and specs[4].name == "Bottleneck"


def test_new_convs_follow_compute_dtype():
    """Under a bf16 compute dtype (amp, `half`) yolov6n's transposed convs and yolov9t's
    RepConv blocks compute in bf16 as every Conv2d does, folded or not."""
    for name in ("yolov6n.yaml", "yolov9t.yaml"):
        model, _ = build_model(name, dtype=torch.bfloat16)
        assert all(m.compute_dtype == torch.bfloat16 for m in model.modules()
                   if isinstance(m, (PC.Conv2d, PC.ConvTranspose)))
        assert any(isinstance(m, PC.ConvTranspose) for m in model.modules()) == (name == "yolov6n.yaml")
        fused = fuse_model(copy.deepcopy(model))
        with torch.no_grad():
            maps = fused(torch.rand(1, 3, 64, 64))
        assert all(m.dtype == torch.bfloat16 for m in maps)
        assert all(m.compute_dtype == torch.bfloat16 for m in fused.modules()
                   if isinstance(m, PC.Conv2d))
