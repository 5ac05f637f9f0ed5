"""Per-module forward parity of the PyTorch port against the JAX package.

Each case builds the JAX module and its port, fills the JAX variables from a
numpy seed (every parameter and BN statistic, including the FullPAD gate and
the A2C2f gamma, away from their init values), moves them into the port
through `utils/convert.py`, and compares eval-mode outputs on the same numpy
input. Tolerance: 1e-4 absolute in float32, the bound the repo's parity tests
use. Also: the port's `parse_model` and config dicts against the JAX ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sar_yolo_tpu.nn.modules import block as JB
from sar_yolo_tpu.nn.modules import conv as JC
from sar_yolo_tpu.nn.modules import head as JH
from sar_yolo_tpu.nn.tasks import parse_model as jax_parse_model
from sar_yolo_tpu.nn.tasks import yaml_model_load
from sar_yolo_tpu.utils import ROOT as JAX_ROOT
from sar_yolo_tpu_torch.cfg.models import model_config
from sar_yolo_tpu_torch.nn.modules import block as PB
from sar_yolo_tpu_torch.nn.modules import conv as PC
from sar_yolo_tpu_torch.nn.modules import head as PH
from sar_yolo_tpu_torch.nn.tasks import parse_model
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from torch_port_common import fill_variables, one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = 1e-4


def jax_variables(module, x, seed: int = 0):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x, train=False))
    return fill_variables(shapes, np.random.default_rng(seed))


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def check(jax_module, port_module, xs, seed: int = 0):
    """Compare jax_module(xs) with port_module(xs) under the same variables."""
    single = not isinstance(xs, list)
    jx = jnp.asarray(xs) if single else [jnp.asarray(x) for x in xs]
    variables = jax_variables(jax_module, jx, seed)
    port_module.load_state_dict(from_jax_variables(variables), strict=True)
    port_module.eval()
    want = jax_module.apply(variables, jx, train=False)
    with torch.no_grad():
        got = port_module(_nchw(xs) if single else [_nchw(x) for x in xs])
    want = [want] if not isinstance(want, list) else want
    got = [got] if not isinstance(got, list) else got
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


MODULE_CASES = {
    "Conv": lambda: (JC.Conv(16, 3, 2), PC.Conv(8, 16, 3, 2), _x(2, 8, 8, 8)),
    "Conv_dilated": lambda: (JC.Conv(16, 3, 1, 1, 1, 2), PC.Conv(8, 16, 3, 1, 1, 1, 2),
                             _x(2, 8, 8, 8)),
    "DWConv": lambda: (JC.DWConv(16, 3), PC.DWConv(8, 16, 3), _x(2, 8, 8, 8)),
    "DSConv": lambda: (JC.DSConv(16, 3, 2), PC.DSConv(8, 16, 3, 2), _x(2, 9, 9, 8)),
    "DSConv_dilated": lambda: (JC.DSConv(16, 5, 1, d=2), PC.DSConv(8, 16, 5, 1, d=2),
                               _x(2, 8, 8, 8)),
    "AAttn": lambda: (JB.AAttn(64, 2, 4), PB.AAttn(64, 2, 4), _x(2, 8, 8, 64)),
    "ABlock": lambda: (JB.ABlock(64, 2, 1.2, 4), PB.ABlock(64, 2, 1.2, 4), _x(2, 8, 8, 64)),
    "A2C2f": lambda: (JB.A2C2f(128, 1, True, 4), PB.A2C2f(64, 128, 1, True, 4),
                      _x(2, 8, 8, 64)),
    "A2C2f_residual": lambda: (JB.A2C2f(128, 2, True, 1, True, 1.5),
                               PB.A2C2f(128, 128, 2, True, 1, True, 1.5), _x(1, 4, 4, 128)),
    "A2C2f_c3k": lambda: (JB.A2C2f(64, 1, False, 1), PB.A2C2f(32, 64, 1, False, 1),
                          _x(2, 8, 8, 32)),
    "DSC3k2": lambda: (JB.DSC3k2(32, 2, False, 0.25), PB.DSC3k2(16, 32, 2, False, 0.25),
                       _x(2, 8, 8, 16)),
    "DSC3k2_dsc3k": lambda: (JB.DSC3k2(32, 1, True), PB.DSC3k2(16, 32, 1, True),
                             _x(2, 8, 8, 16)),
    "C2f": lambda: (JB.C2f(32, 2, True), PB.C2f(16, 32, 2, True), _x(2, 8, 8, 16)),
    "SPPF": lambda: (JB.SPPF(32, 5), PB.SPPF(16, 32, 5), _x(2, 8, 8, 16)),
    "C3AH": lambda: (JB.C3AH(32, 1.0, 4), PB.C3AH(48, 32, 1.0, 4), _x(2, 8, 8, 48)),
    "DownsampleConv": lambda: (JB.DownsampleConv(32), PB.DownsampleConv(32), _x(2, 8, 8, 32)),
    "FullPAD_Tunnel": lambda: (JB.FullPAD_Tunnel(), PB.FullPAD_Tunnel(),
                               [_x(2, 8, 8, 16), _x(2, 8, 8, 16, seed=2)]),
    "HyperACE_3scale": lambda: (
        JB.HyperACE(64, 64, 1, 4, True, True, 0.5, 1, "both"),
        PB.HyperACE((32, 64, 128), 64, 64, 1, 4, True, True, 0.5, 1, "both"),
        [_x(1, 16, 16, 32), _x(1, 8, 8, 64, seed=2), _x(1, 4, 4, 128, seed=3)]),
    "HyperACE_4scale": lambda: (
        JB.HyperACE(64, 64, 2, 4, True, True, 0.5, 1, "both"),
        PB.HyperACE((16, 32, 64, 128), 64, 64, 2, 4, True, True, 0.5, 1, "both"),
        [_x(1, 32, 32, 16), _x(1, 16, 16, 32, seed=2), _x(1, 8, 8, 64, seed=3),
         _x(1, 4, 4, 128, seed=4)]),
    "JDE": lambda: (
        JH.JDE(nc=1, embed_dim=32, state_classes=6, ch=(32, 64, 128), legacy=False),
        PH.JDE(1, 32, 6, ch=(32, 64, 128), legacy=False),
        [_x(1, 8, 8, 32), _x(1, 4, 4, 64, seed=2), _x(1, 2, 2, 128, seed=3)]),
    "JDE_legacy": lambda: (
        JH.JDE(nc=2, embed_dim=16, state_classes=6, ch=(16, 32, 32), legacy=True),
        PH.JDE(2, 16, 6, ch=(16, 32, 32), legacy=True),
        [_x(1, 8, 8, 16), _x(1, 4, 4, 32, seed=2), _x(1, 2, 2, 32, seed=3)]),
}


@pytest.mark.parametrize("case", list(MODULE_CASES))
def test_module_forward_matches_jax(case):
    jax_module, port_module, xs = MODULE_CASES[case]()
    check(jax_module, port_module, xs)


CONFIGS = {"yolov13-JDE.yaml": "v13/yolov13-JDE.yaml",
           "yolov13-JDE_P24.yaml": "v13/yolov13-JDE_P24.yaml",
           "tinyjde.yaml": "test/tinyjde.yaml"}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_dict_equals_jax_yaml(name):
    with open(JAX_ROOT / "cfg" / "models" / CONFIGS[name]) as f:
        want = yaml.safe_load(f)
    got = model_config(name)
    assert got.pop("scale") == ""
    assert got == want


@pytest.mark.parametrize("name", ["yolov13n-JDE.yaml", "yolov13n-JDE_P24.yaml",
                                  "yolov13s-JDE.yaml", "yolov13l-JDE.yaml", "tinyjde.yaml"])
def test_parse_model_matches_jax(name):
    jd = yaml_model_load(name)
    pd = model_config(name)
    assert pd["scale"] == jd["scale"]
    j_specs, j_save, j_meta = jax_parse_model(jd)
    p_specs, p_save, p_meta = parse_model(pd)

    def rows(specs):
        return [(s.i, s.f, s.name, s.args, s.c2, s.kwargs) for s in specs]

    assert rows(p_specs) == rows(j_specs)
    assert p_save == j_save
    assert p_meta == j_meta
