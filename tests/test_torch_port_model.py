"""Whole-model parity of the PyTorch port against the JAX package.

yolov13n-JDE and tinyjde: the JAX variables are filled from a numpy seed,
moved into the port through `utils/convert.py`, and the per-level head maps
must agree to 1e-4 absolute in float32 (the bound the repo's parity tests
use), unfused and BN-folded (`nn/fuse.py` against `fuse_variables`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.nn.fuse import fuse as jax_fuse
from sar_yolo_tpu.nn.tasks import build_model as jax_build_model
from sar_yolo_tpu_torch.nn.fuse import fuse_model
from sar_yolo_tpu_torch.nn.tasks import build_model
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from torch_port_common import fill_variables, one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = 1e-4


def _jax_model(name, seed=0, imgsz=64):
    model, meta = jax_build_model(name)
    x = jnp.zeros((1, imgsz, imgsz, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False))
    return model, fill_variables(shapes, np.random.default_rng(seed))


@pytest.fixture(scope="module", params=[("yolov13n-JDE.yaml", 96), ("tinyjde.yaml", 64)],
                ids=["yolov13n-JDE", "tinyjde"])
def pair(request):
    """(jax model, variables, port model with the same weights, input, jax output maps)."""
    name, imgsz = request.param
    jmodel, variables = _jax_model(name)
    pmodel, _ = build_model(name)
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    x = np.random.default_rng(1).uniform(0, 1, (2, imgsz, imgsz, 3)).astype(np.float32)
    return jmodel, variables, pmodel, x


def _compare(jax_maps, port_maps):
    assert len(jax_maps) == len(port_maps)
    for w, g in zip(jax_maps, port_maps):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)


def _port_forward(model, x):
    with torch.no_grad():
        return model(torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))


def test_forward_unfused_matches_jax(pair):
    jmodel, variables, pmodel, x = pair
    _compare(jmodel.apply(variables, jnp.asarray(x), train=False), _port_forward(pmodel, x))


def test_forward_fused_matches_jax(pair):
    import copy

    jmodel, variables, pmodel, x = pair
    fmodel, fvars = jax_fuse(jmodel, variables)
    fused = fuse_model(copy.deepcopy(pmodel))
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in fused.modules())
    _compare(fmodel.apply(fvars, jnp.asarray(x), train=False), _port_forward(fused, x))
    # the bridge maps the JAX fused tree onto the port's fused structure, strictly
    bridged = from_jax_variables(jax.device_get(fvars))
    own = fused.state_dict()
    assert set(bridged) == set(own)
    for k, v in bridged.items():
        torch.testing.assert_close(own[k], v, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["yolov13n-JDE.yaml", "yolov13n-JDE_P24.yaml", "tinyjde.yaml"])
def test_parameter_count_and_strict_bridge(name):
    _, variables = _jax_model(name)
    pmodel, meta = build_model(name)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in pmodel.parameters()) == n_jax
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    assert meta["strides"] == ([4, 8, 16, 32] if "P24" in name else [8, 16, 32])


def test_bridge_rejects_unknown_leaves():
    _, variables = _jax_model("tinyjde.yaml")
    variables["params"]["blocks_0"]["conv"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        from_jax_variables(variables)
    del variables["params"]["blocks_0"]["conv"]["extra"]
    del variables["batch_stats"]["blocks_0"]
    pmodel, _ = build_model("tinyjde.yaml")
    with pytest.raises(RuntimeError, match="Missing key"):
        pmodel.load_state_dict(from_jax_variables(variables), strict=True)
