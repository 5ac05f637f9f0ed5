"""The forward maps of the v3, v5, v6, v8-ghost / p2 / p6 and v9 detect graphs in the PyTorch
port against the JAX package (their modules and `parse_model`:
`test_torch_port_detect_family.py`; the v10 graphs: `test_torch_port_v10.py`).

`test_forward_matches_jax`: the eval forward maps of each file at scale n (or as the file
is, without scales), 64 px, batch 1, from `fill_variables` weights through the strict
bridge, 1e-4 absolute in float32, unfused, with the parameter count. yolov9e is the one
graph with CBLinear / CBFuse (a tuple in the save dict, chunks resized down and up).
yolov3 and yolov3-spp (62-105M parameters, no scales) are held by `parse_model` alone:
their modules (repeated Bottlenecks, SPP) are in the module tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.nn.tasks import build_model as jax_build_model
from sar_yolo_tpu_torch.nn.tasks import build_model
from sar_yolo_tpu_torch.utils.convert import from_jax_variables
from torch_port_common import fill_variables, one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = 1e-4
FORWARD = ["yolov5n.yaml", "yolov5n-p6.yaml", "yolov6n.yaml", "yolov8n-ghost.yaml",
           "yolov8n-ghost-p2.yaml", "yolov8n-ghost-p6.yaml", "yolov8n-p6.yaml", "yolov3-tiny.yaml",
           "yolov9t.yaml", "yolov9s.yaml", "yolov9m.yaml", "yolov9c.yaml", "yolov9e.yaml"]


@pytest.mark.parametrize("name", FORWARD)
def test_forward_matches_jax(name):
    jmodel, _ = jax_build_model(name)
    x = np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                train=False))
    variables = fill_variables(shapes, np.random.default_rng(0))
    pmodel, meta = build_model(name)
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in pmodel.parameters()) == n_jax
    with torch.no_grad():
        got = pmodel(torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    want = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=False))(variables, jnp.asarray(x))
    assert len(got) == len(want) == meta["nl"]
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)
