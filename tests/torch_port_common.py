"""Shared helpers of the `test_torch_port_*.py` files (the PyTorch port against the JAX package)."""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per test: the suite runs several pytest workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fill_variables(tree, rng):
    """Numpy values for every leaf of a JAX variables tree of ShapeDtypeStructs.

    Every parameter and BN statistic moves away from its init value (the
    FullPAD gate and the A2C2f gamma included), so no branch hides behind a
    zero or an identity.
    """
    out = {}
    for key, val in tree.items():
        if hasattr(val, "items"):
            out[key] = fill_variables(val, rng)
            continue
        shape = tuple(val.shape)
        if key == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            a = rng.uniform(-1, 1, shape) / np.sqrt(fan_in)  # the JAX conv init's range
        elif key in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif key == "gate":
            a = rng.uniform(0.5, 1.0, shape)
        elif key == "prototype_base":
            a = rng.standard_normal(shape) * np.sqrt(2.0 / sum(shape))
        else:  # bias, mean, gamma
            a = rng.normal(0.0, 0.1, shape)
        out[key] = a.astype(np.float32)
    return out
