"""Area attention of the PyTorch port against the JAX package.

The same numpy inputs go through the JAX einsum `area_attention`, the Pallas
kernel in interpret mode, and the port's plain version and kernel wrapper.
Tolerance: 1e-4 absolute in float32, the bound the repo's parity tests use.
The CUDA case compares the hand-written kernel with the plain version and
runs only where a card is present.
"""

import numpy as np
import pytest
import torch

from sar_yolo_tpu_torch.ops.cuda.flash_attention import area_attention_plain, flash_area_attention
from torch_port_common import one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = 1e-4

# (B, N, C, heads, area): the shapes of tests/test_ops.py's flash test, the
# yolov13n-JDE @640 chunks (Na = 400 at P4 with area 4, P5 with area 1) and,
# einsum only, the P24 @1280 chunks (Na = 1600)
SHAPES = [(2, 64, 64, 2, 1), (2, 256, 64, 2, 4), (1, 100, 32, 1, 1),
          (1, 1600, 64, 2, 4), (1, 400, 128, 4, 1)]
SHAPES_1600 = [(1, 6400, 64, 2, 4), (1, 1600, 128, 4, 1)]


def _qkv(shape, seed=0):
    B, N, C, _, _ = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, C)).astype(np.float32) for _ in range(3)]


def _t(a, requires_grad=False):
    return torch.tensor(a, requires_grad=requires_grad)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_jax_einsum_and_pallas_interpret(shape):
    import jax.numpy as jnp

    from sar_yolo_tpu.nn.modules.block import area_attention
    from sar_yolo_tpu.ops.pallas import flash_area_attention as pallas_attention

    _, _, _, heads, area = shape
    q, k, v = _qkv(shape)
    ref = np.asarray(area_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, area))
    pallas = np.asarray(pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                                         area, interpret=True))
    got = area_attention_plain(_t(q), _t(k), _t(v), heads, area).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES_1600, ids=str)
def test_plain_matches_jax_einsum_at_p24_chunks(shape):
    import jax.numpy as jnp

    from sar_yolo_tpu.nn.modules.block import area_attention

    _, _, _, heads, area = shape
    q, k, v = _qkv(shape, seed=1)
    ref = np.asarray(area_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, area))
    got = area_attention_plain(_t(q), _t(k), _t(v), heads, area).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[4]], ids=str)
def test_autograd_function_gradients_match_jax_grad(shape):
    import jax
    import jax.numpy as jnp

    from sar_yolo_tpu.nn.modules.block import area_attention

    _, _, _, heads, area = shape
    q, k, v = _qkv(shape, seed=2)
    w = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)

    def loss(qq, kk, vv):
        return jnp.sum(area_attention(qq, kk, vv, heads, area) * w)

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    (flash_area_attention(tq, tk, tv, heads, area) * _t(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_wrapper_takes_plain_path_for_cpu_tensors():
    shape = SHAPES[1]
    _, _, _, heads, area = shape
    q, k, v = (_t(a) for a in _qkv(shape, seed=4))
    before = flash_area_attention.launches
    got = flash_area_attention(q, k, v, heads, area)
    assert flash_area_attention.launches == before
    torch.testing.assert_close(got, area_attention_plain(q, k, v, heads, area), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_cuda_kernel_matches_plain(dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    # (B, C, H, W, heads, area): yolov13n-JDE @640 P4 and P5, JDE_P24 @1280 P4 and P5
    for B, C, H, W, heads, area in [(2, 64, 40, 40, 2, 4), (2, 128, 20, 20, 4, 1),
                                    (1, 64, 80, 80, 2, 4), (1, 128, 40, 40, 4, 1)]:
        qk = torch.randn(B, 2 * C, H, W, device="cuda", generator=g).to(dtype)
        vm = torch.randn(B, C, H, W, device="cuda", generator=g).to(dtype)
        tokens = qk.flatten(2).transpose(1, 2)  # the strided views AAttn passes
        q, k, v = tokens[..., :C], tokens[..., C:], vm.flatten(2).transpose(1, 2)
        before = flash_area_attention.launches
        got = flash_area_attention(q, k, v, heads, area)
        assert flash_area_attention.launches == before + 1
        want = area_attention_plain(q, k, v, heads, area)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= atol, (B, C, H, W, dtype, err)
