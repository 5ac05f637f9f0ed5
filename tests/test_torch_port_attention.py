"""Area attention of the PyTorch port against the JAX package.

The same numpy inputs go through the JAX einsum `area_attention`, the Pallas
kernel in interpret mode, and the port's plain version and kernel wrapper.
Tolerance: 1e-4 absolute in float32, the bound the repo's parity tests use.
The CUDA case compares the hand-written kernel with the plain version and
runs only where a card is present. On the CPU, a numpy emulation of the
kernel's split-TF32 arithmetic pins why float32 takes three TF32 products,
and the launch geometry is checked at the on-path and unaligned shapes.
"""

import numpy as np
import pytest
import torch

from sar_yolo_tpu_torch.ops.cuda.flash_attention import (area_attention_plain,
                                                         flash_area_attention, geometry_of,
                                                         launch_geometry, library_geometry)
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


# (B, C, H, W, heads, area, layout) for the CUDA case: yolov13n-JDE @640 P4 and P5,
# JDE_P24 @1280 P4 and P5 as AAttn passes them (token-contiguous channel slices
# of NCHW maps); channel-contiguous (B, N, C) inputs; imgsz 480 P4 (Na = 225:
# chunk starts not 16-byte aligned); imgsz 320 P4 (Na = 100); a chunk shorter
# than one 128-key stage (Na = 25)
CUDA_SHAPES = [(2, 64, 40, 40, 2, 4, "tokens"), (2, 128, 20, 20, 4, 1, "tokens"),
               (1, 64, 80, 80, 2, 4, "tokens"), (1, 128, 40, 40, 4, 1, "tokens"),
               (2, 64, 40, 40, 2, 4, "channels"), (2, 64, 30, 30, 2, 4, "tokens"),
               (2, 64, 20, 20, 2, 4, "tokens"), (1, 32, 5, 5, 1, 1, "tokens")]


def _views(qk, vm, layout):
    """q, k, v as AAttn passes them (token-contiguous), or channel-contiguous copies."""
    C = vm.shape[1]
    tokens = qk.flatten(2).transpose(1, 2)
    q, k, v = tokens[..., :C], tokens[..., C:], vm.flatten(2).transpose(1, 2)
    if layout == "channels":
        q, k, v = (t.contiguous() for t in (q, k, v))
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_cuda_kernel_matches_plain(dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, C, H, W, heads, area, layout in CUDA_SHAPES:
        qk = torch.randn(B, 2 * C, H, W, device="cuda", generator=g).to(dtype)
        vm = torch.randn(B, C, H, W, device="cuda", generator=g).to(dtype)
        q, k, v = _views(qk, vm, layout)
        assert library_geometry(q, k, v, heads, area) == geometry_of(q, k, v, heads, area)
        before = flash_area_attention.launches
        got = flash_area_attention(q, k, v, heads, area)
        assert flash_area_attention.launches == before + 1
        want = area_attention_plain(q, k, v, heads, area)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= atol, (B, C, H, W, layout, dtype, err)


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away: cvt.rna.tf32.f32."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _matmul_split_tf32(a, b):
    """a @ b as the kernel computes it: x = hi + lo, lo·hi + hi·lo + hi·hi summed in float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _matmul_one_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _attention(q, k, v, matmul):
    """The kernel's order: scaled scores, unnormalised exponentials, p v, then / sum."""
    s = matmul(q, k.T) * q.dtype.type(32 ** -0.5)
    p = np.exp(s - s.max(-1, keepdims=True))
    return matmul(p, v) / p.sum(-1, keepdims=True)



def test_split_tf32_keeps_float32_accuracy_where_one_tf32_pass_does_not():
    # the 640 P4 chunk (Na = 400, 2 heads of 32 channels), randn as chip_smoke draws
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((400, 64)).astype(np.float32) for _ in range(3))
    err_split = err_one = 0.0
    for h in range(2):
        qh, kh, vh = (t[:, 32 * h:32 * h + 32] for t in (q, k, v))
        ref = _attention(*(t.astype(np.float64) for t in (qh, kh, vh)), np.matmul)
        err_split = max(err_split, np.abs(_attention(qh, kh, vh, _matmul_split_tf32) - ref).max())
        err_one = max(err_one, np.abs(_attention(qh, kh, vh, _matmul_one_tf32) - ref).max())
    assert err_split <= 1e-5, err_split
    assert err_one > 1e-4, err_one


def _token_view_geometry(B, C, H, W, heads, area, dtype, layout="tokens"):
    qk, vm = torch.zeros(B, 2 * C, H, W, dtype=dtype), torch.zeros(B, C, H, W, dtype=dtype)
    N = H * W
    q, k, v = _views(qk, vm, layout)
    # offsets as the wrapper takes them, from storage offsets (storages start 16-byte aligned)
    offsets = [t.storage_offset() * t.element_size() % 16 // t.element_size() for t in (k, v)]
    geo = launch_geometry((B, N, C), area, heads, (k.stride(), v.stride()), offsets, dtype)
    assert geo == geometry_of(q, k, v, heads, area)  # CPU allocations are 16-byte aligned
    return geo


@pytest.mark.parametrize("dtype,itemsize", [(torch.float32, 4), (torch.bfloat16, 2)])
@pytest.mark.parametrize("shape,grid,splits", [
    ((1, 64, 40, 40, 2, 4), (13, 2, 4), 4),     # 640 P4 b1: 200 query tiles, keys split 4 ways
    ((1, 128, 20, 20, 4, 1), (13, 4, 1), 4),    # 640 P5 b1: 100
    ((4, 64, 40, 40, 2, 4), (4, 2, 16), 1),     # 640 P4 b4: 800, 8 query tiles a block
    ((4, 128, 20, 20, 4, 1), (7, 4, 4), 2),     # 640 P5 b4: 400
    ((8, 64, 40, 40, 2, 4), (4, 2, 32), 1),     # 640 P4 b8: 1600
    ((1, 64, 80, 80, 2, 4), (13, 2, 4), 1),     # 1280 P4 b1: Na = 1600, 800 query tiles
    ((1, 128, 40, 40, 4, 1), (25, 4, 1), 2),    # 1280 P5 b1: 400
], ids=str)
def test_launch_geometry_on_path(shape, grid, splits, dtype, itemsize):
    geo = _token_view_geometry(*shape, dtype)
    assert geo == {"grid": grid, "warps": 8, "splits": splits, "stage_bytes": 16,
                   "smem_bytes": 2 * 2 * 32 * 136 * itemsize}


@pytest.mark.parametrize("shape,layout,dtype,stage_bytes", [
    ((2, 64, 30, 30, 2, 4), "tokens", torch.float32, 4),     # 480 P4: chunk starts 900a bytes
    ((2, 64, 30, 30, 2, 4), "tokens", torch.bfloat16, 0),    # 450a bytes: element copies
    ((2, 64, 20, 20, 2, 4), "tokens", torch.float32, 16),    # 320 P4: Na = 100
    ((2, 64, 20, 20, 2, 4), "tokens", torch.bfloat16, 8),    # 200a bytes
    ((1, 32, 5, 5, 1, 1), "tokens", torch.float32, 4),       # Na = 25: channel stride 100 bytes
    ((2, 64, 40, 40, 2, 4), "channels", torch.float32, 0),   # channel-contiguous
    ((2, 64, 40, 40, 2, 4), "channels", torch.bfloat16, 0),
    # test-time augmentation at 640: the 0.83 pass at 544 (Na = 289: 1156-byte f32 chunks,
    # 578-byte bf16 ones) and the 0.67 pass at 448 (Na = 196), P4 and P5, batch 1 and 16
    ((1, 64, 34, 34, 2, 4), "tokens", torch.float32, 4),
    ((1, 64, 34, 34, 2, 4), "tokens", torch.bfloat16, 0),
    ((1, 128, 17, 17, 4, 1), "tokens", torch.float32, 4),
    ((1, 128, 17, 17, 4, 1), "tokens", torch.bfloat16, 0),
    ((16, 64, 34, 34, 2, 4), "tokens", torch.float32, 4),
    ((1, 64, 28, 28, 2, 4), "tokens", torch.float32, 16),
    ((1, 64, 28, 28, 2, 4), "tokens", torch.bfloat16, 8),
    ((1, 128, 14, 14, 4, 1), "tokens", torch.float32, 16),
    ((1, 128, 14, 14, 4, 1), "tokens", torch.bfloat16, 8),
    ((16, 128, 14, 14, 4, 1), "tokens", torch.bfloat16, 8),
], ids=str)
def test_launch_geometry_staging_width(shape, layout, dtype, stage_bytes):
    geo = _token_view_geometry(*shape, dtype, layout=layout)
    assert geo["stage_bytes"] == stage_bytes
    B, C, H, W, heads, area = shape
    assert geo["grid"][1:] == (heads, B * area)
    per_block = geo["warps"] // geo["splits"] * 16  # query rows of a block
    assert H * W // area <= geo["grid"][0] * per_block < H * W // area + per_block
