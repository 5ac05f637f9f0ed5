"""The int8 path's quantization and operand layout in the PyTorch port against the JAX
package (CPU).

(i) `int8_quantize_plain` against JAX's quantization in `Int8Conv2D` (its xq read off its
    `conv_general_dilated` call, its sx from the expression of its line 119, which must give
    that same xq): xq and sx equal, float32 and bf16 inputs, a sample of zeros (the 1e-12
    clamp), values on exact .5 ties (sx = 1 and 2), channels padded to 1, 4 and 16.
(ii) The kernels' layout: activations quantized with their channels padded (16, or 4 for
    C_in <= 4) and weights packed by `quantize_weight` give the same int32 sums as the
    unpadded operands, equal to JAX's; `Int8Conv2d.quantized_weight` re-packs when the
    weights or the bias change.
(iii) `Int8Conv2d` layer by layer: every quantized convolution of yolov13n-JDE (seeded port
    weights; tinydet's and tinyjde's are held through their maps in `test_torch_port_int8.py`),
    on the input it receives inside the port's int8 forward, against JAX's eager `Int8Conv2D`
    with the same parameters on that input: xq, sx, wq and the int32 sums equal, the output
    within 1e-6 of its largest magnitude. (Eager: under `jax.jit` XLA turns the division by
    127 into a product with its reciprocal, and sx moves by an ulp.)
(iv) The launch geometry of the quantize kernel and the conv kernel's tile choice (pure
    arithmetic: the card runs them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu_torch.nn.modules.conv import Conv2d, Int8Conv2d, autopad
from sar_yolo_tpu_torch.ops.cuda import int8_conv as ic
from test_torch_port_int8 import _jax_int8
from torch_port_common import one_torch_thread  # noqa: F401


def _jax_sx(x_nhwc, xq):
    """JAX's sx (B,) of a float NHWC input, by the expression of `Int8Conv2D`'s line 119,
    which must give JAX's recorded `xq` (by its line 120)."""
    xf = jnp.asarray(x_nhwc).astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=(1, 2, 3), keepdims=True), 1e-12) / 127.0
    np.testing.assert_array_equal(
        np.asarray(jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)), xq)
    return np.asarray(sx).reshape(-1)


def _jax_quantize(x_nhwc, monkeypatch):
    """JAX's (xq NHWC int8, sx (B,)) of a float NHWC input, through `Int8Conv2D`."""
    c = x_nhwc.shape[-1]
    w = np.eye(c, dtype=np.float32).reshape(1, 1, c, c)
    _, seen = _jax_int8(x_nhwc, w, np.zeros(c, np.float32), 1, 1, 1, x_nhwc.dtype, monkeypatch)
    return seen["xq"], _jax_sx(x_nhwc, seen["xq"])


def _sample(case: str, rng):
    """(2, 5, 7, C) NHWC float32 inputs."""
    c = 5
    if case == "normal":
        return (rng.standard_normal((2, 5, 7, c)) * np.array([0.3, 40.0]).reshape(2, 1, 1, 1)
                ).astype(np.float32)
    if case == "zeros":  # sample 1 all zeros: sx = 1e-12 / 127, xq = 0
        x = rng.standard_normal((2, 5, 7, c)).astype(np.float32)
        x[1] = 0.0
        return x
    # exact ties: amax 127 gives sx = 1, amax 254 gives sx = 2 (x / sx lands on k + .5)
    top, step = {"ties": (127.0, 1.0), "ties_sx2": (254.0, 2.0)}[case]
    k = rng.integers(-126, 126, (2, 5, 7, c)).astype(np.float32)
    x = (k + 0.5) * step
    x[:, 0, 0, 0] = [top, -top]
    return x.astype(np.float32)


@pytest.mark.parametrize("pad_to", [1, 4, 16])
@pytest.mark.parametrize("case", ["normal", "zeros", "ties", "ties_sx2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_plain_matches_jax(dtype, case, pad_to, monkeypatch):
    x = _sample(case, np.random.default_rng(len(case) * 10 + pad_to))
    if dtype == "bfloat16":  # the same values in both packages: bf16-representable
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        assert not case.startswith("ties") or np.abs(x - _sample(case, np.random.default_rng(
            len(case) * 10 + pad_to))).max() == 0
    want_xq, want_sx = _jax_quantize(jnp.asarray(x).astype(getattr(jnp, dtype)), monkeypatch)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    xq, sx = ic.int8_quantize_plain(xt, pad_to)
    c = x.shape[-1]
    assert xq.dtype == torch.int8 and xq.shape == (2, 5, 7, -(-c // pad_to) * pad_to)
    assert sx.dtype == torch.float32 and sx.shape == (2,)
    np.testing.assert_array_equal(xq[..., :c].numpy(), want_xq)
    assert not xq[..., c:].any()
    np.testing.assert_array_equal(sx.numpy(), want_sx)
    assert torch.equal(ic.int8_quantize(xt, pad_to)[0], xq)  # the CPU takes the plain version
    if case == "zeros":
        assert sx[1].item() == np.float32(np.float32(1e-12) / np.float32(127)) and not xq[1].any()
    if case.startswith("ties"):  # round half to even
        k = np.floor(x / (1.0 if case == "ties" else 2.0))
        even = np.where(k % 2 == 0, k, k + 1)
        inner = np.abs(x) < np.abs(x).max()
        np.testing.assert_array_equal(xq[..., :c].numpy()[inner], even[inner])


@pytest.mark.parametrize("c_in", [3, 4, 8, 17, 32])
@pytest.mark.parametrize("k,s,d", [(1, 1, 1), (3, 2, 1), (3, 1, 2)])
def test_padded_operands_give_the_unpadded_sums(c_in, k, s, d, monkeypatch):
    rng = np.random.default_rng(c_in * 7 + k + s + d)
    x = (rng.standard_normal((2, 9, 11, c_in)) * 2).astype(np.float32)
    w = (rng.uniform(-1, 1, (k, k, c_in, 10)) / np.sqrt(k * k * c_in)).astype(np.float32)
    _, seen = _jax_int8(x, w, np.zeros(10, np.float32), k, s, d, jnp.float32, monkeypatch)
    m = ic.channel_multiple(c_in, "cuda")
    assert m == (4 if c_in <= 4 else 16) and ic.channel_multiple(c_in, "cpu") == 1
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wq, sw = ic.quantize_weight(wt, m)
    xq, sx = ic.int8_quantize_plain(xt, m)
    cp = c_in + -c_in % m
    assert wq.shape == (10, k, k, cp) and xq.shape == (2, 9, 11, cp) and wq.is_contiguous()
    assert not wq[..., c_in:].any() and not xq[..., c_in:].any()
    np.testing.assert_array_equal(wq[..., :c_in].permute(1, 2, 3, 0).numpy(), seen["wq"])
    pad = autopad(k, None, d)
    sums = ic.int8_conv_sums(xq, wq, s, pad, d)
    unpadded = ic.int8_conv_sums(xq[..., :c_in].contiguous(), wq[..., :c_in].contiguous(), s,
                                 pad, d)
    assert torch.equal(sums, unpadded)
    np.testing.assert_array_equal(sums.permute(0, 2, 3, 1).numpy(), seen["sums"])
    plan = ic.plan(xq[..., :c_in], wq[..., :c_in], s, pad, d)
    assert plan["Cp"] == cp and plan["K"] == k * k * cp and plan["N"] == 10


def test_quantized_weight_follows_the_weights_and_bias():
    conv = Conv2d(6, 4, 3, 1, 1, bias=True)
    q = Int8Conv2d.of(conv)
    wq, sw, bias = q.quantized_weight()
    bias = bias.clone()
    assert q.quantized_weight()[0] is wq  # cached
    assert wq.shape == (4, 3, 3, 6) and bias.dtype == torch.float32
    with torch.no_grad():
        conv.weight.mul_(2.0)
    wq2, sw2, _ = q.quantized_weight()
    assert wq2 is not wq and torch.equal(wq2, wq) and torch.allclose(sw2, 2 * sw)
    with torch.no_grad():
        conv.bias.add_(1.0)
    assert torch.equal(q.quantized_weight()[2], bias + 1.0)


def _layer_inputs(pyolo, imgsz: int):
    """Every Int8Conv2d of the port's fused int8 model with the input it receives in one
    forward of two seeded images."""
    model = pyolo._fused_for_serving(int8=True)
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append((m, a[0])))
             for m in model.modules() if isinstance(m, Int8Conv2d)]
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, 3, imgsz, imgsz))
                         .astype(np.float32))
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    assert len(seen) == len(hooks) > 5
    return seen


@pytest.mark.parametrize("cfg", ["tinyjde.yaml", "yolov13n-JDE.yaml"])
def test_int8_layers_match_jax(cfg, monkeypatch):
    from sar_yolo_tpu_torch import YOLO
    torch.manual_seed(2)
    pyolo = YOLO(cfg, device="cpu")
    for m, x in _layer_inputs(pyolo, 64):
        k, s, p, d = m.kernel_size[0], m.stride[0], m.padding[0], m.dilation[0]
        assert p == autopad(k, None, d)
        w = m.weight.detach().permute(2, 3, 1, 0).numpy()
        x_nhwc = x.permute(0, 2, 3, 1).numpy()
        want, seen = _jax_int8(x_nhwc, w, m.bias.detach().numpy(), k, s, d, jnp.float32,
                               monkeypatch)
        xq, sx = ic.int8_quantize_plain(x)
        np.testing.assert_array_equal(xq.numpy(), seen["xq"])
        np.testing.assert_array_equal(sx.numpy(), _jax_sx(x_nhwc, seen["xq"]))
        wq, sw, bias = m.quantized_weight()
        np.testing.assert_array_equal(wq.permute(1, 2, 3, 0).numpy(), seen["wq"])
        np.testing.assert_array_equal(ic.int8_conv_sums(xq, wq, s, p, d).permute(0, 2, 3, 1)
                                      .numpy(), seen["sums"])
        with torch.no_grad():
            got = m(x).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("shape,pad_to,itemsize", [
    ((8, 3, 640, 640), 4, 4), ((8, 16, 320, 320), 16, 4), ((1, 64, 160, 160), 16, 2),
    ((8, 256, 20, 20), 16, 4), ((1, 17, 3, 5), 16, 4), ((2, 48, 7, 9), 16, 2)])
def test_quantize_geometry_covers_the_tensor(shape, pad_to, itemsize):
    B, C, hw, cp, parts, slice_, vec, ct, vec4, stride = ic.quantize_geometry(
        shape, pad_to, itemsize, True)
    per = C * hw
    assert (B, C, hw) == (shape[0], shape[1], shape[2] * shape[3])
    assert cp % pad_to == 0 and cp - C < pad_to and cp % 4 == 0
    assert slice_ % 8 == 0 and (parts - 1) * slice_ < per <= parts * slice_ and parts <= 256
    assert vec == (per % (16 // itemsize) == 0) and vec4 == (hw % 4 == 0) and stride == per
    assert ic.QUANT_TILE % ct == 0 and ct % 4 == 0 and (ct == cp or ct == 64)
    # a channel slice of a tensor of twice the channels: the samples' stride, and the 16-byte
    # paths only where that stride keeps every sample aligned
    sliced = ic.quantize_geometry(shape, pad_to, itemsize, True, 2 * per)
    assert sliced[9] == 2 * per and sliced[:6] == (B, C, hw, cp, parts, slice_)


@pytest.mark.parametrize("M,N,K,cp,tile", [
    (819200, 16, 36, 4, (16, 128)), (819200, 64, 36, 4, (64, 128)),
    (204800, 32, 288, 16, (32, 128)), (51200, 64, 576, 64, (64, 128)),
    (3200, 256, 2304, 256, (64, 64)), (51200, 256, 2304, 256, (128, 64)),
    (3200, 128, 128, 128, (16, 128)), (3200, 64, 576, 4, (16, 128))])
def test_conv_tile_choice(M, N, K, cp, tile):
    assert ic.TILES[ic.pick_tile(M, N, K, cp)] == tile
