"""int8 serving of the PyTorch port against the JAX package (CPU).

(i) `Int8Conv2d` against JAX's `Int8Conv2D` on the same fused weights and seeded inputs
    (k, stride, dilation, C_in, odd spatial sizes, float32 and bf16 inputs): the quantized
    activations and weights equal (JAX's, read off its `conv_general_dilated` call), the
    int32 sums equal (through the kernel's plain version), the outputs within 1e-6 of
    their largest magnitude (bf16 outputs: equal).
(ii) The set of quantized layers equals JAX's: the `Int8Conv2D` calls of JAX's int8 trace
    (`flax.linen.intercept_methods`) against the port's `Int8Conv2d` modules, on tinydet,
    tinyjde and yolov13n-JDE (its DWConv with gcd 1 in; DSConv and the heads out).
(iii) `resolve_int8_policy` decides as JAX's for every scale and request.
(iv) `predict_batched(int8=True)` of tinydet and tinyjde against JAX's int8 forward: the
    head maps within 1e-5 of their largest magnitude (every int8 value equal); JAX's serving
    tail (decode, NMS, rescale) on JAX's maps gives the same rows at a threshold in a gap of
    the scores (boxes within 1e-3 px, scores within 1e-5); not bit-identical to float32.
    The port computes the rescale in the written order, float32(sums) * (sx * sw) + bias, as
    JAX's eager trace does; XLA's jitted trace fuses it into a multiply-add, and an
    activation within one float32 rounding of a quantization step then takes the other int8
    value downstream. On tinyjde no activation lies that near (JAX's jitted maps are held);
    on tinydet JAX's jitted maps lie 7.7% of their largest magnitude from its eager ones
    (its int8 maps 15.6% from float32), so its eager trace (`jax.disable_jit`) is held.
(v) `half=True` with `int8=True` on the CPU: as JAX's off its accelerator, float32 out.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sar_yolo_tpu.engine.model import resolve_int8_policy as jax_policy
from sar_yolo_tpu.nn.modules.conv import Int8Conv2D
from sar_yolo_tpu_torch.engine.model import resolve_int8_policy
from sar_yolo_tpu_torch.nn.modules.conv import Conv2d, Int8Conv2d, autopad
from sar_yolo_tpu_torch.ops.cuda import int8_conv as ic
from sar_yolo_tpu_torch.utils.convert import _module_path
from torch_port_common import jax_and_port_yolo, one_torch_thread  # noqa: F401


def _jax_int8(x, w, b, k, s, d, dtype, monkeypatch):
    """JAX's Int8Conv2D output and the (xq, wq, int32 sums) of its integer convolution."""
    seen = {}
    conv = jax.lax.conv_general_dilated

    def record(lhs, rhs, *a, **kw):
        out = conv(lhs, rhs, *a, **kw)
        seen.update(xq=np.asarray(lhs), wq=np.asarray(rhs), sums=np.asarray(out))
        return out
    monkeypatch.setattr(jax.lax, "conv_general_dilated", record)
    pad = autopad(k, None, d)
    m = Int8Conv2D(features=w.shape[-1], kernel_size=(k, k), strides=(s, s),
                   padding=[(pad, pad)] * 2, kernel_dilation=(d, d), dtype=dtype)
    y = m.apply({"params": {"kernel": w, "bias": b}}, jnp.asarray(x).astype(dtype))
    monkeypatch.undo()
    return np.asarray(y.astype(jnp.float32)), seen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in", [3, 8, 17])
@pytest.mark.parametrize("k,s,d", [(1, 1, 1), (1, 2, 1), (3, 1, 1), (3, 2, 1), (3, 1, 2),
                                   (3, 2, 2)])
def test_int8_conv_matches_jax(k, s, d, c_in, dtype, monkeypatch):
    rng = np.random.default_rng(k * 100 + s * 10 + d + c_in)
    c_out, h, w_ = 12, 11, 13
    x = (rng.standard_normal((2, h, w_, c_in)) * rng.uniform(0.5, 3.0, (2, 1, 1, 1))).astype(np.float32)
    w = (rng.uniform(-1, 1, (k, k, c_in, c_out)) / np.sqrt(k * k * c_in)).astype(np.float32)
    b = rng.normal(0, 0.1, c_out).astype(np.float32)
    want, seen = _jax_int8(x, w, b, k, s, d, getattr(jnp, dtype), monkeypatch)

    conv = Conv2d(c_in, c_out, k, s, autopad(k, None, d), dilation=d, bias=True)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        conv.bias.copy_(torch.from_numpy(b))
    q = Int8Conv2d.of(conv)
    q.compute_dtype = getattr(torch, dtype)
    got_args = {}
    launch = ic.int8_conv

    def record(xq, wq, *a):
        got_args.update(xq=xq, wq=wq)
        return launch(xq, wq, *a)
    monkeypatch.setattr(ic, "int8_conv", record)
    with torch.no_grad():
        got = q(torch.from_numpy(x).permute(0, 3, 1, 2).to(q.compute_dtype))
    assert got.dtype == q.compute_dtype
    got = got.float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got_args["xq"].numpy(), seen["xq"])  # NHWC both
    np.testing.assert_array_equal(got_args["wq"].permute(1, 2, 3, 0).numpy(), seen["wq"])
    sums = ic.int8_conv_sums(got_args["xq"], got_args["wq"], s, autopad(k, None, d), d)
    assert sums.dtype == torch.int32
    np.testing.assert_array_equal(sums.permute(0, 2, 3, 1).numpy(), seen["sums"])
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)


def test_int8_conv_plain_is_the_rescaled_exact_sum():
    """The plain version: the float64 sums are integers (exact), rescaled in float32."""
    g = torch.Generator().manual_seed(0)
    xq = torch.randint(-127, 128, (2, 9, 7, 5), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (6, 3, 3, 5), generator=g, dtype=torch.int8)
    sums = ic.conv_sums_plain(xq, wq, 2, 1, 1)
    assert sums.shape == (2, 6, 5, 4) and torch.equal(sums, sums.round())
    ref = torch.zeros(2, 6, 5, 4, dtype=torch.long)
    xp = torch.nn.functional.pad(xq.permute(0, 3, 1, 2).long(), (1, 1, 1, 1))
    for i in range(5):
        for j in range(4):
            patch = xp[:, :, 2 * i:2 * i + 3, 2 * j:2 * j + 3]
            ref[:, :, i, j] = torch.einsum("bchw,ohwc->bo", patch, wq.long())
    assert torch.equal(sums.long(), ref)
    sx, sw, bias = torch.rand(2, generator=g), torch.rand(6, generator=g), torch.rand(6, generator=g)
    y = ic.int8_conv(xq, wq, sx, sw, bias, 2, 1, 1, torch.float32)
    assert torch.equal(y, ref.float() * (sx.view(-1, 1, 1, 1) * sw.view(1, -1, 1, 1)) +
                       bias.view(1, -1, 1, 1))


def _jax_int8_calls(jyolo, imgsz: int) -> list:
    """The scopes of the Int8Conv2D calls of JAX's fused int8 trace."""
    from sar_yolo_tpu.nn.fuse import fuse
    model, variables = fuse(jyolo.model, jyolo.variables)
    model = model.clone(quant="int8")
    calls = []

    def spy(next_fun, args, kwargs, context):
        if isinstance(context.module, Int8Conv2D) and context.method_name == "__call__":
            calls.append(_module_path(context.module.scope.path))
        return next_fun(*args, **kwargs)
    with flax_nn.intercept_methods(spy):
        jax.eval_shape(lambda v: model.apply(v, jnp.zeros((1, imgsz, imgsz, 3)), train=False),
                       variables)
    return calls


@pytest.mark.parametrize("cfg", ["tinydet.yaml", "tinyjde.yaml", "yolov13n-JDE.yaml"])
def test_quantized_layers_match_jax(cfg):
    from sar_yolo_tpu_torch.nn.modules.conv import DSConv
    jyolo, pyolo = jax_and_port_yolo(cfg, seed=1)
    want = _jax_int8_calls(jyolo, 64)
    model = pyolo._fused_for_serving(int8=True)
    assert model.quant == "int8" and pyolo._fused_for_serving().quant == ""
    got = [name for name, m in model.named_modules() if isinstance(m, Int8Conv2d)]
    assert sorted(got) == sorted(want) and len(got) == len(set(got)) > 5
    for m in model.modules():  # DSConv's and the heads' plain convs stay float
        if isinstance(m, DSConv):
            assert not isinstance(m.dw, Int8Conv2d) and not isinstance(m.pw, Int8Conv2d)
    if cfg == "yolov13n-JDE.yaml":  # DWConv blocks with gcd(c1, c2) == 1 go through Conv
        assert any("DSC3k" in type(m).__name__ for m in model.modules())


@pytest.mark.parametrize("scale", ["n", "t", "s", "m", "l", "x", None, ""])
@pytest.mark.parametrize("req", [True, "auto", "AUTO"])
def test_int8_policy_matches_jax(scale, req):
    got, want = resolve_int8_policy(req, scale), jax_policy(req, scale)
    assert got[0] == want[0] and (got[1] is None) == (want[1] is None)
    if got[1]:
        assert "TPU" not in got[1] and "%" not in got[1] and "PROFILE" not in got[1]


@pytest.fixture(scope="module", params=["tinydet.yaml", "tinyjde.yaml"])
def pair(request):
    return jax_and_port_yolo(request.param, 3, bias_init=True, box_gain=0.1, calibrate=64)


def _gap_conf(scores, lo: float, hi: float) -> float:
    s = np.r_[lo, np.sort(scores[(scores > lo) & (scores < hi)]), hi]
    i = int(np.argmax(np.diff(s)))
    return float((s[i] + s[i + 1]) / 2)


def _sorted_rows(d):
    d = d[d[:, 4] > 0]
    return d[np.lexsort((d[:, 3], d[:, 2], d[:, 1], d[:, 0], d[:, 5]))]


class _Maps:
    """Stands in for a JAX model: `apply` returns fixed head maps."""

    def __init__(self, maps):
        self.maps = maps

    def apply(self, variables, x, train=False):
        return self.maps


def test_predict_batched_int8_matches_jax(pair):
    from sar_yolo_tpu_torch.ops.decode import decode_detect
    jyolo, pyolo = pair
    frames = np.random.default_rng(0).integers(0, 256, (3, 48, 72, 3), np.uint8)
    kw = dict(imgsz=64, int8=True)
    pred = pyolo._get_predictor(dict(kw))
    assert pred.model.quant == "int8" and pred.args.int8 is True
    x, _, _ = pred.preprocess(frames)
    jpred = jyolo._get_predictor(dict(kw))
    assert getattr(jpred.model, "quant", "") == "int8"
    with torch.no_grad():
        got_maps = pred.model(x)
        f32_maps = pyolo._fused_for_serving()(x)
    x_nhwc = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    if pyolo.cfg == "tinydet.yaml":  # JAX's jitted trace takes other int8 values here
        with jax.disable_jit():
            want_maps = jpred.model.apply(jpred.variables, x_nhwc, train=False)
    else:
        want_maps = jax.jit(lambda v, a: jpred.model.apply(v, a, train=False))(jpred.variables,
                                                                               x_nhwc)
    for g, w, f in zip(got_maps, want_maps, f32_maps):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
        assert not torch.equal(g, f)  # the int8 path is in the trace
    nc = pyolo.meta["nc"]
    preds = decode_detect(got_maps, pyolo.meta["strides"], nc, 16)
    scores = (preds[0] if isinstance(preds, tuple) else preds)[..., 4:4 + nc].flatten().numpy()
    top = np.sort(scores)[::-1]
    conf = _gap_conf(scores, top[40], top[3])  # 3 to 40 candidates over three frames
    assert np.abs(scores - conf).min() > 1e-4
    got = pyolo.predict_batched(frames, conf=conf, **kw)
    jtail = jyolo._get_predictor(dict(kw, conf=conf))
    jtail.model = _Maps(want_maps)  # JAX's tail (decode, NMS, rescale) on its eager maps
    want = np.asarray(jtail.predict_batch(frames))
    f32 = pyolo.predict_batched(frames, conf=conf, imgsz=64)
    assert got.shape == want.shape and not np.array_equal(got, f32)
    assert (got[..., 4] > 0).sum() >= 1
    for b in range(len(frames)):
        g, w = _sorted_rows(got[b]), _sorted_rows(want[b])
        assert len(g) == len(w)
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=1e-5)


def test_half_with_int8_on_the_cpu_follows_jax(pair):
    """Off its accelerator JAX ignores `half` and quantizes the float32 model; so does the
    port on the CPU (its bf16 serving is CUDA-only)."""
    jyolo, pyolo = pair
    frames = np.random.default_rng(1).integers(0, 256, (2, 48, 72, 3), np.uint8)
    kw = dict(imgsz=64, conf=0.2)
    both = pyolo.predict_batched(frames, half=True, int8=True, **kw)
    np.testing.assert_array_equal(both, pyolo.predict_batched(frames, int8=True, **kw))
    pred = pyolo._get_predictor(dict(half=True, int8=True, **kw))
    assert next(pred.model.parameters()).dtype == torch.float32 and pred.model.quant == "int8"
    jpred = jyolo._get_predictor(dict(half=True, int8=True, **kw))
    assert jpred.model.dtype == jnp.float32 and jpred.model.quant == "int8"


def test_int8_auto_declines_below_m_and_applies_at_m(pair, tmp_path):
    _, pyolo = pair
    assert pyolo.meta["scale"] in ("n", "t", "s", "")
    pred = pyolo._get_predictor(dict(imgsz=64, int8="auto"))
    want = pyolo.meta["scale"] in ("", None)  # an unknown scale takes int8, as JAX's rule
    assert pred.args.int8 is want and (pred.model.quant == "int8") is want
