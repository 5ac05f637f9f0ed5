"""The port's ONNX stack op by op, its trace-friendly NMS and its registered area-attention op.

(a) The port's copies of the JAX package's op-level ONNX tests (`tests/test_onnx.py`): the
    protobuf round trip, and torch modules (elementwise and reductions, conv + maxpool,
    depthwise and transposed convs, a batched matmul with pad, flip and argmax) through the
    port's walker over their `torch.export` program (`export/onnx_export.py`), run by the
    port's numpy runtime and by the JAX package's own, against the eager module: atol 1e-5,
    rtol 1e-4, as the JAX tests hold their jitted functions; the runtime refusing an op it
    does not know.
(b) `_suppress`'s fixed point as a `while_loop` (what `torch.export` traces) against the host
    loop, for the greedy and the rotated NMS, on seeded overlapping boxes: exactly equal.
(c) `sar_yolo_tpu_torch::flash_area_attention`: its CPU implementation equals
    `area_attention_plain`, its fake's shape and strides equal the real op's for views of
    NCHW maps and for contiguous inputs, its gradient equals the plain version's, and
    `torch.library.opcheck` accepts its registrations.
"""

import numpy as np
import pytest
import torch

from sar_yolo_tpu.export.onnx_runtime import OnnxReferenceRuntime as JaxRuntime
from sar_yolo_tpu_torch.export import onnx_proto as P
from sar_yolo_tpu_torch.export.onnx_export import export_onnx
from sar_yolo_tpu_torch.export.onnx_runtime import OnnxReferenceRuntime
from sar_yolo_tpu_torch.ops import nms
from sar_yolo_tpu_torch.ops.cuda.flash_attention import area_attention_plain, flash_area_attention
from torch_port_common import one_torch_thread  # noqa: F401 (autouse fixture)


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _check(module, x, tmp_path, atol=1e-5):
    """module(x) against its ONNX export run by both numpy runtimes."""
    module = module.eval()
    with torch.no_grad():
        ref = module(torch.from_numpy(x)).numpy()
    path = str(tmp_path / "m.onnx")
    export_onnx(module, torch.from_numpy(x), path)
    for runtime in (OnnxReferenceRuntime, JaxRuntime):
        out = runtime(path)(x)[0]
        assert out.shape == ref.shape and out.dtype == ref.dtype, \
            f"{out.shape}/{out.dtype} vs {ref.shape}/{ref.dtype}"
        np.testing.assert_allclose(out, ref, atol=atol, rtol=1e-4)
    return path


def test_proto_tensor_roundtrip():
    for arr in (np.arange(12, dtype=np.float32).reshape(3, 4),
                np.array([True, False]),
                np.arange(-3, 3, dtype=np.int64),
                np.zeros((2, 0, 3), np.float32)):
        blob = P.tensor_proto("t", arr)
        g = P.graph_proto([], "g", [blob], [], [])
        m = P.parse_model(P.model_proto(g))
        got = m.graph.initializers[0].to_numpy()
        assert got.dtype == arr.dtype and got.shape == arr.shape
        np.testing.assert_array_equal(got, arr)
        assert m.opset >= 13 and m.ir_version == 8


def test_elementwise_and_reduce_chain(tmp_path):
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(6, 6)).astype(np.float32))

    def fn(x):
        y = torch.tanh(x @ w) + torch.sigmoid(x)
        y = y.clamp(-0.5, 0.8)
        sm = y.softmax(-1)
        z = torch.where(y > 0, sm, -sm)
        return z.sum(1) / torch.sqrt(z.abs().amax((1, 2), keepdim=True)[:, 0] + 1.0)

    x = np.random.default_rng(1).normal(size=(3, 5, 6)).astype(np.float32)
    _check(_Fn(fn), x, tmp_path)


def test_conv_and_maxpool(tmp_path):
    torch.manual_seed(2)
    m = torch.nn.Sequential(torch.nn.Conv2d(4, 8, 3, 2, 1), torch.nn.SiLU(),
                            torch.nn.MaxPool2d(3, 1, 1))
    x = np.random.default_rng(3).normal(size=(2, 4, 8, 8)).astype(np.float32)
    _check(m, x, tmp_path)


def test_depthwise_conv_group(tmp_path):
    torch.manual_seed(4)
    x = np.random.default_rng(5).normal(size=(1, 6, 6, 6)).astype(np.float32)
    _check(torch.nn.Conv2d(6, 6, 3, 1, 1, groups=6, bias=False), x, tmp_path)


def test_transposed_conv(tmp_path):
    """ConvTranspose2d (the segment Proto's upsample) -> ONNX ConvTranspose."""
    torch.manual_seed(6)
    x = np.random.default_rng(7).normal(size=(2, 5, 5, 5)).astype(np.float32)
    _check(torch.nn.ConvTranspose2d(5, 3, 2, 2), x, tmp_path)


def test_batched_matmul_pad_flip_argmax(tmp_path):
    w = torch.from_numpy(np.random.default_rng(8).normal(size=(3, 4, 7)).astype(np.float32))

    def fn(x):
        y = torch.bmm(x, w)
        y = torch.nn.functional.pad(y, (0, 1, 1, 2), value=0.5)
        y = y.flip(2)
        i = y.argmax(-1)
        return y + i[..., None].to(y.dtype)

    x = np.random.default_rng(9).normal(size=(3, 2, 4)).astype(np.float32)
    _check(_Fn(fn), x, tmp_path)


def test_large_constant_is_an_expand(tmp_path):
    """A constant too large to fold (over 2 x 1024 elements, as an OBB head's (H W, 1)
    strides at 1024 px) is written as an Expand of its scalar."""
    path = _check(_Fn(lambda x: x * torch.full((64, 64), 0.5) + 1.0),
                  np.random.default_rng(10).normal(size=(2, 64, 64)).astype(np.float32), tmp_path)
    assert "Expand" in {n.op_type for n in P.parse_model(open(path, "rb").read()).graph.nodes}


def test_runtime_rejects_unknown_op():
    node = P.node_proto("NoSuchOp", ["x"], ["y"])
    g = P.graph_proto([node], "g", [],
                      [P.value_info_proto("x", np.float32, (1,))],
                      [P.value_info_proto("y", np.float32, (1,))])
    rt = OnnxReferenceRuntime(P.model_proto(g))
    with pytest.raises(NotImplementedError, match="NoSuchOp"):
        rt(np.zeros(1, np.float32))


def _overlapping(seed: int, B: int = 2, N: int = 300, extra: int = 0):
    """Seeded clusters of overlapping boxes (xywh, 3 class scores, `extra` more columns)."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(20, 100, (B, 12, 2))[:, rng.integers(0, 12, N)]
    xy = centres + rng.normal(0, 4, (B, N, 2))
    wh = rng.uniform(8, 30, (B, N, 2))
    cls = rng.uniform(0, 1, (B, N, 3))
    more = rng.uniform(-np.pi / 4, np.pi / 4, (B, N, extra))
    return torch.from_numpy(np.concatenate([xy, wh, cls, more], -1).astype(np.float32))


@pytest.mark.parametrize("rotated", [False, True], ids=["greedy", "rotated"])
def test_traced_fixed_point_equals_host_loop(rotated):
    """The `while_loop` form of `_suppress` (traced by torch.export, batch dynamic) gives the
    host loop's rows exactly, at a batch other than the traced one too."""
    fn = nms.non_max_suppression_rotated if rotated else nms.non_max_suppression
    preds = _overlapping(10 + rotated, B=3, extra=int(rotated))
    module = _Fn(lambda p: fn(p, conf_thres=0.3, iou_thres=0.5, max_det=300, nc=3))
    ep = torch.export.export(module, (preds[:2],),
                             dynamic_shapes={"x": {0: torch.export.Dim("b", min=1)}})
    assert any("while_loop" in str(n.target) for n in ep.graph.nodes)
    for b in (2, 3):
        want = module(preds[:b])
        assert nms.last_iterations[0] > 2  # suppression chains need several iterations
        got = ep.module()(preds[:b])
        assert torch.equal(got, want)
        candidates = (preds[:b, :, 4:7].amax(-1) >= 0.3).sum()
        assert 0 < (got[..., 5 if rotated else 4] > 0).sum() < candidates  # some suppressed


def _nchw_views(B=2, C=64, H=8, W=8, seed=0):
    """q, k, v as AAttn passes them: token-contiguous channel slices of NCHW maps."""
    g = torch.Generator().manual_seed(seed)
    qk = torch.randn(B, 2 * C, H, W, generator=g)
    vm = torch.randn(B, C, H, W, generator=g)
    tokens = qk.flatten(2).transpose(1, 2)
    return tokens[..., :C], tokens[..., C:], vm.flatten(2).transpose(1, 2)


@pytest.mark.parametrize("layout", ["nchw_views", "contiguous"])
def test_registered_op_cpu_fake_and_gradient(layout):
    from torch._subclasses.fake_tensor import FakeTensorMode
    q, k, v = _nchw_views()
    if layout == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    heads, area = 2, 4
    op = torch.ops.sar_yolo_tpu_torch.flash_area_attention.default
    got = op(q, k, v, heads, area)
    torch.testing.assert_close(got, area_attention_plain(q, k, v, heads, area), rtol=0, atol=0)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(t) for t in (q, k, v)), heads, area)
    assert fake.shape == got.shape and fake.stride() == got.stride()
    token_contiguous = layout == "nchw_views"
    assert (got.stride(1) == 1) == token_contiguous
    # the gradient: the plain recompute, equal to the plain version's own
    w = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    (flash_area_attention(*leaves, heads, area) * w).sum().backward()
    refs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    (area_attention_plain(*refs, heads, area) * w).sum().backward()
    for a, b in zip(leaves, refs):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
    torch.library.opcheck(op, (q, k, v, heads, area))
