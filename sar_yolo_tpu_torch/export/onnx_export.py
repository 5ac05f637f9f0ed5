"""torch.export program -> ONNX graph (no `onnx` wheel, no `torch.onnx`): the port's
counterpart of `sar_yolo_tpu/export/onnx_export.py`, which walks a jaxpr.

`export_onnx(module, example, path)` traces the module with `torch.export.export` at the
example's static shape, decomposes the program to core ATen (`run_decompositions`) and maps
each node onto standard ONNX ops, serialized by the self-contained protobuf writer of
`onnx_proto.py`. Only ops that `onnx_runtime.OnnxReferenceRuntime` implements are emitted,
so the numpy runtime (and the JAX package's copy of it) executes every artifact:

* the port is NCHW, so convolutions and pools map to ONNX's without Transpose brackets; a
  convolution's bias is a separate Add (the runtime's Conv takes no bias);
* a nearest upsample arrives already decomposed into expand and view (Reshape, Expand,
  Reshape): no Resize;
* the registered area-attention op (`sar_yolo_tpu_torch::flash_area_attention`) becomes
  the einsum path the JAX package writes: Reshape, Transpose, MatMul, Mul, Softmax, MatMul,
  Transpose, Reshape;
* `aten._assert_tensor_metadata` (one per `Conv2d` compute-dtype cast) is dropped and a
  cast that keeps the dtype is the identity;
* nodes whose inputs are all constants are evaluated here and emitted as initializers
  (`_try_fold`), size-guarded so that a scalar broadcast to an image is not materialized.

An op with no mapping raises `UnsupportedPrimitive` (the exporter turns it into
`ExportError`).
"""

from __future__ import annotations

import itertools
import math
import operator

import numpy as np
import torch
from torch.export.graph_signature import InputKind

from sar_yolo_tpu_torch.export import onnx_proto as P
from sar_yolo_tpu_torch.utils import LOGGER

aten = torch.ops.aten


class UnsupportedPrimitive(Exception):
    pass


_NP = {torch.float32: np.float32, torch.float64: np.float64, torch.float16: np.float16,
       torch.uint8: np.uint8, torch.int8: np.int8, torch.int16: np.int16,
       torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_}


def _np_dtype(dtype) -> np.dtype:
    if dtype not in _NP:
        raise UnsupportedPrimitive(f"dtype {dtype}")
    return np.dtype(_NP[dtype])


class _Builder:
    """Nodes and lazily serialized constants (a constant costs bytes only once a node uses
    it), as the JAX writer's builder."""

    def __init__(self):
        self.nodes: list[bytes] = []
        self.const_vals: dict[str, np.ndarray] = {}
        self._names = (f"t{i}" for i in itertools.count())
        self._const_cache: dict = {}
        self._used: set[str] = set()

    def fresh(self) -> str:
        return next(self._names)

    def const(self, arr, name: str | None = None) -> str:
        arr = np.asarray(arr)
        key = None
        if name is None and arr.size <= 64:
            key = (arr.dtype.str, arr.shape, arr.tobytes())
            if key in self._const_cache:
                return self._const_cache[key]
        name = name or self.fresh()
        self.const_vals[name] = arr
        if key is not None:
            self._const_cache[key] = name
        return name

    def node(self, op: str, inputs: list[str], n_out: int = 1, **attrs):
        self._used.update(i for i in inputs if i in self.const_vals)
        outs = [self.fresh() for _ in range(n_out)]
        self.nodes.append(P.node_proto(op, inputs, outs, **attrs))
        return outs[0] if n_out == 1 else outs

    def raw_node(self, proto: bytes, inputs: list[str]):
        self._used.update(i for i in inputs if i in self.const_vals)
        self.nodes.append(proto)

    def initializers(self) -> list[bytes]:
        return [P.tensor_proto(n, a) for n, a in self.const_vals.items() if n in self._used]

    def i64(self, vals) -> str:
        return self.const(np.asarray(vals, np.int64))


def _val(node):
    """The FakeTensor the trace recorded for a node's (first) output."""
    v = node.meta["val"]
    return v[0] if isinstance(v, (tuple, list)) else v


def _shape(node) -> list[int]:
    return [int(d) for d in _val(node).shape]


def _operand(b: _Builder, x, like) -> str:
    """A tensor operand's name; a Python scalar becomes a constant of `like`'s dtype."""
    if isinstance(x, str):
        return x
    return b.const(np.asarray(x, _np_dtype(_val(like).dtype)))


def _binary(op: str):
    def h(b, node, args, kwargs):
        x, y = (_operand(b, a, node) for a in args[:2])
        alpha = kwargs.get("alpha", 1)
        if alpha != 1:
            y = b.node("Mul", [y, _operand(b, alpha, node)])
        return b.node(op, [x, y])
    return h


def _unary(op: str):
    return lambda b, node, args, kwargs: b.node(op, [args[0]])


def _reshape(b, node, args, kwargs):
    return b.node("Reshape", [args[0], b.i64(_shape(node) or [1])])


def _conv(b, node, args, kwargs):
    x, w, bias, stride, padding, dilation, transposed, output_padding, groups = args
    if w not in b.const_vals:
        raise UnsupportedPrimitive("convolution: non-constant weights")
    if len(b.const_vals[w].shape) != 4:
        raise UnsupportedPrimitive("convolution: only 2-D convolutions are exportable")
    pads = [int(p) for p in padding] * 2  # [h_begin, w_begin, h_end, w_end]
    attrs = dict(strides=[int(s) for s in stride], pads=pads,
                 dilations=[int(d) for d in dilation], group=int(groups),
                 kernel_shape=list(b.const_vals[w].shape[2:]))
    if transposed:
        if any(int(p) for p in output_padding) or groups != 1:
            raise UnsupportedPrimitive("conv_transpose: output_padding or groups")
        y = b.node("ConvTranspose", [x, w], **attrs)
    else:
        y = b.node("Conv", [x, w], **attrs)
    if bias is None:
        return y
    if bias not in b.const_vals:
        raise UnsupportedPrimitive("convolution: non-constant bias")
    return b.node("Add", [y, b.const(b.const_vals[bias].reshape(1, -1, 1, 1))])


def _pool_args(node, args):
    kernel = [int(k) for k in args[1]]
    stride = [int(s) for s in (args[2] if len(args) > 2 and args[2] else kernel)]
    padding = args[3] if len(args) > 3 else 0
    padding = [int(p) for p in (padding if isinstance(padding, (list, tuple)) else [padding] * 2)]
    return kernel, stride, padding * 2


def _max_pool(b, node, args, kwargs):
    kernel, stride, pads = _pool_args(node, args)
    dilation = args[4] if len(args) > 4 else 1
    ceil_mode = args[5] if len(args) > 5 else False
    if ceil_mode or any(int(d) != 1 for d in (dilation if isinstance(dilation, (list, tuple))
                                              else [dilation])):
        raise UnsupportedPrimitive("max_pool2d: ceil_mode or dilation")
    return [b.node("MaxPool", [args[0]], kernel_shape=kernel, strides=stride, pads=pads), None]


def _avg_pool(b, node, args, kwargs):
    kernel, stride, pads = _pool_args(node, args)
    ceil_mode = args[4] if len(args) > 4 else False
    count_include_pad = args[5] if len(args) > 5 else True
    divisor = args[6] if len(args) > 6 else None
    if ceil_mode or divisor is not None or (any(pads) and not count_include_pad):
        raise UnsupportedPrimitive("avg_pool2d: ceil_mode, divisor_override or excluded pads")
    return b.node("AveragePool", [args[0]], kernel_shape=kernel, strides=stride, pads=pads,
                  count_include_pad=1)


def _slice(b, node, args, kwargs):
    x = args[0]
    dim = int(args[1]) if len(args) > 1 else 0
    size = int(_val(node.args[0]).shape[dim])
    start = args[2] if len(args) > 2 and args[2] is not None else 0
    end = args[3] if len(args) > 3 and args[3] is not None else size
    step = args[4] if len(args) > 4 else 1
    start, end = (max(min(int(v) + (size if int(v) < 0 else 0), size), 0) for v in (start, end))
    return b.node("Slice", [x, b.i64([start]), b.i64([end]), b.i64([dim]), b.i64([int(step)])])


def _select(b, node, args, kwargs):
    x, dim, index = args
    index = int(index) % int(_val(node.args[0]).shape[dim])
    y = b.node("Slice", [x, b.i64([index]), b.i64([index + 1]), b.i64([int(dim)]), b.i64([1])])
    return b.node("Reshape", [y, b.i64(_shape(node) or [1])])


def _split(b, node, args, kwargs):
    sizes = [int(s) for s in args[1]]
    dim = int(args[2]) if len(args) > 2 else 0
    outs = b.node("Split", [args[0], b.i64(sizes)], n_out=len(sizes), axis=dim)
    return outs if isinstance(outs, list) else [outs]


def _reduce(op: str):
    def h(b, node, args, kwargs):
        x = args[0]
        rank = len(_val(node.args[0]).shape)
        dims = args[1] if len(args) > 1 and args[1] is not None else list(range(rank))
        dims = [int(d) % rank for d in (dims if isinstance(dims, (list, tuple)) else [dims])]
        keep = int(bool(args[2] if len(args) > 2 else kwargs.get("keepdim", False)))
        if op == "ReduceSum":  # axes are an input from opset 13
            return b.node(op, [x, b.i64(dims)], keepdims=keep)
        return b.node(op, [x], axes=dims, keepdims=keep)
    return h


def _to_copy(b, node, args, kwargs):
    src, dst = _val(node.args[0]).dtype, _val(node).dtype
    if src == dst:
        return args[0]
    return b.node("Cast", [args[0]], to=P.NP2ONNX[_np_dtype(dst)])


def _gelu(b, node, args, kwargs):
    if kwargs.get("approximate", "none") != "none":
        raise UnsupportedPrimitive("gelu: tanh approximation")
    x = args[0]
    dt = _np_dtype(_val(node).dtype)
    erf = b.node("Erf", [b.node("Div", [x, b.const(np.asarray(math.sqrt(2.0), dt))])])
    half_x = b.node("Mul", [x, b.const(np.asarray(0.5, dt))])
    return b.node("Mul", [half_x, b.node("Add", [erf, b.const(np.asarray(1.0, dt))])])


def _matmul(b, node, args, kwargs):
    return b.node("MatMul", [args[0], args[1]])


def _addmm(b, node, args, kwargs):
    bias, m1, m2 = args[:3]
    if kwargs.get("beta", 1) != 1 or kwargs.get("alpha", 1) != 1:
        raise UnsupportedPrimitive("addmm: beta or alpha")
    return b.node("Add", [b.node("MatMul", [m1, m2]), bias])


def _expand(b, node, args, kwargs):
    return b.node("Expand", [args[0], b.i64(_shape(node))])


def _full(b, node, args, kwargs):
    value = b.const(np.asarray(args[1], _np_dtype(_val(node).dtype)))
    return b.node("Expand", [value, b.i64(_shape(node))])


def _where(b, node, args, kwargs):
    return b.node("Where", [_operand(b, a, node) if i else a for i, a in enumerate(args)])


def _area_attention(b, node, args, kwargs):
    """The registered area-attention op as the JAX package's einsum path writes it."""
    q, k, v, heads, area = args
    B, N, C = (int(d) for d in _val(node).shape)
    hd = C // heads
    Ba, Na = B * area, N // area
    dt = _np_dtype(_val(node).dtype)
    split = b.i64([Ba, Na, heads, hd])
    qh = b.node("Transpose", [b.node("Reshape", [q, split])], perm=[0, 2, 1, 3])
    kh = b.node("Transpose", [b.node("Reshape", [k, split])], perm=[0, 2, 3, 1])
    vh = b.node("Transpose", [b.node("Reshape", [v, split])], perm=[0, 2, 1, 3])
    scores = b.node("Mul", [b.node("MatMul", [qh, kh]), b.const(np.asarray(hd ** -0.5, dt))])
    out = b.node("MatMul", [b.node("Softmax", [scores], axis=-1), vh])
    return b.node("Reshape", [b.node("Transpose", [out], perm=[0, 2, 1, 3]), b.i64([B, N, C])])


def _clamp(b, node, args, kwargs):
    x = args[0]
    lo = args[1] if len(args) > 1 else kwargs.get("min")
    hi = args[2] if len(args) > 2 else kwargs.get("max")
    if hi is not None:
        x = b.node("Min", [x, _operand(b, hi, node)])
    if lo is not None:
        x = b.node("Max", [x, _operand(b, lo, node)])
    return x


def _pad(b, node, args, kwargs):
    """constant_pad_nd: torch's (last dim first) begin/end pairs -> ONNX's begins then ends."""
    pad = [int(p) for p in args[1]]
    if any(p < 0 for p in pad):
        raise UnsupportedPrimitive("pad: negative (cropping) pads")
    rank = len(_val(node).shape)
    begins, ends = [0] * rank, [0] * rank
    for i in range(len(pad) // 2):
        begins[rank - 1 - i], ends[rank - 1 - i] = pad[2 * i], pad[2 * i + 1]
    value = _operand(b, args[2] if len(args) > 2 else 0, node)
    return b.node("Pad", [args[0], b.i64(begins + ends), value], mode="constant")


def _flip(b, node, args, kwargs):
    dims = [int(d) for d in args[1]]
    imin = np.iinfo(np.int64).min
    return b.node("Slice", [args[0], b.i64([-1] * len(dims)), b.i64([imin] * len(dims)),
                            b.i64(dims), b.i64([-1] * len(dims))])


def _argmax(b, node, args, kwargs):
    if len(args) < 2 or args[1] is None:
        raise UnsupportedPrimitive("argmax over the flattened tensor")
    keep = int(bool(args[2] if len(args) > 2 else kwargs.get("keepdim", False)))
    return b.node("ArgMax", [args[0]], axis=int(args[1]), keepdims=keep)


def _identity(b, node, args, kwargs):
    return args[0]


_HANDLERS = {
    aten.add.Tensor: _binary("Add"), aten.sub.Tensor: _binary("Sub"),
    aten.mul.Tensor: _binary("Mul"), aten.div.Tensor: _binary("Div"),
    aten.gt.Scalar: _binary("Greater"),
    aten.sigmoid.default: _unary("Sigmoid"), aten.sqrt.default: _unary("Sqrt"),
    aten.neg.default: _unary("Neg"), aten.tanh.default: _unary("Tanh"),
    aten.abs.default: _unary("Abs"), aten.cos.default: _unary("Cos"),
    aten.sin.default: _unary("Sin"),
    aten.relu.default: lambda b, node, args, kwargs: b.node(
        "Max", [args[0], _operand(b, 0, node)]),
    aten.gelu.default: _gelu,
    aten.clamp.default: _clamp, aten.constant_pad_nd.default: _pad,
    aten.flip.default: _flip, aten.argmax.default: _argmax,
    aten.where.self: _where,
    aten.convolution.default: _conv,
    aten.max_pool2d_with_indices.default: _max_pool,
    aten.avg_pool2d.default: _avg_pool,
    aten.mm.default: _matmul, aten.bmm.default: _matmul, aten.addmm.default: _addmm,
    aten._softmax.default: lambda b, node, args, kwargs: b.node(
        "Softmax", [args[0]], axis=int(args[1])),
    aten.amax.default: _reduce("ReduceMax"),
    aten.sum.dim_IntList: _reduce("ReduceSum"), aten.mean.dim: _reduce("ReduceMean"),
    aten.view.default: _reshape, aten.unsqueeze.default: _reshape,
    aten.permute.default: lambda b, node, args, kwargs: b.node(
        "Transpose", [args[0]], perm=[int(p) for p in args[1]]),
    aten.expand.default: _expand,
    aten.slice.Tensor: _slice, aten.select.int: _select,
    aten.split_with_sizes.default: _split,
    aten.cat.default: lambda b, node, args, kwargs: b.node(
        "Concat", list(args[0]), axis=int(args[1]) if len(args) > 1 else 0),
    aten.clone.default: _identity, aten.alias.default: _identity,
    aten._to_copy.default: _to_copy,
    aten.full.default: _full,  # too large to fold: the (H W, 1) strides of an OBB head
    torch.ops.sar_yolo_tpu_torch.flash_area_attention.default: _area_attention,
}
_SKIPPED = {aten._assert_tensor_metadata.default}
_UNFOLDED = {torch.ops.sar_yolo_tpu_torch.flash_area_attention.default}


def _try_fold(b: _Builder, node, args, kwargs, env) -> bool:
    """Evaluate `node` on the host when every tensor it reads is a constant, and register
    its output(s) as constants; False when it is not foldable or too large to fold."""
    if node.target in _UNFOLDED or node.target is operator.getitem:
        return False
    names = [a for a in torch.utils._pytree.tree_leaves((args, kwargs)) if isinstance(a, str)]
    if not all(n in b.const_vals for n in names):
        return False
    vals = node.meta["val"]
    outs = vals if isinstance(vals, (tuple, list)) else [vals]
    if not all(isinstance(o, torch.Tensor) for o in outs):
        return False
    in_sz = sum(int(b.const_vals[n].size) for n in names)
    if sum(int(o.numel()) for o in outs) > 2 * max(in_sz, 1024):  # block constant blow-ups
        return False

    def host(a):
        return torch.from_numpy(np.array(b.const_vals[a])) if isinstance(a, str) else a

    targs, tkwargs = torch.utils._pytree.tree_map(host, (tuple(args), dict(kwargs)))
    if "device" in tkwargs:
        tkwargs["device"] = torch.device("cpu")
    res = node.target(*targs, **tkwargs)
    res = list(res) if isinstance(res, (tuple, list)) else [res]
    env[node] = [b.const(r.detach().numpy()) for r in res] if isinstance(vals, (tuple, list)) \
        else b.const(res[0].detach().numpy())
    return True


def _placeholders(ep, b: _Builder, input_name: str) -> dict:
    """Every placeholder of the program: parameters, buffers and constants as initializers,
    the one user input under `input_name`."""
    env, user = {}, []
    specs = {s.arg.name: s for s in ep.graph_signature.input_specs}
    for node in ep.graph.nodes:
        if node.op != "placeholder":
            continue
        spec = specs[node.name]
        if spec.kind == InputKind.USER_INPUT:
            env[node] = input_name
            user.append(node)
            continue
        t = ep.state_dict[spec.target] if spec.target in ep.state_dict else \
            ep.constants[spec.target]
        env[node] = b.const(t.detach().cpu().numpy())
    if len(user) != 1:
        raise ValueError("export_onnx expects a single-tensor program")
    return env


def export_onnx(module, example: torch.Tensor, path: str, opset: int = 17,
                input_name: str = "images", output_names=None,
                graph_name: str = "sar_yolo_tpu_torch") -> str:
    """Trace `module(example)` (one tensor in, a tensor or a tuple of tensors out) with
    `torch.export` and write it as an ONNX model.

    The declared opset is clamped to [13, 17]: the emitted operator forms (ReduceSum
    axes-as-input, Split sizes-as-input, Slice input form) were introduced in 13, and
    ReduceMax's axes-as-attribute form was retired in 18.
    """
    opset_c = min(max(int(opset), 13), 17)
    if opset_c != opset:
        LOGGER.warning(f"ONNX opset {opset} clamped to {opset_c} "
                       "(emitted operator forms are valid for 13..17)")
    with torch.no_grad():
        ep = torch.export.export(module, (example,)).run_decompositions()
    b = _Builder()
    env = _placeholders(ep, b, input_name)

    def read(a):
        return env[a] if isinstance(a, torch.fx.Node) else a

    outs = None
    for node in ep.graph.nodes:
        if node.op == "output":
            outs = node.args[0]
            break
        if node.op != "call_function" or node.target in _SKIPPED:
            continue
        args, kwargs = torch.fx.node.map_arg((node.args, node.kwargs), read)
        if node.target is operator.getitem:
            env[node] = args[0][args[1]]
            continue
        if _try_fold(b, node, args, kwargs, env):
            continue
        h = _HANDLERS.get(node.target)
        if h is None:
            raise UnsupportedPrimitive(
                f"ONNX export: the traced program uses an op with no ONNX mapping "
                f"({node.target}). Embedded-NMS graphs are not ONNX-exportable; export "
                "with nms=False, or use format='pt2' for the full pipeline.")
        env[node] = h(b, node, args, kwargs)
    outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
    output_names = output_names or [f"output{i}" if i else "output" for i in range(len(outs))]
    # terminal Identity nodes pin the public output names (raw_node marks a directly
    # returned constant as used so that its initializer is serialized)
    for o, nm in zip(outs, output_names):
        b.raw_node(P.node_proto("Identity", [env[o]], [nm]), [env[o]])
    g = P.graph_proto(
        b.nodes, graph_name, b.initializers(),
        inputs=[P.value_info_proto(input_name, _np_dtype(example.dtype), example.shape)],
        outputs=[P.value_info_proto(nm, _np_dtype(_val(o).dtype), _val(o).shape)
                 for nm, o in zip(output_names, outs)])
    with open(path, "wb") as f:
        f.write(P.model_proto(g, opset=opset_c, producer="sar-yolo-tpu-torch"))
    return str(path)
