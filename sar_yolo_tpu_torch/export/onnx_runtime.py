"""Numpy reference runtime for ONNX artifacts (zero third-party deps): the port's own copy of
`sar_yolo_tpu/export/onnx_runtime.py`.

Executes the operator subset emitted by `onnx_export.py`, implementing each op from the
ONNX specification (not by calling back into PyTorch), so that export verification is
genuinely independent: a wrong field number, layout perm, or pad convention in the
exporter shows up as a numeric mismatch against the eager forward rather than cancelling
out.

Doubles as the AutoBackend execution engine for `.onnx` files where `onnxruntime` is
missing (on machines that have it, the artifact is standard opset-13..17 ONNX and loads
in onnxruntime directly). It runs on the host.
"""

from __future__ import annotations

import math

import numpy as np

from sar_yolo_tpu_torch.export import onnx_proto as P

_erf = np.vectorize(math.erf, otypes=[np.float32])


def _pool_view(x, kernel, strides, pads, pad_value):
    """(N,C,H,W) -> windows (N,C,Ho,Wo,kh,kw) honoring pads/strides."""
    (pt, pl, pb, pr) = pads
    xp = np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl, pr)), constant_values=pad_value)
    v = np.lib.stride_tricks.sliding_window_view(xp, kernel, axis=(2, 3))
    return v[:, :, ::strides[0], ::strides[1]]


def _conv(x, w, strides, pads, dilations, group):
    """ONNX Conv: x (N,C,H,W), w (M, C/g, kh, kw)."""
    kh, kw = w.shape[2], w.shape[3]
    dh, dw = dilations
    ekh, ekw = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    v = _pool_view(x, (ekh, ekw), strides, pads, 0.0)      # (N,C,Ho,Wo,ekh,ekw)
    v = v[..., ::dh, ::dw]                                  # dilate the taps
    n, c, ho, wo = v.shape[:4]
    g = group
    v = v.reshape(n, g, c // g, ho, wo, kh, kw)
    wg = w.reshape(g, w.shape[0] // g, c // g, kh, kw)
    out = np.einsum("ngchwij,gmcij->ngmhw", v, wg, optimize=True)
    return out.reshape(n, w.shape[0], ho, wo).astype(x.dtype, copy=False)


def _conv_transpose(x, w, strides, pads, dilations, group):
    """ONNX ConvTranspose: x (N,C,H,W), w (C, M/g, kh, kw).

    Implemented per spec as zero-stuffed input convolved with the spatially
    flipped kernel (the gradient-of-Conv definition).
    """
    if group != 1:
        raise NotImplementedError("ConvTranspose group != 1")
    sh, sw = strides
    kh, kw = w.shape[2], w.shape[3]
    dh, dw = dilations
    n, c, h, wd = x.shape
    xs = np.zeros((n, c, (h - 1) * sh + 1, (wd - 1) * sw + 1), x.dtype)
    xs[:, :, ::sh, ::sw] = x
    # equivalent Conv kernel: (M, C, kh, kw) spatially flipped
    k = np.transpose(w, (1, 0, 2, 3))[:, :, ::-1, ::-1]
    eff = (dh * (kh - 1), dw * (kw - 1))
    cpads = (eff[0] - pads[0], eff[1] - pads[1], eff[0] - pads[2], eff[1] - pads[3])
    if min(cpads) < 0:
        raise NotImplementedError("ConvTranspose negative derived pads")
    return _conv(xs, np.ascontiguousarray(k), (1, 1), cpads, dilations, 1)


class OnnxReferenceRuntime:
    """Parse + execute an ONNX model with numpy.

    >>> rt = OnnxReferenceRuntime(path)
    >>> outputs = rt(images_uint8)   # list of np arrays, graph output order
    """

    def __init__(self, model_bytes_or_path):
        if isinstance(model_bytes_or_path, str):
            with open(model_bytes_or_path, "rb") as f:
                blob = f.read()
        else:
            blob = model_bytes_or_path
        self.model = P.parse_model(blob)
        g = self.model.graph
        self.consts = {t.name: t.to_numpy() for t in g.initializers}
        self.input_names = [n for n, _, _ in g.inputs if n not in self.consts]
        self.output_names = [n for n, _, _ in g.outputs]
        self.nodes = g.nodes

    def __call__(self, *inputs):
        env = dict(self.consts)
        for name, arr in zip(self.input_names, inputs):
            env[name] = np.asarray(arr)
        for node in self.nodes:
            outs = self._run_node(node, [env[i] if i else None for i in node.inputs])
            if not isinstance(outs, (list, tuple)):
                outs = [outs]
            for name, val in zip(node.outputs, outs):
                env[name] = val
        return [env[n] for n in self.output_names]

    def _run_node(self, n, iv):
        a = n.attrs
        op = n.op_type
        if op == "Identity":
            return iv[0]
        if op == "Cast":
            return iv[0].astype(P.ONNX2NP[a["to"]])
        if op == "Sigmoid":
            x = iv[0].astype(np.float64)
            return (1.0 / (1.0 + np.exp(-x))).astype(iv[0].dtype)
        un = {"Exp": np.exp, "Sqrt": np.sqrt, "Neg": np.negative, "Tanh": np.tanh,
              "Abs": np.abs, "Log": np.log, "Floor": np.floor, "Ceil": np.ceil,
              "Sign": np.sign, "Not": np.logical_not,
              "Reciprocal": lambda x: (1.0 / x).astype(x.dtype), "Erf": _erf,
              "Cos": lambda x: np.cos(x).astype(x.dtype),
              "Sin": lambda x: np.sin(x).astype(x.dtype)}
        if op in un:
            return un[op](iv[0])
        bi = {"Add": np.add, "Sub": np.subtract, "Mul": np.multiply,
              "Div": lambda x, y: (x / y).astype(np.result_type(x, y))
              if np.issubdtype(np.result_type(x, y), np.floating)
              else x // y,
              "Pow": np.power, "Max": np.maximum, "Min": np.minimum,
              "Equal": np.equal, "Less": np.less, "LessOrEqual": np.less_equal,
              "Greater": np.greater, "GreaterOrEqual": np.greater_equal,
              "And": np.logical_and, "Or": np.logical_or}
        if op in bi:
            out = bi[op](iv[0], iv[1])
            if op in ("Add", "Sub", "Mul", "Max", "Min", "Pow"):
                out = out.astype(np.result_type(iv[0], iv[1]), copy=False)
            return out
        if op == "Where":
            return np.where(iv[0], iv[1], iv[2])
        if op == "Reshape":
            return iv[0].reshape([int(d) for d in iv[1]])
        if op == "Transpose":
            return np.transpose(iv[0], a["perm"])
        if op == "Expand":
            shape = [int(d) for d in iv[1]]
            return np.broadcast_to(iv[0], np.broadcast_shapes(iv[0].shape, tuple(shape)))
        if op == "Concat":
            return np.concatenate(iv, axis=a["axis"])
        if op == "Split":
            sizes = [int(s) for s in iv[1]] if len(iv) > 1 and iv[1] is not None \
                else a.get("split")
            idx = np.cumsum(sizes)[:-1]
            return np.split(iv[0], idx, axis=a.get("axis", 0))
        if op == "Slice":
            starts, ends = [int(s) for s in iv[1]], [int(s) for s in iv[2]]
            axes = [int(s) for s in iv[3]] if len(iv) > 3 else list(range(len(starts)))
            steps = [int(s) for s in iv[4]] if len(iv) > 4 else [1] * len(starts)
            sl = [slice(None)] * iv[0].ndim
            imin = np.iinfo(np.int64).min
            for st, en, ax, sp in zip(starts, ends, axes, steps):
                en_ = None if (sp < 0 and en <= imin + 1) else en
                sl[ax] = slice(st, en_, sp)
            return iv[0][tuple(sl)]
        if op == "Pad":
            pads = [int(p) for p in iv[1]]
            r = iv[0].ndim
            cfg = [(pads[i], pads[i + r]) for i in range(r)]
            cval = iv[2] if len(iv) > 2 and iv[2] is not None else 0
            return np.pad(iv[0], cfg, constant_values=np.asarray(cval).item())
        if op == "MatMul":
            dt = np.result_type(iv[0], iv[1])
            return (iv[0].astype(np.float64) @ iv[1].astype(np.float64)).astype(dt)
        if op == "Conv":
            w = iv[1]
            return _conv(iv[0], w, a.get("strides", [1, 1]),
                         a.get("pads", [0, 0, 0, 0]),
                         a.get("dilations", [1, 1]), a.get("group", 1))
        if op == "ConvTranspose":
            return _conv_transpose(iv[0], iv[1], a.get("strides", [1, 1]),
                                   a.get("pads", [0, 0, 0, 0]),
                                   a.get("dilations", [1, 1]), a.get("group", 1))
        if op == "AveragePool":
            v = _pool_view(iv[0], tuple(a["kernel_shape"]),
                           a.get("strides", [1, 1]), a.get("pads", [0, 0, 0, 0]),
                           0.0)
            if not a.get("count_include_pad", 0):
                raise NotImplementedError("AveragePool count_include_pad=0")
            return v.mean(axis=(-2, -1)).astype(iv[0].dtype)
        if op == "MaxPool":
            v = _pool_view(iv[0], tuple(a["kernel_shape"]),
                           a.get("strides", [1, 1]), a.get("pads", [0, 0, 0, 0]),
                           -np.inf if np.issubdtype(iv[0].dtype, np.floating)
                           else np.iinfo(iv[0].dtype).min)
            return v.max(axis=(-2, -1))
        if op in ("ReduceMax", "ReduceMin", "ReduceMean"):
            fn = {"ReduceMax": np.max, "ReduceMin": np.min,
                  "ReduceMean": np.mean}[op]
            return fn(iv[0], axis=tuple(a["axes"]) if a.get("axes") else None,
                      keepdims=bool(a.get("keepdims", 1)))
        if op == "ReduceSum":
            axes = tuple(int(x) for x in iv[1]) if len(iv) > 1 and iv[1] is not None \
                else (tuple(a["axes"]) if a.get("axes") else None)
            return np.sum(iv[0], axis=axes, keepdims=bool(a.get("keepdims", 1)),
                          dtype=np.float64).astype(iv[0].dtype)
        if op == "ArgMax":
            out = np.argmax(iv[0], axis=a.get("axis", 0))
            if a.get("keepdims", 1):
                out = np.expand_dims(out, a.get("axis", 0))
            return out.astype(np.int64)
        if op == "Softmax":
            ax = a.get("axis", -1)
            e = np.exp(iv[0] - iv[0].max(axis=ax, keepdims=True))
            return e / e.sum(axis=ax, keepdims=True)
        raise NotImplementedError(f"OnnxReferenceRuntime: op '{op}' not implemented")
