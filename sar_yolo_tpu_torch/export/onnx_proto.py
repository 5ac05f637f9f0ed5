"""Self-contained ONNX protobuf serialization (no `onnx` package required): the port's own
copy of `sar_yolo_tpu/export/onnx_proto.py`.

This module hand-encodes/decodes the protobuf wire format for the small, stable subset of
`onnx.proto3` the exporter emits:

    ModelProto > GraphProto > NodeProto / TensorProto / ValueInfoProto

Field numbers follow the upstream schema
(github.com/onnx/onnx/blob/main/onnx/onnx.proto3), which is frozen by ONNX's
backward-compatibility guarantee. The reader half exists so the exporter can
be round-trip verified — and executed by `onnx_runtime.OnnxReferenceRuntime` —
without any third-party runtime.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# --- onnx TensorProto.DataType enum values ---
DT_FLOAT, DT_UINT8, DT_INT8, DT_INT32, DT_INT64, DT_BOOL, DT_DOUBLE = 1, 2, 3, 6, 7, 9, 11
DT_FLOAT16, DT_BFLOAT16, DT_UINT32, DT_UINT64, DT_INT16, DT_UINT16 = 10, 16, 12, 13, 5, 4

NP2ONNX = {
    np.dtype(np.float32): DT_FLOAT, np.dtype(np.uint8): DT_UINT8,
    np.dtype(np.int8): DT_INT8, np.dtype(np.int32): DT_INT32,
    np.dtype(np.int64): DT_INT64, np.dtype(np.bool_): DT_BOOL,
    np.dtype(np.float64): DT_DOUBLE, np.dtype(np.float16): DT_FLOAT16,
    np.dtype(np.uint32): DT_UINT32, np.dtype(np.uint64): DT_UINT64,
    np.dtype(np.int16): DT_INT16, np.dtype(np.uint16): DT_UINT16,
}
ONNX2NP = {v: k for k, v in NP2ONNX.items()}

# AttributeProto.AttributeType enum
AT_FLOAT, AT_INT, AT_STRING, AT_TENSOR, AT_FLOATS, AT_INTS, AT_STRINGS = 1, 2, 3, 4, 6, 7, 8


# ----------------------------------------------------------------------------
# wire-format primitives
# ----------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's-complement for negative int64 (10-byte varint)
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fieldnum: int, wire: int) -> bytes:
    return _varint((fieldnum << 3) | wire)


def _len_delim(fieldnum: int, payload: bytes) -> bytes:
    return _tag(fieldnum, 2) + _varint(len(payload)) + payload


def _int_field(fieldnum: int, v: int) -> bytes:
    return _tag(fieldnum, 0) + _varint(v)


def _float_field(fieldnum: int, v: float) -> bytes:
    return _tag(fieldnum, 5) + struct.pack("<f", v)


def _str_field(fieldnum: int, s: str) -> bytes:
    return _len_delim(fieldnum, s.encode("utf-8"))


def _packed_int64(fieldnum: int, vals) -> bytes:
    if not len(vals):
        return b""
    return _len_delim(fieldnum, b"".join(_varint(int(v)) for v in vals))


def _packed_float(fieldnum: int, vals) -> bytes:
    if not len(vals):
        return b""
    return _len_delim(fieldnum, struct.pack(f"<{len(vals)}f", *vals))


# ----------------------------------------------------------------------------
# message builders (encode side)
# ----------------------------------------------------------------------------

def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, raw_data=9, name=8."""
    arr = np.ascontiguousarray(arr)
    dt = NP2ONNX[arr.dtype]
    out = _packed_int64(1, arr.shape)
    out += _int_field(2, dt)
    out += _str_field(8, name)
    # raw_data is always little-endian per the ONNX spec
    out += _len_delim(9, arr.astype(arr.dtype.newbyteorder("<")).tobytes())
    return out


def attribute_proto(name: str, value) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, type=20."""
    out = _str_field(1, name)
    if isinstance(value, bool):
        out += _int_field(3, int(value)) + _int_field(20, AT_INT)
    elif isinstance(value, int):
        out += _int_field(3, value) + _int_field(20, AT_INT)
    elif isinstance(value, float):
        out += _float_field(2, value) + _int_field(20, AT_FLOAT)
    elif isinstance(value, str):
        out += _len_delim(4, value.encode()) + _int_field(20, AT_STRING)
    elif isinstance(value, np.ndarray):
        out += _len_delim(5, tensor_proto(name, value)) + _int_field(20, AT_TENSOR)
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            for v in value:
                out += _float_field(7, v)  # repeated float, unpacked is valid
            out += _int_field(20, AT_FLOATS)
        else:
            for v in value:
                out += _int_field(8, int(v))  # repeated int64, unpacked
            out += _int_field(20, AT_INTS)
    else:
        raise TypeError(f"unsupported attribute value {type(value)} for '{name}'")
    return out


def node_proto(op_type: str, inputs, outputs, name: str = "", **attrs) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    out = b"".join(_str_field(1, i) for i in inputs)
    out += b"".join(_str_field(2, o) for o in outputs)
    out += _str_field(3, name or outputs[0])
    out += _str_field(4, op_type)
    for k, v in attrs.items():
        out += _len_delim(5, attribute_proto(k, v))
    return out


def value_info_proto(name: str, dtype: np.dtype, shape) -> bytes:
    """ValueInfoProto{name=1, type=2}; TypeProto{tensor_type=1};
    Tensor{elem_type=1, shape=2}; TensorShapeProto{dim=1}; Dim{dim_value=1}."""
    dims = b"".join(_len_delim(1, _int_field(1, int(d))) for d in shape)
    tensor_type = _int_field(1, NP2ONNX[np.dtype(dtype)]) + _len_delim(2, dims)
    return _str_field(1, name) + _len_delim(2, _len_delim(1, tensor_type))


def graph_proto(nodes, name, initializers, inputs, outputs) -> bytes:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    out = b"".join(_len_delim(1, n) for n in nodes)
    out += _str_field(2, name)
    out += b"".join(_len_delim(5, t) for t in initializers)
    out += b"".join(_len_delim(11, v) for v in inputs)
    out += b"".join(_len_delim(12, v) for v in outputs)
    return out


def model_proto(graph: bytes, opset: int = 13, ir_version: int = 8,
                producer: str = "sar-yolo-tpu") -> bytes:
    """ModelProto: ir_version=1, producer_name=2, graph=7, opset_import=8;
    OperatorSetIdProto: domain=1, version=2."""
    out = _int_field(1, ir_version)
    out += _str_field(2, producer)
    out += _len_delim(7, graph)
    out += _len_delim(8, _str_field(1, "") + _int_field(2, opset))
    return out


# ----------------------------------------------------------------------------
# decode side (round-trip verification + the numpy reference runtime)
# ----------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    shift, result = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (fieldnum, wire_type, value) over a serialized message."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        fieldnum, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            v = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif wire == 1:
            v = struct.unpack("<d", buf[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield fieldnum, wire, v


def _unpack_int64s(v, wire) -> list:
    if wire == 0:
        return [_signed64(v)]
    out, pos = [], 0
    while pos < len(v):
        x, pos = _read_varint(v, pos)
        out.append(_signed64(x))
    return out


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


@dataclass
class Tensor:
    name: str = ""
    dims: list = field(default_factory=list)
    data_type: int = 0
    raw: bytes = b""

    def to_numpy(self) -> np.ndarray:
        dt = ONNX2NP[self.data_type].newbyteorder("<")
        return np.frombuffer(self.raw, dtype=dt).reshape(self.dims).astype(
            ONNX2NP[self.data_type])


@dataclass
class Node:
    op_type: str = ""
    name: str = ""
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    attrs: dict = field(default_factory=dict)


@dataclass
class Graph:
    name: str = ""
    nodes: list = field(default_factory=list)
    initializers: list = field(default_factory=list)
    inputs: list = field(default_factory=list)   # (name, dtype, shape)
    outputs: list = field(default_factory=list)


@dataclass
class Model:
    ir_version: int = 0
    opset: int = 0
    producer: str = ""
    graph: Graph = field(default_factory=Graph)


def _parse_tensor(buf: bytes) -> Tensor:
    t = Tensor()
    for f, w, v in _iter_fields(buf):
        if f == 1:
            t.dims += _unpack_int64s(v, w)
        elif f == 2:
            t.data_type = v
        elif f == 8:
            t.name = v.decode()
        elif f == 9:
            t.raw = v
    return t


def _parse_attr(buf: bytes):
    name, val, ints, floats = "", None, [], []
    for f, w, v in _iter_fields(buf):
        if f == 1:
            name = v.decode()
        elif f == 2:
            val = v
        elif f == 3:
            val = _signed64(v)
        elif f == 4:
            val = v.decode()
        elif f == 5:
            val = _parse_tensor(v).to_numpy()
        elif f == 7:
            floats.append(v)
        elif f == 8:
            ints += _unpack_int64s(v, w)
    if ints:
        val = ints
    elif floats:
        val = floats
    return name, val


def _parse_node(buf: bytes) -> Node:
    n = Node()
    for f, w, v in _iter_fields(buf):
        if f == 1:
            n.inputs.append(v.decode())
        elif f == 2:
            n.outputs.append(v.decode())
        elif f == 3:
            n.name = v.decode()
        elif f == 4:
            n.op_type = v.decode()
        elif f == 5:
            k, av = _parse_attr(v)
            n.attrs[k] = av
    return n


def _parse_value_info(buf: bytes):
    name, elem, shape = "", 0, []
    for f, w, v in _iter_fields(buf):
        if f == 1:
            name = v.decode()
        elif f == 2:
            for f2, w2, v2 in _iter_fields(v):
                if f2 == 1:  # tensor_type
                    for f3, w3, v3 in _iter_fields(v2):
                        if f3 == 1:
                            elem = v3
                        elif f3 == 2:  # shape
                            for f4, w4, v4 in _iter_fields(v3):
                                if f4 == 1:  # dim
                                    dv = 0
                                    for f5, w5, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            dv = v5
                                    shape.append(dv)
    return name, ONNX2NP.get(elem, np.dtype(np.float32)), shape


def _parse_graph(buf: bytes) -> Graph:
    g = Graph()
    for f, w, v in _iter_fields(buf):
        if f == 1:
            g.nodes.append(_parse_node(v))
        elif f == 2:
            g.name = v.decode()
        elif f == 5:
            g.initializers.append(_parse_tensor(v))
        elif f == 11:
            g.inputs.append(_parse_value_info(v))
        elif f == 12:
            g.outputs.append(_parse_value_info(v))
    return g


def parse_model(buf: bytes) -> Model:
    m = Model()
    for f, w, v in _iter_fields(buf):
        if f == 1:
            m.ir_version = v
        elif f == 2:
            m.producer = v.decode()
        elif f == 7:
            m.graph = _parse_graph(v)
        elif f == 8:
            for f2, w2, v2 in _iter_fields(v):
                if f2 == 2:
                    m.opset = max(m.opset, v2)
    return m
