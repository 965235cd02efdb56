"""Minimal clean-room ONNX serializer (protobuf wire format, no deps).

The reference ships an ONNX artifact (reference tools/export_onnx.py:20)
via torch's exporter; neither `onnx` nor an exporter that works without it
is importable in this environment, and ONNX is just a protobuf message —
so this module encodes the ONNX ModelProto wire format directly. It
implements only what the YOLOX export needs (tools/export_onnx.py):

  ModelProto / GraphProto / NodeProto / AttributeProto / TensorProto /
  ValueInfoProto / TypeProto.Tensor / TensorShapeProto / OperatorSetId

with tensors stored as little-endian `raw_data` — the standard layout
every ONNX runtime loads. Field numbers follow the canonical onnx.proto
(IR version 8, stable since IR v3). A generic wire-format parser
(`parse_message`) is included so tests and pl_yolo_tpu/deploy/
onnx_numpy_runtime.py can load the artifact back without the onnx
package either.

Protobuf wire format (the whole spec this file needs):
  key = (field_number << 3) | wire_type
  wire 0: varint   wire 1: 64-bit LE   wire 2: length-delimited   wire 5: 32-bit LE
  repeated numeric fields are emitted packed (one wire-2 blob).
"""

from __future__ import annotations

import struct

import numpy as np

# TensorProto.DataType (canonical enum values)
FLOAT = 1
UINT8 = 2
INT8 = 3
INT32 = 6
INT64 = 7
BOOL = 9

_NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.bool_): BOOL,
}


# ------------------------------------------------------------ wire encoding

def _varint(n: int) -> bytes:
    if n < 0:  # two's-complement 64-bit, per protobuf int64 semantics
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def f_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(int(value))


def f_bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def f_str(field: int, value: str) -> bytes:
    return f_bytes(field, value.encode("utf-8"))


def f_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def f_packed_varints(field: int, values) -> bytes:
    body = b"".join(_varint(int(v)) for v in values)
    return f_bytes(field, body)


def f_packed_floats(field: int, values) -> bytes:
    return f_bytes(field, struct.pack(f"<{len(values)}f", *values))


# ------------------------------------------------------------ ONNX messages

def tensor(name: str, array: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    a = np.ascontiguousarray(array)
    if a.dtype not in _NP_TO_ONNX:
        a = a.astype(np.float32)
    msg = f_packed_varints(1, a.shape)
    msg += f_varint(2, _NP_TO_ONNX[a.dtype])
    msg += f_str(8, name)
    msg += f_bytes(9, a.astype(a.dtype.newbyteorder("<")).tobytes())
    return msg


def _attribute(name: str, value) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8,
    strings=9, type=20. Type inferred from the python value."""
    msg = f_str(1, name)
    if isinstance(value, bool):
        msg += f_varint(3, int(value)) + f_varint(20, 2)          # INT
    elif isinstance(value, int):
        msg += f_varint(3, value) + f_varint(20, 2)               # INT
    elif isinstance(value, float):
        msg += f_float(2, value) + f_varint(20, 1)                # FLOAT
    elif isinstance(value, str):
        msg += f_bytes(4, value.encode()) + f_varint(20, 3)       # STRING
    elif isinstance(value, bytes):
        msg += f_bytes(4, value) + f_varint(20, 3)                # STRING
    elif isinstance(value, np.ndarray):
        msg += f_bytes(5, tensor("", value)) + f_varint(20, 4)    # TENSOR
    elif isinstance(value, (list, tuple)) and value and \
            all(isinstance(v, float) for v in value):
        msg += f_packed_floats(7, value) + f_varint(20, 6)        # FLOATS
    elif isinstance(value, (list, tuple)):
        msg += f_packed_varints(8, value) + f_varint(20, 7)       # INTS
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return msg


def node(op_type: str, inputs, outputs, name: str = "", **attrs) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    msg = b"".join(f_str(1, i) for i in inputs)
    msg += b"".join(f_str(2, o) for o in outputs)
    if name:
        msg += f_str(3, name)
    msg += f_str(4, op_type)
    for k, v in attrs.items():
        msg += f_bytes(5, _attribute(k, v))
    return msg


def value_info(name: str, elem_type: int, shape) -> bytes:
    """ValueInfoProto with TypeProto.Tensor. shape entries: int (dim_value)
    or str (dim_param, e.g. a symbolic batch)."""
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dim = f_str(2, d)
        else:
            dim = f_varint(1, int(d))
        dims += f_bytes(1, dim)                     # TensorShapeProto.dim
    tensor_type = f_varint(1, elem_type) + f_bytes(2, dims)
    type_proto = f_bytes(1, tensor_type)            # TypeProto.tensor_type
    return f_str(1, name) + f_bytes(2, type_proto)


def graph(nodes, name, inputs, outputs, initializers) -> bytes:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    msg = b"".join(f_bytes(1, n) for n in nodes)
    msg += f_str(2, name)
    msg += b"".join(f_bytes(5, t) for t in initializers)
    msg += b"".join(f_bytes(11, vi) for vi in inputs)
    msg += b"".join(f_bytes(12, vi) for vi in outputs)
    return msg


def model(graph_bytes: bytes, opset: int = 13, ir_version: int = 8,
          producer: str = "pl_yolo_tpu") -> bytes:
    """ModelProto: ir_version=1, producer_name=2, graph=7, opset_import=8."""
    opset_id = f_str(1, "") + f_varint(2, opset)
    return (f_varint(1, ir_version)
            + f_str(2, producer)
            + f_bytes(7, graph_bytes)
            + f_bytes(8, opset_id))


# ------------------------------------------------------------ wire parsing

def parse_message(data: bytes) -> dict[int, list]:
    """Generic wire-format decode: field -> list of raw values (int for
    varint/fixed, bytes for length-delimited). Nested messages are parsed
    lazily by calling parse_message on the bytes again."""
    out: dict[int, list] = {}
    i, n = 0, len(data)
    while i < n:
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(data, i)
        elif wire == 1:
            v = data[i:i + 8]
            i += 8
        elif wire == 2:
            ln, i = _read_varint(data, i)
            v = data[i:i + ln]
            i += ln
        elif wire == 5:
            v = data[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.setdefault(field, []).append(v)
    return out


def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    shift = v = 0
    while True:
        b = data[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def parse_packed_varints(blob: bytes) -> list[int]:
    out, i = [], 0
    while i < len(blob):
        v, i = _read_varint(blob, i)
        out.append(v)
    return out


def parse_tensor(blob: bytes) -> tuple[str, np.ndarray]:
    """Decode a TensorProto (raw_data or float_data/int64_data variants)."""
    msg = parse_message(blob)
    dims = []
    for v in msg.get(1, []):
        dims.extend(parse_packed_varints(v) if isinstance(v, bytes) else [v])
    dtype_code = msg.get(2, [FLOAT])[0]
    name = msg.get(8, [b""])[0].decode()
    np_dtype = {FLOAT: np.float32, UINT8: np.uint8, INT8: np.int8,
                INT32: np.int32, INT64: np.int64, BOOL: np.bool_}[dtype_code]
    if 9 in msg:
        arr = np.frombuffer(msg[9][0], dtype=np.dtype(np_dtype).newbyteorder("<"))
    elif 4 in msg:  # float_data (packed)
        arr = np.frombuffer(msg[4][0], dtype="<f4")
    elif 7 in msg:  # int64_data (packed varints)
        vals = []
        for v in msg[7]:
            vals.extend(parse_packed_varints(v) if isinstance(v, bytes)
                        else [v])
        arr = np.array([v - (1 << 64) if v >= (1 << 63) else v
                        for v in vals], np.int64)
    else:
        arr = np.zeros(0, np_dtype)
    return name, np.asarray(arr, np_dtype).reshape(dims)
