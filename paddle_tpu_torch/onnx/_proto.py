"""Minimal ONNX protobuf writer / reader (the port's copy of
``paddle_tpu/onnx/_proto.py``).

Hand-encoded protobuf wire format for the subset of onnx.proto needed to
serialise inference graphs (ModelProto / GraphProto / NodeProto /
TensorProto / ValueInfoProto / AttributeProto), following the public
ONNX schema field numbers; no ``onnx`` package is needed. Files written
here are standard ONNX. Messages are joined once (``b"".join``), so a
model of a few hundred MB of initializers is written in linear time.
``parse`` is a generic tag-length-value reader (``onnx/_interp.py`` and
the tests read models back with it).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np

# ONNX TensorProto.DataType
DT_FLOAT = 1
DT_INT32 = 6
DT_INT64 = 7
DT_BOOL = 9
DT_DOUBLE = 11

DT_UINT8 = 2
DT_INT8 = 3
DT_FLOAT16 = 10

NP_TO_ONNX = {
    np.dtype(np.float32): DT_FLOAT,
    np.dtype(np.int32): DT_INT32,
    np.dtype(np.int64): DT_INT64,
    np.dtype(np.bool_): DT_BOOL,
    np.dtype(np.float64): DT_DOUBLE,
    np.dtype(np.uint8): DT_UINT8,
    np.dtype(np.int8): DT_INT8,
    np.dtype(np.float16): DT_FLOAT16,
}
ONNX_TO_NP = {v: k for k, v in NP_TO_ONNX.items()}

# AttributeProto.AttributeType
AT_FLOAT, AT_INT, AT_STRING, AT_TENSOR = 1, 2, 3, 4
AT_FLOATS, AT_INTS, AT_STRINGS = 6, 7, 8


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def f_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(int(value))


def f_bytes(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(data)) + data


def f_string(field: int, s: str) -> bytes:
    return f_bytes(field, s.encode())


def f_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(v))


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)  # np.ascontiguousarray would make 0-d 1-d
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    return b"".join([f_varint(1, d) for d in arr.shape]      # dims
                    + [f_varint(2, NP_TO_ONNX[arr.dtype]),   # data_type
                       f_string(8, name),                    # name
                       f_bytes(9, arr.tobytes())])           # raw_data


def value_info(name: str, dtype: np.dtype, shape) -> bytes:
    dims = []
    for d in shape:
        if d is None or (isinstance(d, int) and d < 0):
            dim = f_string(2, "N")                 # dim_param
        else:
            dim = f_varint(1, int(d))              # dim_value
        dims.append(f_bytes(1, dim))               # TensorShapeProto.dim
    tt = f_varint(1, NP_TO_ONNX[np.dtype(dtype)])  # elem_type
    tt += f_bytes(2, b"".join(dims))               # shape
    tp = f_bytes(1, tt)                            # TypeProto.tensor_type
    return f_string(1, name) + f_bytes(2, tp)      # ValueInfoProto


def attribute(name: str, value) -> bytes:
    out = f_string(1, name)
    if isinstance(value, float):
        out += f_float(2, value) + f_varint(20, AT_FLOAT)
    elif isinstance(value, bool) or isinstance(value, (int, np.integer)):
        out += f_varint(3, int(value)) + f_varint(20, AT_INT)
    elif isinstance(value, str):
        out += f_bytes(4, value.encode()) + f_varint(20, AT_STRING)
    elif isinstance(value, np.ndarray):
        out += f_bytes(5, tensor_proto(name + "_t", value))
        out += f_varint(20, AT_TENSOR)
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            for v in value:
                out += f_float(7, v)
            out += f_varint(20, AT_FLOATS)
        else:
            for v in value:
                out += f_varint(8, int(v))
            out += f_varint(20, AT_INTS)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return out


def node(op_type: str, inputs: List[str], outputs: List[str],
         name: str = "", attrs: Dict[str, Any] = None) -> bytes:
    parts = [f_string(1, i) for i in inputs]
    parts += [f_string(2, o) for o in outputs]
    if name:
        parts.append(f_string(3, name))
    parts.append(f_string(4, op_type))
    parts += [f_bytes(5, attribute(k, v)) for k, v in (attrs or {}).items()]
    return b"".join(parts)


def graph(nodes: List[bytes], name: str, inputs: List[bytes],
          outputs: List[bytes], initializers: List[bytes]) -> bytes:
    return b"".join([f_bytes(1, n) for n in nodes]
                    + [f_string(2, name)]
                    + [f_bytes(5, t) for t in initializers]
                    + [f_bytes(11, i) for i in inputs]
                    + [f_bytes(12, o) for o in outputs])


def model(graph_msg: bytes, opset_version: int = 13,
          producer: str = "paddle_tpu_torch") -> bytes:
    opset = f_string(1, "") + f_varint(2, opset_version)
    return b"".join([f_varint(1, 8),           # ir_version 8
                     f_string(2, producer),    # producer_name
                     f_bytes(7, graph_msg),    # graph
                     f_bytes(8, opset)])       # opset_import


# -- generic reader (tests / debugging) -----------------------------------

def parse(data: bytes) -> Dict[int, List[Tuple[int, Any]]]:
    """Decode one protobuf message into {field: [(wire_type, value)]}.
    Length-delimited values stay as bytes (parse them recursively)."""
    out: Dict[int, List[Tuple[int, Any]]] = {}
    i = 0

    def rd_varint():
        nonlocal i
        n = shift = 0
        while True:
            b = data[i]
            i += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7

    while i < len(data):
        key = rd_varint()
        field, wire = key >> 3, key & 7
        if wire == 0:
            val: Any = rd_varint()
        elif wire == 2:
            ln = rd_varint()
            val = data[i:i + ln]
            i += ln
        elif wire == 5:
            val = struct.unpack("<f", data[i:i + 4])[0]
            i += 4
        elif wire == 1:
            val = struct.unpack("<d", data[i:i + 8])[0]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.setdefault(field, []).append((wire, val))
    return out
