"""Read an ONNX model back and run it in numpy.

The reference interpreter of the ops ``onnx/_convert.py`` emits: the
tests and the chip check parse the written bytes with ``_proto.parse``
and run the graph here, each op by its ONNX definition, to hold the
file's values against the model that was exported (no ``onnx`` or
``onnxruntime`` package is needed).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from . import _proto as P


def _parse_tensor(data) -> Tuple[str, np.ndarray]:
    msg = P.parse(data)
    dims = [v for _, v in msg.get(1, [])]
    dt = msg[2][0][1]
    name = msg[8][0][1].decode()
    raw = msg[9][0][1]
    return name, np.frombuffer(raw, P.ONNX_TO_NP[dt]).reshape(dims)


def _signed(v: int) -> int:
    """An int64 varint read back (two's complement)."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _parse_attr(data) -> Tuple[str, object]:
    msg = P.parse(data)
    name = msg[1][0][1].decode()
    at = msg[20][0][1]
    if at == P.AT_FLOAT:
        return name, msg[2][0][1]
    if at == P.AT_INT:
        return name, _signed(msg[3][0][1])
    if at == P.AT_STRING:
        return name, msg[4][0][1].decode()
    if at == P.AT_INTS:
        return name, [_signed(v) for _, v in msg.get(8, [])]
    if at == P.AT_FLOATS:
        return name, [v for _, v in msg.get(7, [])]
    raise ValueError(f"attribute type {at}")


def _value_info(data) -> Tuple[str, int, List[int]]:
    msg = P.parse(data)
    name = msg[1][0][1].decode()
    tensor = P.parse(P.parse(msg[2][0][1])[1][0][1])
    elem = tensor[1][0][1]
    dims = [P.parse(d)[1][0][1] for _, d in P.parse(tensor[2][0][1])
            .get(1, [])] if 2 in tensor else []
    return name, elem, dims


def parse_model(data: bytes):
    """``(nodes, initializers, inputs, outputs, opset)``: nodes as dicts
    of ``op`` / ``inputs`` / ``outputs`` / ``attrs``, initializers by
    name, graph inputs and outputs as ``(name, elem type, dims)``."""
    model = P.parse(data)
    if model[1][0][1] != 8:
        raise ValueError(f"ir_version {model[1][0][1]}")
    opset = P.parse(model[8][0][1])[2][0][1]
    g = P.parse(model[7][0][1])
    nodes = []
    for _, nd in g.get(1, []):
        n = P.parse(nd)
        nodes.append({
            "op": n[4][0][1].decode(),
            "inputs": [v.decode() for _, v in n.get(1, [])],
            "outputs": [v.decode() for _, v in n.get(2, [])],
            "attrs": dict(_parse_attr(a) for _, a in n.get(5, [])),
        })
    inits = dict(_parse_tensor(t) for _, t in g.get(5, []))
    ins = [_value_info(v) for _, v in g.get(11, [])]
    outs = [_value_info(v) for _, v in g.get(12, [])]
    return nodes, inits, ins, outs, opset


def _erf(x):
    from scipy.special import erf
    return erf(x).astype(x.dtype)


def _softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def _conv(x, w, b, attrs):
    """NCHW 2-D convolution (ONNX ``Conv``) through an im2col product."""
    sh, sw = attrs.get("strides", [1, 1])
    dh, dw = attrs.get("dilations", [1, 1])
    groups = attrs.get("group", 1)
    pads = attrs.get("pads", [0, 0, 0, 0])
    x = np.pad(x, ((0, 0), (0, 0), (pads[0], pads[2]), (pads[1], pads[3])))
    n, cin, h, wd = x.shape
    cout, cg, kh, kw = w.shape
    oh = (h - dh * (kh - 1) - 1) // sh + 1
    ow = (wd - dw * (kw - 1) - 1) // sw + 1
    out = np.empty((n, cout, oh, ow), np.result_type(x, w))
    og = cout // groups
    for g in range(groups):
        xg = x[:, g * cg:(g + 1) * cg]
        cols = np.stack([xg[:, :, ky * dh:ky * dh + sh * (oh - 1) + 1:sh,
                            kx * dw:kx * dw + sw * (ow - 1) + 1:sw]
                         for ky in range(kh) for kx in range(kw)], axis=2)
        wg = w[g * og:(g + 1) * og].reshape(og, cg, kh * kw)
        out[:, g * og:(g + 1) * og] = np.einsum("ncktw,ock->notw", cols, wg,
                                                optimize=True)
    if b is not None:
        out += b.reshape(1, -1, 1, 1)
    return out


def _op(op, i, attrs):
    if op == "MatMul":
        return np.matmul(i[0], i[1])
    if op == "Add":
        return i[0] + i[1]
    if op == "Sub":
        return i[0] - i[1]
    if op == "Mul":
        return i[0] * i[1]
    if op == "Div":
        if np.issubdtype(i[0].dtype, np.integer):
            return np.trunc(i[0] / i[1]).astype(i[0].dtype)
        return i[0] / i[1]
    if op == "Max":
        return np.maximum(i[0], i[1])
    if op == "Min":
        return np.minimum(i[0], i[1])
    if op == "Relu":
        return np.maximum(i[0], np.zeros((), i[0].dtype))
    if op == "Tanh":
        return np.tanh(i[0])
    if op == "Sigmoid":
        return (1.0 / (1.0 + np.exp(-i[0]))).astype(i[0].dtype)
    if op == "Exp":
        return np.exp(i[0])
    if op == "Log":
        return np.log(i[0])
    if op == "Erf":
        return _erf(i[0])
    if op == "Sqrt":
        return np.sqrt(i[0])
    if op == "Reciprocal":
        return (1.0 / i[0]).astype(i[0].dtype)
    if op == "Neg":
        return -i[0]
    if op == "Abs":
        return np.abs(i[0])
    if op == "Pow":
        return np.power(i[0], i[1]).astype(i[0].dtype)
    if op == "Softmax":
        return _softmax(i[0], attrs.get("axis", -1))
    if op == "LogSoftmax":
        x = i[0]
        ax = attrs.get("axis", -1)
        m = x.max(axis=ax, keepdims=True)
        return x - m - np.log(np.exp(x - m).sum(axis=ax, keepdims=True))
    if op == "ReduceSum":
        return i[0].sum(axis=tuple(i[1].tolist()),
                        keepdims=bool(attrs.get("keepdims", 1)))
    if op == "ReduceMean":
        return i[0].mean(axis=tuple(attrs["axes"]),
                         keepdims=bool(attrs.get("keepdims", 1)))
    if op == "ReduceMax":
        return i[0].max(axis=tuple(attrs["axes"]),
                        keepdims=bool(attrs.get("keepdims", 1)))
    if op == "Reshape":
        return i[0].reshape(i[1].tolist())
    if op == "Transpose":
        return i[0].transpose(attrs["perm"])
    if op == "Expand":
        return np.broadcast_to(i[0], np.broadcast_shapes(
            i[0].shape, tuple(i[1].tolist())))
    if op == "Unsqueeze":
        return np.expand_dims(i[0], tuple(i[1].tolist()))
    if op == "Squeeze":
        return np.squeeze(i[0], axis=tuple(i[1].tolist()))
    if op == "Identity":
        return i[0]
    if op == "Cast":
        return i[0].astype(P.ONNX_TO_NP[attrs["to"]])
    if op == "Conv":
        return _conv(i[0], i[1], i[2] if len(i) > 2 else None, attrs)
    if op == "Gather":
        return np.take(i[0], i[1], axis=attrs.get("axis", 0))
    if op == "Slice":
        starts, ends, axes, steps = (v.tolist() for v in i[1:5])
        sl = [slice(None)] * i[0].ndim
        for s, e, a, st in zip(starts, ends, axes, steps):
            sl[a] = slice(s, e, st)
        return i[0][tuple(sl)]
    if op == "Concat":
        return np.concatenate(i, axis=attrs["axis"])
    if op == "Einsum":
        return np.einsum(attrs["equation"], *i, optimize=True)
    if op == "Where":
        return np.where(i[0], i[1], i[2])
    if op == "Equal":
        return i[0] == i[1]
    if op == "Less":
        return i[0] < i[1]
    if op == "Greater":
        return i[0] > i[1]
    if op == "LessOrEqual":
        return i[0] <= i[1]
    if op == "GreaterOrEqual":
        return i[0] >= i[1]
    if op == "Not":
        return ~i[0]
    if op == "And":
        return i[0] & i[1]
    if op == "Or":
        return i[0] | i[1]
    if op == "Pad":
        p = i[1].tolist()
        k = len(p) // 2
        value = i[2].item() if len(i) > 2 else 0
        return np.pad(i[0], list(zip(p[:k], p[k:])), constant_values=value)
    raise NotImplementedError(f"interpreter: op {op} is not emitted by "
                              f"the exporter")


def run_graph(nodes, env: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Run ``nodes`` over ``env`` (initializers and inputs by name);
    returns ``env`` with every node's outputs added."""
    for n in nodes:
        ins = [env[x] for x in n["inputs"]]
        out = _op(n["op"], ins, n["attrs"])
        env[n["outputs"][0]] = np.asarray(out)
    return env


def run_model(data: bytes, feeds: Dict[str, np.ndarray]) -> List[np.ndarray]:
    """The graph outputs of the ONNX model ``data`` on ``feeds``."""
    nodes, inits, _, outs, _ = parse_model(data)
    env = dict(inits)
    env.update(feeds)
    env = run_graph(nodes, env)
    return [env[name] for name, _, _ in outs]
