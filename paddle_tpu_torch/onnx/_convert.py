"""``torch.export`` program -> ONNX graph.

Reference: ``python/paddle/onnx/export.py`` hands a traced program to
paddle2onnx; the JAX package walks a jaxpr (``paddle_tpu/onnx/
_convert.py``). The port walks the ``torch.export`` program of
``static/program.py``, decomposed to the core ATen op set, and maps
each op onto standard ONNX ops at opset 13: the matmul / convolution /
elementwise / activation / normalisation / indexing family that Linear,
Conv, MLP and transformer encoders lower to. Ops whose inputs are all
constants (``arange``, ``full``, masks built from them) are evaluated
here and written as initializers. An op outside that family raises
``NotImplementedError`` naming it.

The port's registered kernel ops have no ONNX counterpart:
``paddle_tpu_torch::attention_fwd`` (#4 / #5 / #9) and
``paddle_tpu_torch::fused_bottleneck`` (#11) are written as their plain
math (``attention_reference``, ``fused_bottleneck_reference``, traced
at the node's shapes and converted like the rest of the graph), so the
file computes what the kernels compute, in standard ONNX ops.
"""

from __future__ import annotations

import math
import operator
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import _proto as P

_NP = {torch.float32: np.float32, torch.float64: np.float64,
       torch.float16: np.float16, torch.int32: np.int32,
       torch.int64: np.int64, torch.int8: np.int8, torch.uint8: np.uint8,
       torch.bool: np.bool_}

# ops that carry no value into the graph
_SKIP = {"aten._assert_tensor_metadata.default"}
_IDENTITY = {"aten.clone.default", "aten.alias.default",
             "aten.detach.default", "aten.lift_fresh_copy.default",
             "aten.contiguous.default"}


def _np_dtype(dtype: torch.dtype):
    try:
        return _NP[dtype]
    except KeyError:
        raise NotImplementedError(
            f"onnx export: dtype {dtype} has no ONNX type here") from None


def _meta(node):
    return node.meta["val"]


class _Fn(torch.nn.Module):
    """A function as the module ``torch.export`` traces."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *xs):
        return self.fn(*xs)


_REFERENCE_CACHE: Dict[tuple, torch.export.ExportedProgram] = {}


def _reference_program(kind: str, node) -> torch.export.ExportedProgram:
    """The plain math of a registered kernel op at ``node``'s shapes,
    traced on the CPU and decomposed (once a signature: the layers of a
    model share it)."""
    key = (kind,) + tuple(
        (tuple(_meta(a).shape), _meta(a).dtype)
        if isinstance(a, torch.fx.Node) else a for a in node.args)
    if key not in _REFERENCE_CACHE:
        _REFERENCE_CACHE[key] = _trace_reference(kind, node)
    return _REFERENCE_CACHE[key]


def _trace_reference(kind: str, node) -> torch.export.ExportedProgram:
    if kind == "attention_fwd":
        from ..ops.kernels.attention import attention_reference
        q, k, v, causal, scale, _ = node.args

        def fn(q_, k_, v_):
            return attention_reference(q_, k_, v_, causal=bool(causal),
                                       scale=float(scale))
        tensors = (q, k, v)
    else:
        from ..ops.kernels.fused_conv_block import fused_bottleneck_reference
        fn = fused_bottleneck_reference
        tensors = node.args
    examples = tuple(torch.zeros(tuple(_meta(t).shape), dtype=_meta(t).dtype)
                     for t in tensors)
    with torch.no_grad():
        ep = torch.export.export(_Fn(fn), examples, strict=False)
    return ep.run_decompositions()


class Converter:
    """Builds one ONNX graph from one or more ``torch.export`` programs
    (a kernel op's plain math is walked into the same graph)."""

    def __init__(self):
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self.written = set()
        # values known here: parameters (written as they are) and
        # constants (foldable); name -> numpy array
        self.params: Dict[str, np.ndarray] = {}
        self.consts: Dict[str, np.ndarray] = {}
        self.dtypes: Dict[str, torch.dtype] = {}
        self._n = 0

    # -- names and values ----------------------------------------------------

    def fresh(self, prefix: str = "t") -> str:
        self._n += 1
        return f"{prefix}_{self._n}"

    def ref(self, name: str) -> str:
        """``name`` for a node input: a parameter or constant becomes an
        initializer at its first use."""
        if name not in self.written:
            arr = self.params.get(name)
            if arr is None:
                arr = self.consts.get(name)
            if arr is not None:
                self.initializers.append(P.tensor_proto(name, arr))
                self.written.add(name)
        return name

    def const(self, value, dtype) -> str:
        name = self.fresh("const")
        self.consts[name] = np.asarray(value, dtype=dtype)
        return name

    def emit(self, op: str, ins: Sequence[str], **attrs) -> str:
        out = self.fresh(op.lower())
        self.nodes.append(P.node(op, [self.ref(i) for i in ins], [out],
                                 name=f"{op}_{len(self.nodes)}",
                                 attrs=attrs))
        return out

    def cast(self, name: str, have: torch.dtype, want: torch.dtype) -> str:
        if have == want:
            return name
        if name in self.consts:
            return self.const(self.consts[name].astype(_np_dtype(want)),
                              _np_dtype(want))
        return self.emit("Cast", [name], to=P.NP_TO_ONNX[
            np.dtype(_np_dtype(want))])

    # -- the walk --------------------------------------------------------------

    def walk(self, ep: torch.export.ExportedProgram, bound: Sequence):
        """Convert ``ep``'s graph with its user inputs bound to ``bound``
        (names); returns the names of its outputs, flattened."""
        from torch.export.graph_signature import InputKind
        env: Dict[Any, Any] = {}
        user = iter(bound)
        specs = ep.graph_signature.input_specs
        placeholders = [n for n in ep.graph.nodes if n.op == "placeholder"]
        for node, spec in zip(placeholders, specs):
            if spec.kind == InputKind.USER_INPUT:
                env[node] = next(user)
                continue
            if spec.kind == InputKind.CONSTANT_TENSOR:
                value = ep.constants[spec.target]
            else:
                value = ep.state_dict[spec.target]
            name = self.fresh("c")
            self.consts[name] = value.detach().cpu().numpy()
            self.dtypes[name] = value.dtype
            env[node] = name
        out = None
        for node in ep.graph.nodes:
            if node.op == "call_function":
                env[node] = self.call(node, env)
                if isinstance(env[node], str) and "val" in node.meta \
                        and isinstance(_meta(node), torch.Tensor):
                    self.dtypes[env[node]] = _meta(node).dtype
            elif node.op == "output":
                out = pytree.tree_leaves(pytree.tree_map_only(
                    torch.fx.Node, lambda n: env[n], node.args[0]))
        return out

    def call(self, node, env):
        target = node.target
        if target is operator.getitem:
            return env[node.args[0]][node.args[1]]
        name = str(target)
        if name in _SKIP:
            return None
        args = pytree.tree_map_only(torch.fx.Node, lambda n: env[n],
                                     node.args)
        kwargs = pytree.tree_map_only(torch.fx.Node, lambda n: env[n],
                                      node.kwargs)
        if name.startswith("paddle_tpu_torch."):
            kind = name.split(".")[1]
            if kind not in ("attention_fwd", "fused_bottleneck"):
                raise NotImplementedError(
                    f"onnx export: unsupported op {name!r} (a kernel op "
                    f"with no plain-math form here)")
            tensors = args[:3] if kind == "attention_fwd" else args
            outs = self.walk(_reference_program(kind, node), tensors)
            return tuple(outs) if len(outs) > 1 else outs[0]
        folded = self._fold(target, node, args, kwargs)
        if folded is not None:
            return folded
        handler = _HANDLERS.get(name)
        if handler is None:
            raise NotImplementedError(
                f"onnx export: unsupported aten op {name!r}; supported "
                f"scope is the matmul / conv / elementwise / activation / "
                f"normalisation / indexing family")
        return handler(self, node, *args, **kwargs)

    def _fold(self, target, node, args, kwargs) -> Optional[str]:
        """Evaluate a node whose tensor inputs are all constants (not
        parameters); None when it has another input."""
        if not isinstance(node.meta.get("val"), torch.Tensor):
            return None
        nodes = pytree.tree_leaves((node.args, node.kwargs))
        values = pytree.tree_leaves((args, kwargs))
        if len(nodes) != len(values) or any(
                isinstance(n, torch.fx.Node) and v not in self.consts
                for n, v in zip(nodes, values)):
            return None

        def real(a):
            if isinstance(a, str) and a in self.consts:
                return torch.from_numpy(np.array(self.consts[a]))
            if isinstance(a, torch.device):
                return torch.device("cpu")
            return a
        try:
            value = target(*pytree.tree_map(real, args),
                           **pytree.tree_map(real, kwargs))
        except Exception:  # noqa: BLE001 - emitted as an op instead
            return None
        if not isinstance(value, torch.Tensor):
            return None
        name = self.fresh("fold")
        self.consts[name] = value.detach().contiguous().numpy()
        self.dtypes[name] = value.dtype
        return name


# -- op handlers ---------------------------------------------------------------

def _dt(cv, name) -> torch.dtype:
    return cv.dtypes[name]


def _operand(cv, x, want: torch.dtype) -> str:
    """A tensor name (cast to ``want``) or a Python number as a constant
    of ``want``."""
    if isinstance(x, str):
        return cv.cast(x, _dt(cv, x), want)
    return cv.const(x, _np_dtype(want))


def _binary(op):
    def h(cv, node, a, b, alpha=1, **_):
        want = _meta(node).dtype
        a, b = _operand(cv, a, want), _operand(cv, b, want)
        if alpha != 1:
            b = cv.emit("Mul", [b, cv.const(alpha, _np_dtype(want))])
        return cv.emit(op, [a, b])
    return h


def _rsub(cv, node, a, b, alpha=1):
    return _binary("Sub")(cv, node, b, a) if alpha == 1 else \
        cv.emit("Sub", [_operand(cv, b, _meta(node).dtype),
                        cv.emit("Mul", [_operand(cv, a, _meta(node).dtype),
                                        cv.const(alpha, _np_dtype(
                                            _meta(node).dtype))])])


def _div(cv, node, a, b, rounding_mode=None):
    if rounding_mode is not None:
        raise NotImplementedError(
            f"onnx export: div with rounding_mode={rounding_mode!r}")
    return _binary("Div")(cv, node, a, b)


def _compare(op, negate=False):
    def h(cv, node, a, b):
        dts = [_dt(cv, x) for x in (a, b) if isinstance(x, str)]
        want = dts[0]
        for d in dts[1:]:
            want = torch.promote_types(want, d)
        out = cv.emit(op, [_operand(cv, a, want), _operand(cv, b, want)])
        return cv.emit("Not", [out]) if negate else out
    return h


def _unary(op):
    def h(cv, node, x, *_, **__):
        return cv.emit(op, [x])
    return h


def _rsqrt(cv, node, x):
    return cv.emit("Reciprocal", [cv.emit("Sqrt", [x])])


def _pow(cv, node, x, e):
    want = _meta(node).dtype
    return cv.emit("Pow", [_operand(cv, x, want), _operand(cv, e, want)])


def _gelu(cv, node, x, approximate="none"):
    f = _np_dtype(_meta(node).dtype)
    if approximate == "tanh":
        inner = cv.emit("Add", [x, cv.emit("Mul", [
            cv.const(0.044715, f),
            cv.emit("Mul", [x, cv.emit("Mul", [x, x])])])])
        t = cv.emit("Tanh", [cv.emit("Mul", [
            cv.const(math.sqrt(2.0 / math.pi), f), inner])])
    else:
        t = cv.emit("Erf", [cv.emit("Mul", [
            x, cv.const(1.0 / math.sqrt(2.0), f)])])
    half_x = cv.emit("Mul", [x, cv.const(0.5, f)])
    return cv.emit("Mul", [half_x, cv.emit("Add", [cv.const(1.0, f), t])])


def _axis(d, ndim):
    return int(d) % ndim if ndim else 0


def _softmax(op):
    def h(cv, node, x, dim, half_to_float=False):
        return cv.emit(op, [x], axis=_axis(dim, _meta(node).dim()))
    return h


def _layer_norm(cv, node, x, shape, weight, bias, eps):
    nd = _meta(node.args[0]).dim()
    axes = list(range(nd - len(shape), nd))
    f = _np_dtype(_meta(node.args[0]).dtype)
    mean = cv.emit("ReduceMean", [x], axes=axes, keepdims=1)
    d = cv.emit("Sub", [x, mean])
    var = cv.emit("ReduceMean", [cv.emit("Mul", [d, d])], axes=axes,
                  keepdims=1)
    rstd = cv.emit("Reciprocal", [cv.emit("Sqrt", [
        cv.emit("Add", [var, cv.const(eps, f)])])])
    y = cv.emit("Mul", [d, rstd])
    if weight is not None:
        y = cv.emit("Mul", [y, weight])
    if bias is not None:
        y = cv.emit("Add", [y, bias])
    return y, mean, rstd


def _shape_const(cv, shape):
    return cv.const([int(s) for s in shape], np.int64)


def _reshape(cv, node, x, *_):
    return cv.emit("Reshape", [x, _shape_const(cv, _meta(node).shape)])


def _permute(cv, node, x, dims):
    nd = _meta(node).dim()
    return cv.emit("Transpose", [x], perm=[_axis(d, nd) for d in dims])


def _t(cv, node, x):
    return cv.emit("Transpose", [x], perm=list(range(_meta(node).dim()))[::-1])


def _transpose(cv, node, x, d0, d1):
    nd = _meta(node).dim()
    perm = list(range(nd))
    a, b = _axis(d0, nd), _axis(d1, nd)
    perm[a], perm[b] = perm[b], perm[a]
    return cv.emit("Transpose", [x], perm=perm)


def _expand(cv, node, x, *_, **__):
    return cv.emit("Expand", [x, _shape_const(cv, _meta(node).shape)])


def _unsqueeze(cv, node, x, dim):
    return cv.emit("Unsqueeze", [x, cv.const(
        [_axis(dim, _meta(node).dim())], np.int64)])


def _squeeze(cv, node, x, dims=None):
    shape = _meta(node.args[0]).shape
    nd = len(shape)
    if dims is None:
        axes = [i for i, s in enumerate(shape) if s == 1]
    else:
        dims = [dims] if isinstance(dims, int) else dims
        axes = [_axis(d, nd) for d in dims if shape[_axis(d, nd)] == 1]
    if not axes:
        return cv.emit("Identity", [x])
    return cv.emit("Squeeze", [x, cv.const(axes, np.int64)])


def _select(cv, node, x, dim, index):
    shape = _meta(node.args[0]).shape
    ax = _axis(dim, len(shape))
    return cv.emit("Gather", [x, cv.const(int(index) % shape[ax], np.int64)],
                   axis=ax)


def _slice(cv, node, x, dim=0, start=None, end=None, step=1):
    shape = _meta(node.args[0]).shape
    ax = _axis(dim, len(shape))
    n = shape[ax]
    start = 0 if start is None else (start + n if start < 0 else start)
    end = n if end is None else (end + n if end < 0 else end)
    start, end = max(0, min(start, n)), max(0, min(end, n))
    return cv.emit("Slice", [x, cv.const([start], np.int64),
                             cv.const([end], np.int64),
                             cv.const([ax], np.int64),
                             cv.const([step], np.int64)])


def _cat(cv, node, tensors, dim=0):
    want = _meta(node).dtype
    return cv.emit("Concat", [cv.cast(t, _dt(cv, t), want) for t in tensors],
                   axis=_axis(dim, _meta(node).dim()))


def _embedding(cv, node, weight, indices, *_):
    return cv.emit("Gather", [weight, indices], axis=0)


def _to_copy(cv, node, x, *_, **__):
    return cv.cast(x, _dt(cv, x), _meta(node).dtype) \
        if _dt(cv, x) != _meta(node).dtype else cv.emit("Identity", [x])


def _where(cv, node, cond, a, b):
    want = _meta(node).dtype
    return cv.emit("Where", [cond, _operand(cv, a, want),
                             _operand(cv, b, want)])


def _masked_fill(cv, node, x, mask, value):
    want = _meta(node).dtype
    return cv.emit("Where", [mask, _operand(cv, value, want), x])


def _reduce_attr(op):
    def h(cv, node, x, dims=None, keepdim=False, **_):
        nd = _meta(node.args[0]).dim()
        dims = range(nd) if dims is None else (
            [dims] if isinstance(dims, int) else dims)
        return cv.emit(op, [x], axes=[_axis(d, nd) for d in dims],
                       keepdims=int(bool(keepdim)))
    return h


def _sum(cv, node, x, dims=None, keepdim=False, dtype=None):
    nd = _meta(node.args[0]).dim()
    dims = range(nd) if dims is None else dims
    if dtype is not None:
        x = cv.cast(x, _dt(cv, x), dtype)
    return cv.emit("ReduceSum", [x, cv.const([_axis(d, nd) for d in dims],
                                             np.int64)],
                   keepdims=int(bool(keepdim)))


def _convolution(cv, node, x, w, b, stride, padding, dilation, transposed,
                 output_padding, groups):
    if transposed:
        raise NotImplementedError(
            "onnx export: transposed convolution is not supported")
    if _meta(node.args[0]).dim() != 4:
        raise NotImplementedError("onnx export: 2-D (NCHW) convolutions "
                                  "only")
    ins = [x, w] + ([b] if b is not None else [])
    return cv.emit("Conv", ins, strides=list(stride),
                   dilations=list(dilation), group=int(groups),
                   pads=list(padding) + list(padding))


def _pad(cv, node, x, pad, value=0.0):
    nd = _meta(node.args[0]).dim()
    begin, end = [0] * nd, [0] * nd
    for i in range(len(pad) // 2):
        begin[nd - 1 - i], end[nd - 1 - i] = pad[2 * i], pad[2 * i + 1]
    want = _meta(node).dtype
    return cv.emit("Pad", [x, cv.const(begin + end, np.int64),
                           cv.const(value, _np_dtype(want))])


def _clamp(cv, node, x, lo=None, hi=None):
    want = _meta(node).dtype
    if lo is not None:
        x = cv.emit("Max", [x, _operand(cv, lo, want)])
    if hi is not None:
        x = cv.emit("Min", [x, _operand(cv, hi, want)])
    return x


def _addmm(cv, node, bias, a, b, beta=1, alpha=1):
    f = _np_dtype(_meta(node).dtype)
    mm = cv.emit("MatMul", [a, b])
    if alpha != 1:
        mm = cv.emit("Mul", [mm, cv.const(alpha, f)])
    if beta != 1:
        bias = cv.emit("Mul", [bias, cv.const(beta, f)])
    return cv.emit("Add", [bias, mm])


_HANDLERS = {
    "aten.mm.default": lambda cv, n, a, b: cv.emit("MatMul", [a, b]),
    "aten.bmm.default": lambda cv, n, a, b: cv.emit("MatMul", [a, b]),
    "aten.matmul.default": lambda cv, n, a, b: cv.emit("MatMul", [a, b]),
    "aten.addmm.default": _addmm,
    "aten.add.Tensor": _binary("Add"), "aten.add.Scalar": _binary("Add"),
    "aten.sub.Tensor": _binary("Sub"), "aten.sub.Scalar": _binary("Sub"),
    "aten.rsub.Scalar": _rsub, "aten.rsub.Tensor": _rsub,
    "aten.mul.Tensor": _binary("Mul"), "aten.mul.Scalar": _binary("Mul"),
    "aten.div.Tensor": _div, "aten.div.Scalar": _div,
    "aten.div.Tensor_mode": _div,
    "aten.maximum.default": _binary("Max"),
    "aten.minimum.default": _binary("Min"),
    "aten.pow.Tensor_Scalar": _pow, "aten.pow.Tensor_Tensor": _pow,
    "aten.neg.default": _unary("Neg"), "aten.abs.default": _unary("Abs"),
    "aten.exp.default": _unary("Exp"), "aten.log.default": _unary("Log"),
    "aten.sqrt.default": _unary("Sqrt"), "aten.rsqrt.default": _rsqrt,
    "aten.reciprocal.default": _unary("Reciprocal"),
    "aten.tanh.default": _unary("Tanh"),
    "aten.sigmoid.default": _unary("Sigmoid"),
    "aten.relu.default": _unary("Relu"), "aten.erf.default": _unary("Erf"),
    "aten.gelu.default": _gelu,
    "aten._softmax.default": _softmax("Softmax"),
    "aten._log_softmax.default": _softmax("LogSoftmax"),
    "aten.native_layer_norm.default": _layer_norm,
    "aten.view.default": _reshape, "aten._unsafe_view.default": _reshape,
    "aten.reshape.default": _reshape,
    "aten.permute.default": _permute, "aten.t.default": _t,
    "aten.transpose.int": _transpose,
    "aten.expand.default": _expand,
    "aten.unsqueeze.default": _unsqueeze,
    "aten.squeeze.dim": _squeeze, "aten.squeeze.dims": _squeeze,
    "aten.squeeze.default": _squeeze,
    "aten.select.int": _select, "aten.slice.Tensor": _slice,
    "aten.cat.default": _cat, "aten.embedding.default": _embedding,
    "aten.where.self": _where,
    "aten.masked_fill.Scalar": _masked_fill,
    "aten.masked_fill.Tensor": _masked_fill,
    "aten.eq.Scalar": _compare("Equal"), "aten.eq.Tensor": _compare("Equal"),
    "aten.ne.Scalar": _compare("Equal", True),
    "aten.ne.Tensor": _compare("Equal", True),
    "aten.lt.Scalar": _compare("Less"), "aten.lt.Tensor": _compare("Less"),
    "aten.gt.Scalar": _compare("Greater"),
    "aten.gt.Tensor": _compare("Greater"),
    "aten.le.Scalar": _compare("LessOrEqual"),
    "aten.le.Tensor": _compare("LessOrEqual"),
    "aten.ge.Scalar": _compare("GreaterOrEqual"),
    "aten.ge.Tensor": _compare("GreaterOrEqual"),
    "aten.logical_not.default": _unary("Not"),
    "aten.bitwise_not.default": _unary("Not"),
    "aten.logical_and.default": _binary("And"),
    "aten.bitwise_and.Tensor": _binary("And"),
    "aten.logical_or.default": _binary("Or"),
    "aten.bitwise_or.Tensor": _binary("Or"),
    "aten.amax.default": _reduce_attr("ReduceMax"),
    "aten.mean.dim": _reduce_attr("ReduceMean"),
    "aten.sum.dim_IntList": _sum,
    "aten.convolution.default": _convolution,
    "aten.constant_pad_nd.default": _pad,
    "aten.clamp.default": _clamp,
    "aten.clamp_min.default": lambda cv, n, x, lo: _clamp(cv, n, x, lo),
    "aten.clamp_max.default": lambda cv, n, x, hi: _clamp(cv, n, x, None,
                                                          hi),
}
_HANDLERS.update({k: (lambda cv, n, x, *a, **kw: cv.emit("Identity", [x]))
                  for k in _IDENTITY})
_HANDLERS.update({"aten._to_copy.default": _to_copy,
                  "aten.to.dtype": _to_copy})


def convert_program(ep: torch.export.ExportedProgram, bound: List[str],
                    params: Dict[str, np.ndarray],
                    input_info: List, graph_name: str = "main",
                    opset_version: int = 13) -> bytes:
    """ONNX ModelProto bytes of ``ep`` (decomposed). ``bound`` names the
    program's flattened user inputs: parameter and buffer names (their
    values in ``params``) and the graph inputs of ``input_info``
    (``(name, numpy dtype, shape)``)."""
    cv = Converter()
    cv.params.update(params)
    for name, arr in params.items():
        cv.dtypes[name] = torch.from_numpy(np.empty(0, arr.dtype)).dtype
    inputs = {name for name, _, _ in input_info}
    for name, dtype, _ in input_info:
        cv.dtypes[name] = torch.from_numpy(np.empty(0, dtype)).dtype
    outs = cv.walk(ep, bound)
    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    metas = [n.meta["val"] for n in pytree.tree_leaves(out_node.args[0])]
    outputs = []
    for name, val in zip(outs, metas):
        if name in cv.params or name in cv.consts or name in inputs:
            name = cv.emit("Identity", [name])
        outputs.append(P.value_info(name, _np_dtype(val.dtype),
                                    tuple(val.shape)))
    inputs = [P.value_info(n, d, s) for n, d, s in input_info]
    g = P.graph(cv.nodes, graph_name, inputs, outputs, cv.initializers)
    return P.model(g, opset_version=opset_version)
