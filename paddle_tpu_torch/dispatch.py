"""Eager op dispatch: unwrap -> the op's torch function -> wrap (port of
``paddle_tpu/dispatch.py``).

:func:`call_fn` takes ``Tensor``, ``Parameter`` and plain ``torch.Tensor``
arguments (numpy arrays become tensors beside them) and returns
``Tensor``s. Autograd needs no tape of its own: the op's torch function
records onto torch's graph, and an op the JAX package marks
non-differentiable runs under ``torch.no_grad``. Every output is
canonicalised to the JAX package's x32 dtypes (torch's int64 sums,
indices and counts come back int32), so no eager tensor holds a 64-bit
dtype. The host-side ops' numpy results become ``Tensor``s too, as
JAX's ``_wrap_outputs`` wraps them, on the device of the op's tensor
arguments (the expected place when it has none). Under ``auto_cast``
the ops of the six eager modules cast their floating inputs at
dispatch, as JAX's ``call_fn`` does
(``dispatch.py:117-121``); the port's other modules cast inside through
``amp.amp_cast``. ``FLAGS_check_nan_inf`` and ``FLAGS_benchmark`` act
here (``dispatch.py:162-168``).

:func:`monkey_patch_tensor` gives ``Tensor`` its arithmetic dunders and
every op whose first parameter is a tensor as a method, on the port's
``Tensor`` class alone.
"""

from __future__ import annotations

import contextlib
import inspect
import threading
import time
from typing import Callable, Dict

import numpy as np
import torch

from .core.flags import get_flag
from .core.monitor import GLOBAL_STATS
from .ops.registry import DISPATCH_AMP_MODULES, all_ops, get_op
from .tensor import Tensor

_CANON = {torch.int64: torch.int32, torch.uint64: torch.uint32,
          torch.float64: torch.float32, torch.complex128: torch.complex64}

# -- op-call counter (``dispatch.py:54-87``) ----------------------------------

_OP_COUNTER = threading.local()


class OpCallCounter:
    """Mutable counter handle yielded by :func:`count_op_calls`."""

    __slots__ = ("count",)

    def __init__(self):
        self.count = 0


@contextlib.contextmanager
def count_op_calls():
    """Count dispatch-op calls on this thread for the duration (nested
    scopes shadow, the outer one resumes unchanged)."""
    prev = getattr(_OP_COUNTER, "counter", None)
    c = OpCallCounter()
    _OP_COUNTER.counter = c
    try:
        yield c
    finally:
        _OP_COUNTER.counter = prev


# -- unwrap / wrap ------------------------------------------------------------

def _first_device(obj):
    if isinstance(obj, Tensor):
        return obj.value.device
    if isinstance(obj, torch.Tensor):
        return obj.device
    if isinstance(obj, (list, tuple)):
        for o in obj:
            d = _first_device(o)
            if d is not None:
                return d
    elif isinstance(obj, dict):
        return _first_device(list(obj.values()))
    return None


def _unwrap(obj, device):
    if isinstance(obj, Tensor):
        return obj.value
    if isinstance(obj, np.ndarray):
        from .tensor import to_value
        return to_value(obj, device=device)
    if isinstance(obj, list):
        return [_unwrap(o, device) for o in obj]
    if isinstance(obj, tuple):
        return tuple(_unwrap(o, device) for o in obj)
    if isinstance(obj, dict):
        return {k: _unwrap(v, device) for k, v in obj.items()}
    return obj


def _has_array(obj) -> bool:
    if isinstance(obj, np.ndarray):
        return True
    if isinstance(obj, (list, tuple)):
        return any(_has_array(o) for o in obj)
    if isinstance(obj, dict):
        return any(_has_array(o) for o in obj.values())
    return False


def _wrap(obj, inputs=()):
    """``obj`` with every tensor a ``Tensor`` in the x32 dtypes. A tensor
    that is one of ``inputs`` (an op that returned its argument, as
    ``cast`` to the same dtype does) is wrapped as a view of it, so the
    two ``Tensor``s keep their own ``stop_gradient``."""
    if isinstance(obj, torch.Tensor):
        dt = _CANON.get(obj.dtype)
        if dt is not None:
            obj = obj.to(dt)
        elif any(obj is i for i in inputs):
            obj = obj.view_as(obj)
        return Tensor._wrap(obj)
    if isinstance(obj, list):
        return [_wrap(o, inputs) for o in obj]
    if isinstance(obj, tuple):
        return tuple(_wrap(o, inputs) for o in obj)
    if isinstance(obj, dict):
        return {k: _wrap(v, inputs) for k, v in obj.items()}
    return obj


def _has_host(obj) -> bool:
    if isinstance(obj, (np.ndarray, np.generic)):
        return True
    if isinstance(obj, (list, tuple)):
        return any(_has_host(o) for o in obj)
    return False


def _host_to_device(obj, device):
    """Numpy arrays and scalars in a host op's result as tensors on
    ``device``."""
    if isinstance(obj, (np.ndarray, np.generic)):
        from .tensor import to_value
        return to_value(obj, device=device)
    if isinstance(obj, list):
        return [_host_to_device(o, device) for o in obj]
    if isinstance(obj, tuple):
        return tuple(_host_to_device(o, device) for o in obj)
    return obj


def _tensor_args(args):
    return tuple(a for a in args if isinstance(a, torch.Tensor))


def _amp_cast(obj, target):
    if isinstance(obj, torch.Tensor):
        return obj.to(target) if obj.is_floating_point() and \
            obj.dtype != target else obj
    if isinstance(obj, list):
        return [_amp_cast(o, target) for o in obj]
    if isinstance(obj, tuple):
        return tuple(_amp_cast(o, target) for o in obj)
    return obj


def _leaves(obj):
    if isinstance(obj, Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _leaves(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _leaves(o)


def call_fn(fn: Callable, name: str, differentiable: bool, args, kwargs,
            amp: bool = True):
    """Run op ``name``'s torch function on unwrapped arguments and wrap
    what it returns."""
    c = getattr(_OP_COUNTER, "counter", None)
    if c is not None:
        c.count += 1
    device = None
    if _has_array(args) or _has_array(kwargs):
        device = _first_device((args, kwargs))
        if device is None:
            from .core.place import expected_device
            device = expected_device()
    args = _unwrap(args, device)
    kwargs = _unwrap(kwargs, device)
    if amp:
        from .amp.auto_cast import amp_state, amp_target_dtype
        if amp_state() is not None:
            target = amp_target_dtype(name)
            rec = amp_state().record
            if rec is not None:
                rec.append((name, target))
            if target is not None:
                args = _amp_cast(args, target)
                kwargs = {k: _amp_cast(v, target)
                          for k, v in kwargs.items()}
    bench = get_flag("benchmark")
    t0 = time.perf_counter() if bench else 0.0
    if differentiable:
        raw = fn(*args, **kwargs)
    else:
        with torch.no_grad():
            raw = fn(*args, **kwargs)
    if _has_host(raw):
        dev = device or _first_device((args, kwargs))
        if dev is None:
            from .core.place import expected_device
            dev = expected_device()
        raw = _host_to_device(raw, dev)
    out = _wrap(raw, _tensor_args(args))
    if get_flag("check_nan_inf"):
        _check_nan_inf(out, name)
    if bench:
        for t in _leaves(out):
            if t.value.is_cuda:
                torch.cuda.synchronize(t.value.device)
                break
        GLOBAL_STATS.get(f"op_us/{name}").add(
            int((time.perf_counter() - t0) * 1e6))
    GLOBAL_STATS.get("eager_op_calls").add(1)
    return out


def _check_nan_inf(out, name):
    for t in _leaves(out):
        v = t.value
        if (v.is_floating_point() or v.is_complex()) and \
                not bool(torch.isfinite(v).all()):
            from .core.enforce import EnforceNotMet
            raise EnforceNotMet(f"Operator {name} output contains NaN/Inf "
                                f"(FLAGS_check_nan_inf is on)")


def apply(name: str, *args, **kwargs):
    opdef = get_op(name)
    return call_fn(opdef.fn, name, opdef.differentiable, args, kwargs,
                   opdef.module in DISPATCH_AMP_MODULES)


def wrap_op(name: str) -> Callable:
    opdef = get_op(name)
    fn, diff = opdef.fn, opdef.differentiable
    amp = opdef.module in DISPATCH_AMP_MODULES

    def wrapped(*args, **kwargs):
        return call_fn(fn, name, diff, args, kwargs, amp)

    wrapped.__name__ = name
    wrapped.__qualname__ = name
    wrapped.__doc__ = fn.__doc__
    wrapped.__wrapped__ = fn
    try:
        wrapped.__signature__ = inspect.signature(fn)
    except (TypeError, ValueError):
        pass
    return wrapped


# -- indexing -----------------------------------------------------------------

def _unwrap_index(idx):
    if isinstance(idx, Tensor):
        idx = idx.value
    if isinstance(idx, torch.Tensor):
        return idx if idx.dtype in (torch.bool, torch.uint8) or \
            idx.is_floating_point() else idx.long()
    if isinstance(idx, tuple):
        return tuple(_unwrap_index(i) for i in idx)
    if isinstance(idx, list):
        return [_unwrap_index(i) for i in idx]
    if isinstance(idx, slice):
        return slice(_int_or(idx.start), _int_or(idx.stop),
                     _int_or(idx.step))
    return idx


def _int_or(v):
    if isinstance(v, Tensor):
        return int(v)
    return v


def getitem(t: Tensor, idx):
    idx_raw = _unwrap_index(idx)
    return call_fn(lambda x: x[idx_raw], "getitem", True, (t,), {}, False)


def setitem(t: Tensor, idx, value):
    """A functional update, as ``x.at[idx].set(v)``: the tensor takes a
    new value (recorded on the graph when either side requires grad)
    and its ``inplace_version`` goes up; tensors that shared the old
    value keep it."""
    idx_raw = _unwrap_index(idx)

    def write(x, v):
        out = x.clone()
        out[idx_raw] = v.to(out.dtype) if isinstance(v, torch.Tensor) \
            else v
        return out

    if isinstance(value, Tensor):
        new = call_fn(write, "setitem", True, (t, value), {}, False)
    else:
        if isinstance(value, np.generic):
            value = value.item()
        elif isinstance(value, (np.ndarray, list, tuple)):
            from .tensor import to_value
            value = to_value(value, device=t.value.device)
        new = call_fn(lambda x: write(x, value), "setitem", True, (t,), {},
                      False)
    t._inplace_assign(new)
    return t


# -- public wrapped namespace -------------------------------------------------

wrapped_ops: Dict[str, Callable] = {}


def _build_namespace():
    for name in all_ops():
        wrapped_ops[name] = wrap_op(name)


_build_namespace()


# -- Tensor methods (reference: varbase_patch_methods.py) ---------------------

_BINARY_DUNDERS = {
    "__add__": "add", "__radd__": ("add", True),
    "__sub__": "subtract", "__rsub__": ("subtract", True),
    "__mul__": "multiply", "__rmul__": ("multiply", True),
    "__truediv__": "divide", "__rtruediv__": ("divide", True),
    "__floordiv__": "floor_divide", "__rfloordiv__": ("floor_divide", True),
    "__mod__": "mod", "__rmod__": ("mod", True),
    "__pow__": "pow", "__rpow__": ("pow", True),
    "__matmul__": "matmul", "__rmatmul__": ("matmul", True),
    "__eq__": "equal", "__ne__": "not_equal",
    "__lt__": "less_than", "__le__": "less_equal",
    "__gt__": "greater_than", "__ge__": "greater_equal",
    "__and__": "logical_and", "__or__": "logical_or",
    "__xor__": "logical_xor",
}

_UNARY_DUNDERS = {"__neg__": "neg", "__abs__": "abs",
                  "__invert__": "logical_not"}

METHOD_FIRST_PARAMS = ("x", "input", "logits", "logit")


def _make_binary(opname, reflected=False):
    fn = wrapped_ops[opname]
    if reflected:
        def dunder(self, other):
            return fn(other, self)
    else:
        def dunder(self, other):
            return fn(self, other)
    return dunder


def _method_from(w):
    def method(self, *args, **kwargs):
        return w(self, *args, **kwargs)
    method.__name__ = w.__name__
    method.__doc__ = w.__doc__
    return method


def monkey_patch_tensor():
    for dunder, spec in _BINARY_DUNDERS.items():
        if isinstance(spec, tuple):
            setattr(Tensor, dunder, _make_binary(spec[0], True))
        else:
            setattr(Tensor, dunder, _make_binary(spec))
    for dunder, opname in _UNARY_DUNDERS.items():
        fn = wrapped_ops[opname]
        setattr(Tensor, dunder, lambda self, _f=fn: _f(self))
    # every op whose leading parameter is a tensor, by the JAX package's
    # parameter names (a stub's too, so the method raises as the op does)
    for name, opdef in all_ops().items():
        if hasattr(Tensor, name):
            continue
        if opdef.first_param in METHOD_FIRST_PARAMS:
            setattr(Tensor, name, _method_from(wrapped_ops[name]))


monkey_patch_tensor()
