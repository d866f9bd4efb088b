"""Shared harness of the eager-API parity tests (``test_torch_ops_*.py``,
``test_torch_autograd.py``): one op called through both packages' public
wrappers on the same seeded numpy inputs, values and dtypes compared,
and the gradient of ``sum(out * w)`` from each package's autograd (the
JAX package's tape, the port's torch graph) compared too.

Inputs are numpy arrays (made ``Tensor``s on each side; those at
``grad`` indices require grad), lists of arrays (lists of ``Tensor``s)
or plain Python values (passed as they are).
"""

import numpy as np

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu import dispatch as jdispatch
from paddle_tpu_torch import dispatch as tdispatch
from paddle_tpu_torch.core import place
from paddle_tpu_torch.core.dtype import dtype_name
from paddle_tpu_torch.tools.eager_sweep import rng_for

def on_cpu():
    """Run the port's eager API on the CPU for a test module (restored
    after: the default place stays the card)."""
    place.set_device("cpu")
    try:
        yield
    finally:
        place.reset_device()


def _jax_arg(a, req):
    if isinstance(a, np.ndarray):
        return pt.to_tensor(a, stop_gradient=not req)
    if isinstance(a, list) and a and all(isinstance(b, np.ndarray)
                                         for b in a):
        return [pt.to_tensor(b, stop_gradient=not req) for b in a]
    return a


def _port_arg(a, req):
    if isinstance(a, np.ndarray):
        return paddle.to_tensor(a, stop_gradient=not req)
    if isinstance(a, list) and a and all(isinstance(b, np.ndarray)
                                         for b in a):
        return [paddle.to_tensor(b, stop_gradient=not req) for b in a]
    return a


def _leaves(out):
    if isinstance(out, (list, tuple)):
        res = []
        for o in out:
            res.extend(_leaves(o))
        return res
    return [out]


def _host(t):
    """(numpy value, dtype name) of an output of either package."""
    if isinstance(t, pt.Tensor):
        return np.asarray(t.numpy()), str(np.dtype(t.dtype))
    if isinstance(t, paddle.Tensor):
        return t.numpy(), dtype_name(t.dtype)
    return t, type(t).__name__


def _grad_leaves(args, grad):
    out = []
    for i in grad:
        a = args[i]
        out.extend(a if isinstance(a, list) else [a])
    return out


def _weights(vals, seed_name):
    r = rng_for(seed_name + "/w")
    return [r.standard_normal(np.shape(v)).astype(np.float32)
            if np.ndim(v) else np.float32(r.standard_normal())
            for v in vals]


def _float_out(v, dt) -> bool:
    return dt in ("float32", "float16", "bfloat16")


def run_both(name, args, kwargs=None, grad=(), jname=None):
    """Call op ``name`` in both packages; returns ((jax outs, port outs),
    (jax grads, port grads)), outputs as ``(value, dtype)`` pairs."""
    kwargs = kwargs or {}
    jfn = jdispatch.wrapped_ops[jname or name]
    tfn = tdispatch.wrapped_ops[name]
    jargs = [_jax_arg(a, i in grad) for i, a in enumerate(args)]
    targs = [_port_arg(a, i in grad) for i, a in enumerate(args)]
    jout = _leaves(jfn(*jargs, **kwargs))
    tout = _leaves(tfn(*targs, **kwargs))
    jv = [_host(o) for o in jout]
    tv = [_host(o) for o in tout]
    grads = ([], [])
    if grad:
        keep = [k for k, (v, dt) in enumerate(jv) if _float_out(v, dt)]
        ws = _weights([jv[k][0] for k in keep], name)
        jl = sum((jout[k] * pt.to_tensor(w)).sum()
                 for k, w in zip(keep, ws))
        tl = sum((tout[k] * paddle.to_tensor(w)).sum()
                 for k, w in zip(keep, ws))
        jl.backward()
        tl.backward()
        for j, t in zip(_grad_leaves(jargs, grad), _grad_leaves(targs, grad)):
            grads[0].append(None if j.grad is None else
                            np.asarray(j.grad.numpy()))
            grads[1].append(None if t.grad is None else t.grad.numpy())
    return (jv, tv), grads


def assert_parity(name, args, kwargs=None, grad=(), rtol=1e-5, atol=1e-6,
                  grad_rtol=None, grad_atol=None, jname=None, exact=False):
    """Values and dtypes equal (bitwise with ``exact``, else within
    ``rtol`` / ``atol``), and the gradients within ``grad_rtol`` /
    ``grad_atol`` (default: the value tolerances x 10)."""
    (jv, tv), (jg, tg) = run_both(name, args, kwargs, grad, jname)
    assert len(jv) == len(tv), (name, len(jv), len(tv))
    for k, ((a, adt), (b, bdt)) in enumerate(zip(jv, tv)):
        assert adt == bdt, f"{name} output {k}: dtype {bdt} != JAX {adt}"
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert np.shape(a) == np.shape(b), (name, k, np.shape(a),
                                                np.shape(b))
            if exact or not np.issubdtype(np.asarray(a).dtype, np.inexact):
                np.testing.assert_array_equal(b, a, err_msg=f"{name}[{k}]")
            else:
                np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                           equal_nan=True,
                                           err_msg=f"{name}[{k}]")
        else:
            assert a == b, (name, k, a, b)
    gr = grad_rtol if grad_rtol is not None else rtol * 10
    ga = grad_atol if grad_atol is not None else atol * 10
    for k, (a, b) in enumerate(zip(jg, tg)):
        if a is None:
            assert b is None or not np.any(b), (name, "grad", k)
            continue
        assert b is not None, f"{name}: no port gradient for input {k}"
        np.testing.assert_allclose(b, a, rtol=gr, atol=ga,
                                   err_msg=f"{name} grad[{k}]")


def registry_names(module):
    """(JAX names, port names) of one op module."""
    from paddle_tpu.ops.registry import all_ops as jall
    from paddle_tpu_torch.ops.registry import all_ops as tall
    return (sorted(n for n, o in jall().items() if o.module == module),
            sorted(n for n, o in tall().items() if o.module == module))


def covered(cases):
    return {c[0] for c in cases}
