"""Run-time dispatch helpers for dy2static-converted code (port of
``paddle_tpu/jit/convert_ops.py``).

The AST transformer (``jit/dy2static.py``) rewrites Python control flow
into calls to these helpers. A concrete condition (a Python value, or a
tensor outside a trace) keeps ordinary Python semantics, so converted
code runs eagerly as written. While ``torch.export`` (or
``torch.compile``) traces, a tensor condition lowers to ``torch.cond``
and a tensor loop condition to ``torch._higher_order_ops.while_loop``,
so a tensor-dependent ``if`` / ``while`` survives into the exported
program, as it survives ``jax.jit`` through ``lax.cond`` /
``lax.while_loop`` in the JAX package. A condition of more than one
element raises, as in JAX.

Under a trace the branch outputs are cloned (a higher-order op's output
may not alias its inputs) and Python numbers among them become tensors,
as JAX makes them arrays.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


class _Undefined:
    """Sentinel for names that may be unbound on one control path
    (``dygraph_to_static/utils.py`` ``UndefinedVar``)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "<pt undefined>"

    def __bool__(self):
        raise NameError(
            "variable is undefined on this control path (dy2static)")


UNDEF = _Undefined()


def _tracing() -> bool:
    return torch.compiler.is_exporting() or torch.compiler.is_compiling()


def _is_traced(x) -> bool:
    """A tensor seen while a program is being traced: its value is not
    known, so control flow on it must lower."""
    return isinstance(x, torch.Tensor) and _tracing()


def _to_pred(cond):
    if isinstance(cond, torch.Tensor):
        if cond.numel() != 1:
            raise ValueError(
                "dy2static: the truth value of a condition with shape "
                f"{tuple(cond.shape)} is ambiguous; reduce it with "
                ".all()/.any() first")
        cond = cond.reshape(())
        return cond if cond.dtype == torch.bool else cond != 0
    return cond


def _as_tensor(v, like=None):
    """A branch or carry value as a tensor: a Python number becomes a
    0-d tensor on ``like``'s device (through ``torch.full``, an op,
    since a tensor constant inside a traced branch does not serialise)."""
    if isinstance(v, torch.Tensor):
        return v
    dev = like.device if isinstance(like, torch.Tensor) else None
    dtype = (torch.bool if isinstance(v, bool) else
             torch.int64 if isinstance(v, int) else
             torch.get_default_dtype())
    return torch.full((), v, dtype=dtype, device=dev)


def _unify_one(a, b):
    """Unify one output pair across branches: UNDEF on one side is
    filled with zeros like the other (observable only if code reads a
    name never assigned on the taken path, which Python would reject)."""
    a_undef, b_undef = a is UNDEF, b is UNDEF
    if a_undef and b_undef:
        return UNDEF, UNDEF, True
    if a_undef:
        if isinstance(b, torch.Tensor):
            return torch.zeros_like(b), b, False
        return b, b, False
    if b_undef:
        if isinstance(a, torch.Tensor):
            return a, torch.zeros_like(a), False
        return a, a, False
    return a, b, False


def convert_ifelse(pred, true_fn: Callable[[], Tuple],
                   false_fn: Callable[[], Tuple]):
    """``if pred: ... else: ...`` with branch bodies extracted into
    functions returning the tuple of assigned names."""
    pred = _to_pred(pred)
    if not _is_traced(pred):
        return true_fn() if bool(pred) else false_fn()

    # traced: probe both branches once to learn the output structure;
    # the probes reach no output, so they leave nothing in the graph
    outs_t = true_fn()
    outs_f = false_fn()
    if len(outs_t) != len(outs_f):
        raise TypeError(
            "dy2static: if/else branches produced different numbers of "
            f"outputs ({len(outs_t)} vs {len(outs_f)})")

    def is_static(a, b):
        return (a is UNDEF and b is UNDEF) or (a is None and b is None)

    static_mask = [is_static(a, b) for a, b in zip(outs_t, outs_f)]
    static_vals = [a for a, s in zip(outs_t, static_mask) if s]

    def wrap(fn, other):
        def branch(_pred):
            res = []
            for v, o, s in zip(fn(), other, static_mask):
                if s:
                    continue
                if v is UNDEF:
                    o = _as_tensor(o, pred)
                    v = torch.zeros_like(o)
                res.append(_as_tensor(v, pred).clone())
            return tuple(res)
        return branch

    # the predicate rides along as the one operand: the branches close
    # over everything else
    picked = torch.cond(pred, wrap(true_fn, outs_f), wrap(false_fn, outs_t),
                        (pred,))
    it_dyn = iter(picked)
    it_static = iter(static_vals)
    return tuple(next(it_static) if s else next(it_dyn)
                 for s in static_mask)


def convert_while(cond_fn: Callable, body_fn: Callable,
                  init_vars: Tuple):
    """``while cond: body`` with loop-carried names passed explicitly. A
    concrete condition runs as a Python loop; once the condition is a
    traced tensor (possibly mid-loop, e.g. a break flag turning into
    one), the remaining iterations lower to ``while_loop`` from the
    current state."""
    vars_ = tuple(init_vars)
    while True:
        c = _to_pred(cond_fn(*vars_))
        if _is_traced(c):
            return _traced_while(cond_fn, body_fn, vars_, c)
        if not bool(c):
            return vars_
        vars_ = tuple(body_fn(*vars_))


def _traced_while(cond_fn, body_fn, init_vars, pred):
    from torch._higher_order_ops.while_loop import while_loop

    # run the body once to learn the output structure and fill UNDEF
    # slots in the carry; the probe reaches no output
    probe = tuple(body_fn(*init_vars))
    init = []
    for a, b in zip(init_vars, probe):
        ua, ub, is_static = _unify_one(a, b)
        if is_static:
            init.append(UNDEF)
        else:
            # the carry takes the dtype the body gives it
            ref = _as_tensor(ub, pred)
            init.append(_as_tensor(ua, pred).to(ref.dtype).clone())
    static_mask = [v is UNDEF for v in init]

    def pack(full):
        return tuple(v for v, s in zip(full, static_mask) if not s)

    def unpack(dyn):
        it = iter(dyn)
        return tuple(UNDEF if s else next(it) for s in static_mask)

    dyn_init = pack(init)

    def cond_w(*carry):
        return _to_pred(_as_tensor(cond_fn(*unpack(carry)), pred))

    def body_w(*carry):
        out = pack(body_fn(*unpack(carry)))
        return tuple(_as_tensor(v, pred).to(c.dtype).clone()
                     for v, c in zip(out, dyn_init))

    return unpack(while_loop(cond_w, body_w, dyn_init))


def convert_logical_and(lhs_fn: Callable, rhs_fn: Callable):
    """``a and b``, short-circuiting on a concrete lhs."""
    lhs = lhs_fn()
    if _is_traced(lhs):
        return torch.logical_and(_to_pred(lhs), _to_pred(
            _as_tensor(rhs_fn(), lhs)))
    return lhs and rhs_fn()


def convert_logical_or(lhs_fn: Callable, rhs_fn: Callable):
    lhs = lhs_fn()
    if _is_traced(lhs):
        return torch.logical_or(_to_pred(lhs), _to_pred(
            _as_tensor(rhs_fn(), lhs)))
    return lhs or rhs_fn()


def convert_logical_not(x):
    if _is_traced(x):
        return torch.logical_not(_to_pred(x))
    return not x


def convert_assert(test, msg_fn=None):
    """Traced assertions are skipped (a program has no host assert);
    concrete ones keep Python semantics, the message evaluated only on
    failure."""
    if _is_traced(test):
        return
    if not test:
        raise AssertionError(msg_fn() if msg_fn is not None else "")


def finalize_ret(v):
    """A function that falls off the end without returning yields None."""
    return None if v is UNDEF else v


def range_continue(i, stop, step):
    """Continuation predicate of a lowered ``for i in range(...)``."""
    if any(_is_traced(v) for v in (i, stop, step)):
        like = next(v for v in (i, stop, step) if isinstance(v, torch.Tensor))
        i, stop, step = (_as_tensor(v, like) for v in (i, stop, step))
        return torch.where(step > 0, i < stop, i > stop)
    return i < stop if step > 0 else i > stop
