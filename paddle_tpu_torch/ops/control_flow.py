"""Control flow and ``TensorArray`` (port of
``paddle_tpu/ops/control_flow.py``).

Eager calls keep Python semantics: ``cond`` calls one branch,
``while_loop`` / ``fori_loop`` / ``scan`` loop in Python, ``case`` /
``switch_case`` pick their branch from the concrete predicate or index.
While ``torch.export`` (or ``torch.compile``) traces, a tensor predicate
or a tensor loop condition lowers through the dy2static helpers of
``jit/convert_ops.py`` (``torch.cond`` and ``while_loop``), so it lowers
once, in one place; ``case`` and ``switch_case`` nest ``cond``s. The
functions take ``Tensor``s or plain tensors: what the caller passes is
what the branch and loop functions see, and their outputs come back as
they returned them (``Tensor``s when a ``Tensor`` went in, as in JAX).

``TensorArray`` has JAX's two modes (``control_flow.py:130-195``): a
Python list in eager mode, and with ``capacity`` a fixed-capacity
stacked buffer plus a length tensor, whose writes are out-of-place index
updates that stay inside a traced program.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch
from torch.utils import _pytree as pytree

from ..jit.convert_ops import (_is_traced, _to_pred, _tracing,
                               convert_ifelse, convert_while)
from ..tensor import Tensor, unwrap


def _unwrap(tree):
    return pytree.tree_map(unwrap, tree)


def _has_tensor(tree) -> bool:
    return any(isinstance(t, Tensor) for t in pytree.tree_leaves(tree))


def _wrap(tree, eager: bool):
    if not eager:
        return tree
    return pytree.tree_map(
        lambda v: Tensor._wrap(v) if isinstance(v, torch.Tensor) else v,
        tree)


def _raw_pred(pred):
    return _to_pred(unwrap(pred))


def _flat_branch(fn):
    """A branch for ``convert_ifelse``: its outputs as a flat tuple of
    plain values (no side effect: a ``torch.cond`` branch may not
    mutate anything outside it)."""
    return lambda: tuple(pytree.tree_leaves(_unwrap(fn())))


def _lowered_cond(pred, true_fn, false_fn):
    """``convert_ifelse`` on tree-valued branches (no operands: the
    branches close over them). The tree structure comes from one probe
    of ``true_fn``, which reaches no output."""
    spec = pytree.tree_flatten(_unwrap(true_fn()))[1]
    out = convert_ifelse(pred, _flat_branch(true_fn),
                         _flat_branch(false_fn))
    return pytree.tree_unflatten(list(out), spec)


def cond(pred, true_fn: Callable, false_fn: Callable, *operands):
    """``true_fn(*operands)`` if ``pred`` else ``false_fn(*operands)``."""
    raw = _raw_pred(pred)
    if not _is_traced(raw):
        return (true_fn if bool(raw) else false_fn)(*operands)
    eager = _has_tensor((pred, operands))
    out = _lowered_cond(raw, lambda: true_fn(*operands),
                        lambda: false_fn(*operands))
    return _wrap(out, eager)


def while_loop(cond_fn: Callable, body_fn: Callable, loop_vars):
    """``while cond_fn(*vars): vars = body_fn(*vars)``; returns the final
    ``loop_vars`` in their container (a tuple or a list)."""
    eager = _has_tensor(loop_vars)
    init = tuple(_unwrap(list(loop_vars)))

    def c(*vs):
        return unwrap(cond_fn(*_wrap(list(vs), eager)))

    def b(*vs):
        return tuple(_unwrap(list(body_fn(*_wrap(list(vs), eager)))))

    kind = tuple if isinstance(loop_vars, tuple) else list
    return _wrap(kind(convert_while(c, b, init)), eager)


def fori_loop(lower, upper, body_fn: Callable, init):
    """``for i in range(lower, upper): init = body_fn(i, init)``. Bounds
    that are tensors under a trace lower to ``while_loop``; otherwise the
    loop runs in Python with ``i`` a Python int."""
    lo, hi = unwrap(lower), unwrap(upper)
    if not (_is_traced(lo) or _is_traced(hi)):
        vals = init
        for i in range(int(lo), int(hi)):
            vals = body_fn(i, vals)
        return vals
    eager = _has_tensor(init)
    leaves, spec = pytree.tree_flatten(_unwrap(init))
    i0 = lo if isinstance(lo, torch.Tensor) else torch.full(
        (), int(lo), dtype=torch.int64, device=hi.device)

    def c(i, *vs):
        return i < hi

    def b(i, *vs):
        state = _wrap(pytree.tree_unflatten(list(vs), spec), eager)
        out = pytree.tree_leaves(_unwrap(body_fn(i, state)))
        return (i + 1,) + tuple(out)

    out = convert_while(c, b, (i0,) + tuple(leaves))
    return _wrap(pytree.tree_unflatten(list(out[1:]), spec), eager)


def scan(f: Callable, init, xs, length=None, reverse=False):
    """``carry, y = f(carry, x)`` over the leading dim of ``xs`` (a tree of
    tensors, or None with ``length``); returns ``(carry, ys)`` with the
    ``y``s stacked in the order of ``xs`` (also when ``reverse``)."""
    x_leaves, x_spec = pytree.tree_flatten(xs)
    n = int(length) if length is not None else int(x_leaves[0].shape[0])
    order = range(n - 1, -1, -1) if reverse else range(n)
    carry, ys = init, [None] * n
    for i in order:
        x = None if xs is None else pytree.tree_unflatten(
            [leaf[i] for leaf in x_leaves], x_spec)
        carry, ys[i] = f(carry, x)
    if n == 0 or ys[0] is None:
        return carry, None
    eager = _has_tensor(ys[0])
    y_specs = [pytree.tree_flatten(_unwrap(y)) for y in ys]
    stacked = [torch.stack([leaves[k] for leaves, _ in y_specs])
               for k in range(len(y_specs[0][0]))]
    return carry, _wrap(pytree.tree_unflatten(stacked, y_specs[0][1]), eager)


def _select_chain(preds, fns, default):
    """The first ``fns[i]`` whose ``preds[i]`` holds, else ``default``, as
    nested ``cond``s (traced predicates) or a Python scan."""
    if not any(_is_traced(p) for p in preds):
        for p, fn in zip(preds, fns):
            if bool(p):
                return fn()
        return default()
    out = default
    for p, fn in reversed(list(zip(preds, fns))):
        if not _is_traced(p):
            # a concrete predicate among traced ones decides statically
            out = fn if bool(p) else out
            continue
        out = (lambda p=p, fn=fn, rest=out:
               _lowered_cond(_to_pred(p), fn, rest))
    return out()


def case(pred_fn_pairs: Sequence, default: Callable = None):
    """The first pair whose predicate holds; none: ``default``, else the
    last pair's function (JAX's rule)."""
    preds = [_raw_pred(p) for p, _ in pred_fn_pairs]
    fns = [f for _, f in pred_fn_pairs]
    if default is None:
        default = fns[-1]
    eager = _has_tensor([p for p, _ in pred_fn_pairs])
    out = _select_chain(preds, fns, default)
    return _wrap(out, eager) if any(_is_traced(p) for p in preds) else out


def switch_case(branch_index, branch_fns, default: Callable = None):
    """``branch_fns[branch_index]``: a list indexed from 0, or a dict by
    key; an index outside it takes ``default``, else the last
    function."""
    idx = unwrap(branch_index)
    if isinstance(branch_fns, dict):
        keys = sorted(branch_fns)
        fns = [branch_fns[k] for k in keys]
    else:
        fns = list(branch_fns)
        keys = list(range(len(fns)))
    if default is None:
        default = fns[-1]
    if not _is_traced(idx):
        i = int(idx.reshape(()) if isinstance(idx, torch.Tensor) else idx)
        return fns[keys.index(i)]() if i in keys else default()
    flat = idx.reshape(())
    preds = [flat == k for k in keys]
    return _wrap(_select_chain(preds, fns, default),
                 isinstance(branch_index, Tensor))


# -- TensorArray ---------------------------------------------------------------

class TensorArray:
    """A list of ``Tensor``s in eager mode; with ``capacity`` (and an
    ``example`` element for the shape and dtype) a stacked buffer
    ``[capacity, ...]`` and an int32 length, for traced programs."""

    def __init__(self, items=None, capacity: int = 0, example=None):
        self._items: List[Any] = list(items) if items else []
        self._buf = None
        self._len = None
        if capacity:
            if example is None:
                raise ValueError(
                    "traced TensorArray needs an example element for "
                    "shape/dtype (static shapes under a trace)")
            ex = torch.as_tensor(unwrap(example))
            self._buf = torch.zeros((capacity,) + tuple(ex.shape),
                                    dtype=ex.dtype, device=ex.device)
            self._len = torch.zeros((), dtype=torch.int32, device=ex.device)

    @classmethod
    def _traced(cls, buf, length) -> "TensorArray":
        ta = cls.__new__(cls)
        ta._items, ta._buf, ta._len = [], buf, length
        return ta

    @property
    def traced(self) -> bool:
        return self._buf is not None

    def __len__(self):
        if self.traced:
            return int(self._len)
        return len(self._items)


def create_array(dtype="float32", initialized_list=None) -> TensorArray:
    return TensorArray(initialized_list)


def array_write(x, i, array: TensorArray = None) -> TensorArray:
    """Write ``x`` at index ``i``: the eager list grows as needed; a
    traced array returns a new array whose buffer has row ``i``
    replaced."""
    if array is None:
        array = TensorArray()
    raw = unwrap(x)
    if array.traced:
        buf = array._buf
        idx = torch.as_tensor(unwrap(i), device=buf.device).reshape(
            1).long()
        new = buf.index_copy(0, idx, torch.as_tensor(raw).to(
            buf.dtype)[None])
        length = torch.maximum(array._len, (idx[0] + 1).to(torch.int32))
        return TensorArray._traced(new, length)
    k = int(unwrap(i))
    while len(array._items) <= k:
        array._items.append(None)
    array._items[k] = Tensor._wrap(torch.as_tensor(raw))
    return array


def array_read(array: TensorArray, i):
    if array.traced:
        idx = torch.as_tensor(unwrap(i), device=array._buf.device)
        return Tensor._wrap(array._buf.index_select(
            0, idx.reshape(1).long())[0])
    return array._items[int(unwrap(i))]


def array_length(array: TensorArray):
    if array.traced:
        return Tensor._wrap(array._len)
    from ._eager import device_of
    dev = next((t.value.device for t in array._items
                if isinstance(t, Tensor)), None) or device_of()
    return Tensor._wrap(torch.tensor(len(array._items), dtype=torch.int32,
                                     device=dev))


def tensor_array_to_tensor(array: TensorArray, axis: int = 0,
                           use_stack: bool = False):
    """The written elements concatenated (or stacked) along ``axis``, and
    each element's size along it (int32). A traced array gives its whole
    buffer and its length."""
    if array.traced:
        if use_stack:
            out = torch.movedim(array._buf, 0, axis)
        elif axis == 0:
            out = array._buf.reshape((-1,) + tuple(array._buf.shape[2:]))
        else:
            raise NotImplementedError(
                "traced tensor_array_to_tensor supports axis=0 concat")
        return Tensor._wrap(out), Tensor._wrap(array._len)
    gaps = [i for i, t in enumerate(array._items) if t is None]
    if gaps:
        raise ValueError(
            f"tensor_array_to_tensor: uninitialized slots {gaps} "
            "(array_write skipped those indices)")
    vals = [unwrap(t) for t in array._items]
    sizes = torch.tensor([v.shape[axis] if not use_stack else 1
                          for v in vals], dtype=torch.int32,
                         device=vals[0].device)
    out = torch.stack(vals, dim=axis) if use_stack else \
        torch.cat(vals, dim=axis)
    return Tensor._wrap(out), Tensor._wrap(sizes)


def array_to_lod_tensor(array: TensorArray, table=None):
    """The array collapsed into one host ``RaggedTensor``."""
    from ..framework.ragged import RaggedTensor
    if array.traced:
        items = [array._buf[i] for i in range(int(array._len))]
    else:
        gaps = [i for i, t in enumerate(array._items) if t is None]
        if gaps:
            raise ValueError(
                f"array_to_lod_tensor: uninitialized slots {gaps}")
        items = array._items
    return RaggedTensor.from_rows([unwrap(t) for t in items])


def lod_tensor_to_array(x, table=None) -> TensorArray:
    """A ragged batch (or a tensor's rows) as a ``TensorArray``, one row
    group an entry; a host ``RaggedTensor``'s rows go to the expected
    place."""
    from ..framework.ragged import RaggedTensor
    if isinstance(x, RaggedTensor):
        from ._eager import tensor
        return TensorArray([Tensor._wrap(tensor(r)) for r in x.rows()])
    raw = unwrap(x)
    return TensorArray([Tensor._wrap(raw[i]) for i in range(raw.shape[0])])


def Assert(cond, data=None, summarize=20):  # noqa: N802 - reference name
    """Raise ``AssertionError`` on a false condition; under a trace the
    check is skipped (a program has no host assert), as in JAX."""
    raw = unwrap(cond)
    if isinstance(raw, torch.Tensor) and _tracing():
        return None
    if not bool(torch.as_tensor(raw).all()):
        shown = []
        for d in (data or []):
            shown.append(torch.as_tensor(unwrap(d)).reshape(-1)[:summarize]
                         .tolist())
        raise AssertionError(f"Assert failed; data={shown}")
    return None
