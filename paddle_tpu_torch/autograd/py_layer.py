"""``PyLayer``: a user-defined forward and backward (port of
``paddle_tpu/autograd/py_layer.py``).

``PyLayer.apply`` runs the user's ``forward(ctx, *args)`` on
``Tensor``s inside a ``torch.autograd.Function``, so torch's graph calls
the user's ``backward(ctx, *grads)`` with ``Tensor`` gradients. The
backward runs with grad recording on when the graph is being
differentiated again (``create_graph=True``), so a backward written with
the port's ops is itself differentiable: double grad through a
``PyLayer`` works as in the JAX package
(``tests/test_double_grad.py:221``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..tensor import Tensor, unwrap


class PyLayerContext:
    """What ``forward`` saves for ``backward``."""

    def __init__(self):
        self._saved: Tuple = ()
        self.extras: dict = {}

    def save_for_backward(self, *tensors) -> None:
        self._saved = tensors

    def saved_tensor(self) -> Tuple:
        return self._saved

    saved_tensors = property(lambda self: self._saved)


class _Function(torch.autograd.Function):
    """One PyLayer call: the inputs are the tensor arguments' values;
    the user's functions see ``Tensor``s. ``ctx`` keeps the ``Tensor``s
    the user saved, which wrap the inputs themselves, so a backward run
    under ``create_graph`` records onto their graph."""

    @staticmethod
    def forward(fctx, cls, ctx, spec, *values):
        args, kwargs = _rebuild(spec, values)
        out = cls.forward(ctx, *args, **kwargs)
        ctx._is_tuple = isinstance(out, (tuple, list))
        outs = list(out) if ctx._is_tuple else [out]
        fctx.pylayer = (cls, ctx, spec, len(values))
        return tuple(unwrap(o) if isinstance(o, (Tensor, torch.Tensor))
                     else torch.as_tensor(o) for o in outs)

    @staticmethod
    def backward(fctx, *grads):
        cls, ctx, spec, n_in = fctx.pylayer
        res = cls.backward(ctx, *[Tensor._wrap(g) for g in grads])
        if not isinstance(res, (tuple, list)):
            res = (res,)
        res = [unwrap(r) for r in res]
        # one gradient a tensor input, or one a positional input
        if len(res) > n_in:
            res = [r for r, k in zip(res, spec[0]) if k == "T"]
        res = list(res) + [None] * (n_in - len(res))
        return (None, None, None, *res[:n_in])


def _flatten(args, kwargs):
    kinds, rest, values = [], [], []
    for a in args:
        if isinstance(a, (Tensor, torch.Tensor)):
            kinds.append("T")
            values.append(unwrap(a))
            rest.append(None)
        else:
            kinds.append("O")
            rest.append(a)
    return (kinds, rest, dict(kwargs)), values


def _rebuild(spec, values):
    kinds, rest, kwargs = spec
    it = iter(values)
    args = [Tensor._wrap(next(it)) if k == "T" else r
            for k, r in zip(kinds, rest)]
    return args, kwargs


class PyLayer:
    """Subclass with ``@staticmethod forward(ctx, *args)`` and
    ``backward(ctx, *grads)``; call ``.apply(*args)``. ``backward``
    returns one gradient a tensor input (None for one that takes
    none)."""

    @staticmethod
    def forward(ctx: PyLayerContext, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx: PyLayerContext, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        spec, values = _flatten(args, kwargs)
        if not (torch.is_grad_enabled() and any(
                v.requires_grad for v in values)):
            args_t, kw = _rebuild(spec, values)
            return _wrap_out(cls.forward(ctx, *args_t, **kw))
        outs = [Tensor._wrap(o)
                for o in _Function.apply(cls, ctx, spec, *values)]
        return tuple(outs) if ctx._is_tuple else outs[0]


def _wrap_out(out):
    if isinstance(out, (tuple, list)):
        return tuple(_wrap_one(o) for o in out)
    return _wrap_one(out)


def _wrap_one(o):
    if isinstance(o, Tensor):
        return o
    if isinstance(o, torch.Tensor):
        return Tensor._wrap(o)
    return Tensor(o)
