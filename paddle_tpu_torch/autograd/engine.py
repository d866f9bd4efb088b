"""Eager autograd (port of ``paddle_tpu/autograd/engine.py``).

The JAX package keeps its own tape of ``GradNode`` pullbacks. The port
has none: every ``Tensor`` holds a ``torch.Tensor``, and autograd is
torch's graph on those values. :func:`backward` is
``torch.autograd.backward`` and :func:`grad` is ``torch.autograd.grad``,
with the JAX package's argument handling (``grad_tensors`` /
``grad_outputs`` as Tensors, ``allow_unused``, ``no_grad_vars``, a
``create_graph`` that builds the double-grad graph even inside
``no_grad``).

The grad mode is torch's, which is thread-local as the JAX package's is
(the engine runs on its own thread). :class:`no_grad` works as a context
manager, as a decorator with or without parentheses, and around
generator functions.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import threading
from typing import Any, List

import torch


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool):
    """Set the thread's grad mode; the returned object also works as a
    context manager that restores the previous mode."""
    return torch.set_grad_enabled(bool(mode))


class no_grad:  # noqa: N801 - reference API name
    """Disable grad recording: a context manager or a decorator
    (``@no_grad`` or ``@no_grad()``), which holds the guard across a
    generator's iteration too. The saved modes live in a per-thread
    stack on the instance, so one instance nests and is shared across
    threads."""

    def __new__(cls, func=None):
        if func is not None:
            return _decorate(func)
        return super().__new__(cls)

    def __init__(self, func=None):
        self._tls = threading.local()

    def _stack(self) -> List[bool]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def __call__(self, *args, **kwargs):
        if len(args) == 1 and not kwargs and callable(args[0]):
            return _decorate(args[0])
        raise TypeError("no_grad() context instance is not callable")

    def __enter__(self):
        self._stack().append(torch.is_grad_enabled())
        torch.set_grad_enabled(False)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._stack().pop())
        return False


def _decorate(func):
    if inspect.isgeneratorfunction(func):
        @functools.wraps(func)
        def gen_wrapper(*args, **kwargs):
            gen = func(*args, **kwargs)
            try:
                with no_grad():
                    item = next(gen)
                while True:
                    try:
                        sent = yield item
                    except GeneratorExit:
                        with no_grad():
                            gen.close()
                        raise
                    except BaseException as exc:
                        with no_grad():
                            item = gen.throw(exc)
                    else:
                        with no_grad():
                            item = gen.send(sent)
            except StopIteration as stop:
                return stop.value
        return gen_wrapper

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with no_grad():
            return func(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def enable_grad():
    with torch.enable_grad():
        yield


def _values(tensors) -> List[torch.Tensor]:
    from ..tensor import Tensor
    if isinstance(tensors, (Tensor, torch.Tensor)):
        tensors = [tensors]
    return [t.value if isinstance(t, Tensor) else t for t in tensors]


def _seeds(grad_tensors, outs, keep_graph: bool):
    from ..tensor import Tensor, to_value
    if grad_tensors is None:
        grad_tensors = [None] * len(outs)
    elif isinstance(grad_tensors, (Tensor, torch.Tensor)) or not \
            isinstance(grad_tensors, (list, tuple)):
        grad_tensors = [grad_tensors]
    seeds = []
    for o, g in zip(outs, grad_tensors):
        if g is None:
            seeds.append(torch.ones_like(o))
            continue
        if isinstance(g, Tensor):
            g = g.value
        elif not isinstance(g, torch.Tensor):
            g = to_value(g, dtype=o.dtype, device=o.device)
        seeds.append(g if keep_graph else g.detach())
    return seeds


def backward(tensors, grad_tensors=None, retain_graph: bool = False,
             create_graph: bool = False) -> None:
    """Accumulate gradients of ``tensors`` into the leaves' ``.grad``;
    an output without ``grad_tensors`` is seeded with ones, as
    ``Tensor.backward()`` is for any shape in the reference."""
    outs = _values(tensors)
    seeds = _seeds(grad_tensors, outs, create_graph)
    pairs = [(o, g) for o, g in zip(outs, seeds) if o.requires_grad]
    if not pairs:
        return
    mode = torch.enable_grad() if create_graph else contextlib.nullcontext()
    with mode:
        torch.autograd.backward([o for o, _ in pairs],
                                [g for _, g in pairs],
                                retain_graph=retain_graph or None,
                                create_graph=create_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """Gradients of ``outputs`` with respect to ``inputs``, leaving every
    ``.grad`` alone (reference: ``paddle.grad``). With
    ``create_graph=True`` the results are themselves differentiable. An
    input the outputs do not depend on, or one listed in
    ``no_grad_vars``, raises unless ``allow_unused`` (then None)."""
    from ..tensor import Tensor
    if not only_inputs:
        raise NotImplementedError(
            "only_inputs=False is not supported (the reference dygraph "
            "engine rejects it too)")
    if retain_graph is None:
        retain_graph = create_graph
    single = isinstance(inputs, (Tensor, torch.Tensor))
    ins = _values(inputs)
    skip = set()
    if no_grad_vars is not None:
        skip = {id(v) for v in _values(no_grad_vars)}
    outs = _values(outputs)
    seeds = _seeds(grad_outputs, outs, create_graph)
    pairs = [(o, g) for o, g in zip(outs, seeds) if o.requires_grad]
    if not pairs:
        raise RuntimeError("grad: no output requires grad (its graph was "
                           "not recorded)")
    want = [i for i, v in enumerate(ins)
            if v.requires_grad and id(v) not in skip]
    got: List[Any] = [None] * len(ins)
    if want:
        mode = torch.enable_grad() if create_graph else \
            contextlib.nullcontext()
        with mode:
            res = torch.autograd.grad(
                [o for o, _ in pairs], [ins[i] for i in want],
                [g for _, g in pairs], retain_graph=retain_graph,
                create_graph=create_graph, allow_unused=True)
        for i, r in zip(want, res):
            got[i] = r
    results = []
    for v, r in zip(ins, got):
        if r is None:
            if not allow_unused:
                raise RuntimeError(
                    f"grad: an input tensor of shape {tuple(v.shape)} was "
                    f"not used in the graph")
            results.append(None)
        else:
            results.append(Tensor._wrap(r))
    return results[0] if single else results
