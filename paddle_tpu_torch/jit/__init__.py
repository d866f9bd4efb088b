"""Train and eval steps, ``to_static`` and ``save`` / ``load`` (port of
``paddle_tpu/jit/__init__.py``).

The JAX ``TrainStep`` traces forward, ``value_and_grad`` and the
optimizer update into one jitted program and ``multi_step`` scans it over
stacked batches. The port runs the same step eagerly: forward, autograd
backward (through the attention kernels' backward kernels on the card)
and the optimizer's in-place update, with nothing read back to the host,
so the CUDA launches of consecutive steps queue up behind each other.
Capturing a step in a CUDA graph is later work (ROADMAP.md).

``to_static`` rewrites a function's (or a Layer's ``forward``'s)
tensor-dependent Python control flow with ``jit/dy2static.py``: the
converted code runs eagerly as written, and ``torch.export`` (through
``static.save_inference_model``) keeps its ``if`` / ``while`` as
``torch.cond`` / ``while_loop``. ``save`` / ``load`` write a Layer's
state dict and class name through ``framework.io``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import torch

from ..core import rng
from ..device import DeviceLike, module_device, resolve_device


def _steps_of(batches) -> int:
    if isinstance(batches, torch.Tensor):
        return batches.shape[0]
    if isinstance(batches, dict):
        return _steps_of(next(iter(batches.values())))
    return _steps_of(batches[0])


def _index(batches, i: int):
    """Step ``i`` of a tensor, or a dict / tuple / list of them, stacked
    along a leading steps axis."""
    if isinstance(batches, torch.Tensor):
        return batches[i]
    if isinstance(batches, dict):
        return {k: _index(v, i) for k, v in batches.items()}
    return type(batches)(_index(v, i) for v in batches)


class TrainStep:
    """One train step over an eager step function.

    ``train_fn(model, batch) -> loss`` is ordinary module code (e.g.
    ``lambda m, ids: m(ids, labels=ids)``). Each call runs it in train
    mode inside a :func:`core.rng.key_scope` of the step's generator
    (made on ``device`` from ``seed``; dropout draws from it and never
    from torch's global generators), back-propagates the loss and
    applies ``optimizer``. Gradients stay on the parameters until the
    next step clears them.

    ``device`` is CUDA unless the caller names another (it raises
    without a GPU), and the model must live there. An optimizer built
    without ``parameters=`` is bound to the model's named parameters.
    """

    def __init__(self, model: torch.nn.Module, optimizer,
                 train_fn: Callable[[torch.nn.Module, Any], torch.Tensor],
                 seed: int = 0, device: DeviceLike = None):
        dev = resolve_device(device)
        if module_device(model) != dev:
            raise ValueError(f"TrainStep on {dev}: the model lives on "
                             f"{module_device(model)}")
        if optimizer._named is None:
            optimizer.bind(model.named_parameters())
        self.model = model
        self.optimizer = optimizer
        self.train_fn = train_fn
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)

    def _one(self, batch, lr: float) -> torch.Tensor:
        self.model.train()
        self.optimizer.clear_grad()
        with rng.key_scope(self.generator):
            loss = self.train_fn(self.model, batch)
            loss.backward()
        self.optimizer._step(lr)
        return loss.detach()

    def __call__(self, batch) -> torch.Tensor:
        """One step at the optimizer's current learning rate (read once,
        on the host); returns the loss before the update as a 0-d tensor
        on the model's device (no host synchronisation)."""
        return self._one(batch, self.optimizer.get_lr())

    def multi_step(self, batches) -> torch.Tensor:
        """One step per entry of ``batches`` (a tensor, or a dict / tuple
        of tensors, stacked along a leading steps axis), all at the
        learning rate read once at the call, as the JAX ``multi_step``
        passes one rate to its scan; returns the ``[n_steps]`` losses."""
        lr = self.optimizer.get_lr()
        return torch.stack([self._one(_index(batches, i), lr)
                            for i in range(_steps_of(batches))])

    def sync_to_model(self) -> None:
        """Kept for the JAX API: the port's step updates the model's own
        parameters in place, so there is nothing to write back."""


class EvalStep:
    """Inference step: ``model(*inputs)`` in eval mode under
    ``torch.no_grad()``, inside a :func:`core.rng.key_scope` of the
    step's generator (made on ``device`` from ``seed``), which each call
    advances: a fresh key a call, as the JAX ``EvalStep`` splits one.
    ``device`` is CUDA unless the caller names another (it raises
    without a GPU), and the model must live there."""

    def __init__(self, model: torch.nn.Module, seed: int = 0,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        if module_device(model) != dev:
            raise ValueError(f"EvalStep on {dev}: the model lives on "
                             f"{module_device(model)}")
        self.model = model
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)

    def __call__(self, *args, **kwargs):
        self.model.eval()
        with torch.no_grad(), rng.key_scope(self.generator):
            return self.model(*args, **kwargs)


class StaticFunction:
    """A ``to_static``-decorated function: the dy2static rewrite of
    ``fn``, converted at its first call (``enable_to_static`` toggles
    take effect after decoration), run eagerly."""

    def __init__(self, fn: Callable, model: Optional[torch.nn.Module] = None):
        self._orig_fn = fn
        self._converted_fn = None
        self.model = model

    @property
    def fn(self) -> Callable:
        if not ProgramTranslator.enabled:
            return self._orig_fn
        if self._converted_fn is None:
            self._converted_fn = convert_to_static(self._orig_fn)
        return self._converted_fn

    def __call__(self, *args, **kwargs):
        if self.model is not None and not (args and args[0] is self.model):
            return self.fn(self.model, *args, **kwargs)
        return self.fn(*args, **kwargs)


def to_static(function=None, input_spec=None, **kwargs):
    """Decorator: the dy2static rewrite of a function, or of a Layer's
    ``forward`` (the Layer is returned, its forward replaced)."""
    def deco(fn):
        if isinstance(fn, torch.nn.Module):
            layer = fn
            sf = StaticFunction(type(layer).forward, model=layer)
            layer._static_forward = sf
            layer.forward = functools.partial(_call_static, layer)
            return layer
        return functools.wraps(fn)(StaticFunction(fn))
    if function is not None:
        return deco(function)
    return deco


def _call_static(layer, *args, **kwargs):
    return layer._static_forward(layer, *args, **kwargs)


def save(layer, path: str, input_spec=None) -> None:
    """The layer's state dict and class name to ``path + ".pdparams"``
    (``jit/__init__.py:297-306``); a program is saved by
    ``static.save_inference_model``."""
    from ..framework.io import save as fsave
    fsave({"state_dict": layer.state_dict(),
           "class": f"{type(layer).__module__}.{type(layer).__qualname__}"},
          path + ".pdparams")


def load(path: str):
    """What :func:`save` wrote: ``{"state_dict", "class"}``."""
    from ..framework.io import load as fload
    return fload(path + ".pdparams")


from .dy2static import (ProgramTranslator, convert_to_static,  # noqa: E402
                        enable_to_static)


def not_to_static(fn=None):
    """Mark a function to be skipped by ``to_static`` conversion."""
    def deco(f):
        f.__pt_not_to_static__ = True
        return f
    return deco(fn) if fn is not None else deco


_code_level = 0
_verbosity = 0


def set_code_level(level: int = 100, also_to_stdout: bool = False) -> None:
    """``paddle.jit.set_code_level``: the level of the rewritten code's
    dumps."""
    global _code_level
    _code_level = int(level)


def set_verbosity(level: int = 0, also_to_stdout: bool = False) -> None:
    global _verbosity
    _verbosity = int(level)


class TracedLayer:
    """``paddle.jit.TracedLayer``: a layer captured by running it once on
    example inputs; the capture is a static Program."""

    def __init__(self, program, layer):
        self._program = program
        self._layer = layer

    @staticmethod
    def trace(layer, inputs):
        """``(eager outputs, TracedLayer)`` for ``inputs`` (a tensor or a
        list of them) on the layer's device."""
        from ..static import InputSpec, build_program
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        outs = layer(*ins)
        specs = [InputSpec.from_tensor(i) for i in ins]
        program = build_program(layer, specs)
        return outs, TracedLayer(program, layer)

    def __call__(self, inputs):
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        return self._program.run(*ins)

    def save_inference_model(self, path, feed=None, fetch=None):
        self._program.save(path)


class TranslatedLayer:
    """``paddle.jit.TranslatedLayer``: a Layer read back from a saved
    program; its forward runs the loaded graph."""

    def __init__(self, loaded_program):
        self._loaded = loaded_program
        self.training = False

    @classmethod
    def from_path(cls, path_prefix: str):
        from ..static import load_inference_model
        return cls(load_inference_model(path_prefix))

    def __call__(self, *inputs):
        return self.forward(*inputs)

    def forward(self, *inputs):
        return self._loaded.run(*inputs)

    def eval(self):
        self.training = False
        return self

    def train(self):
        raise RuntimeError(
            "TranslatedLayer wraps a frozen inference program; retraining "
            "needs the original Layer")
