"""Train steps (port of ``paddle_tpu/jit/__init__.py:85-185``).

The JAX ``TrainStep`` traces forward, ``value_and_grad`` and the
optimizer update into one jitted program and ``multi_step`` scans it over
stacked batches. The port runs the same step eagerly: forward, autograd
backward (through the attention kernels' backward kernels on the card)
and the optimizer's in-place update, with nothing read back to the host,
so the CUDA launches of consecutive steps queue up behind each other.
Capturing a step in a CUDA graph is later work (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Callable

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
