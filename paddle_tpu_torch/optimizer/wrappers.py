"""Optimizer wrappers: EMA, ModelAverage and Lookahead (port of
``paddle_tpu/optimizer/wrappers.py``).

Each keeps the JAX class's arithmetic, operation for operation and in
the parameter's dtype, on the parameters' own device. Where the JAX
package rebinds ``p.value`` to a new array, the port writes into the
parameter in place (``copy_``), so a parameter keeps its storage (and an
optimizer or a captured graph that holds it keeps seeing it); ``apply``
keeps a copy of each value for ``restore``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch


def _param_list(parameters_or_layer) -> List[torch.Tensor]:
    if hasattr(parameters_or_layer, "parameters"):
        return list(parameters_or_layer.parameters())
    return [p[1] if isinstance(p, tuple) else p
            for p in parameters_or_layer]


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(v.copy())
    return torch.as_tensor(v, device=like.device).clone()


class ExponentialMovingAverage:
    """EMA of parameters; ``apply()`` / ``restore()`` swap the shadow in
    for evaluation (reference: ``fluid/optimizer.py:3882``). The decay of
    step n is ``min(decay, (1 + n) / (10 + n))``; the shadow keeps each
    parameter's dtype."""

    def __init__(self, parameters_or_layer, decay: float = 0.999,
                 thres_steps=None):
        self._params = _param_list(parameters_or_layer)
        self._decay = decay
        self._shadow: Dict[int, torch.Tensor] = {
            id(p): p.detach().clone() for p in self._params}
        self._backup: Dict[int, torch.Tensor] = {}
        self._step = 0

    @torch.no_grad()
    def update(self) -> None:
        self._step += 1
        d = min(self._decay, (1 + self._step) / (10 + self._step))
        for p in self._params:
            s = self._shadow[id(p)]
            s.copy_(d * s + (1.0 - d) * p)

    @torch.no_grad()
    def apply(self, restore: bool = True) -> None:
        for p in self._params:
            self._backup[id(p)] = p.detach().clone()
            p.copy_(self._shadow[id(p)].to(p.dtype))

    @torch.no_grad()
    def restore(self) -> None:
        for p in self._params:
            if id(p) in self._backup:
                p.copy_(self._backup.pop(id(p)))

    @contextlib.contextmanager
    def apply_guard(self):
        self.apply()
        try:
            yield
        finally:
            self.restore()

    def state_dict(self):
        """``{"shadow_<i>": tensor, "step": n}``, the JAX keys; the
        tensors are the live shadows (clone them to keep a snapshot)."""
        return {f"shadow_{i}": self._shadow[id(p)]
                for i, p in enumerate(self._params)} | {"step": self._step}

    def set_state_dict(self, state):
        self._step = int(state.get("step", 0))
        for i, p in enumerate(self._params):
            v = state.get(f"shadow_{i}")
            if v is not None:
                self._shadow[id(p)] = _as_tensor(v, p)


class ModelAverage:
    """Sliding-window parameter average (reference:
    ``fluid/optimizer.py:3573``): a running sum of the parameters over a
    window of ``int(count * average_window_rate) or 1`` steps, clamped to
    ``[min_average_window, max_average_window]``, rescaled geometrically
    (by window / count) once the count passes the window."""

    def __init__(self, average_window_rate: float = 0.15,
                 parameters: Optional[List] = None,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000):
        self._params = _param_list(parameters or [])
        self._rate = average_window_rate
        self._min_w = min_average_window
        self._max_w = max_average_window
        self._sum = {id(p): torch.zeros_like(p, requires_grad=False)
                     for p in self._params}
        self._count = 0
        self._backup: Dict[int, torch.Tensor] = {}

    @torch.no_grad()
    def step(self) -> None:
        self._count += 1
        for p in self._params:
            self._sum[id(p)] = self._sum[id(p)] + p
        window = max(self._min_w, min(self._max_w,
                                      int(self._count * self._rate) or 1))
        if self._count > window:
            # decay old contributions geometrically
            scale = window / self._count
            for p in self._params:
                self._sum[id(p)] = self._sum[id(p)] * scale
            self._count = window

    @torch.no_grad()
    def apply(self) -> None:
        for p in self._params:
            self._backup[id(p)] = p.detach().clone()
            p.copy_((self._sum[id(p)] / max(self._count, 1)).to(p.dtype))

    @torch.no_grad()
    def restore(self) -> None:
        for p in self._params:
            if id(p) in self._backup:
                p.copy_(self._backup.pop(id(p)))

    @contextlib.contextmanager
    def apply_guard(self):
        self.apply()
        try:
            yield
        finally:
            self.restore()


class Lookahead:
    """Lookahead (reference: ``fluid/optimizer.py:5969``
    LookaheadOptimizer): slow weights, copied before the first inner
    step, move ``alpha`` of the way to the fast weights every ``k``
    steps, and the fast weights take them. Other attributes are the
    inner optimizer's. ``jit.TrainStep`` drives it through ``_step``, so
    the slow weights follow a train step's updates too."""

    def __init__(self, inner_optimizer, alpha: float = 0.5, k: int = 5):
        self.inner = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._slow: Optional[Dict[int, torch.Tensor]] = None
        self._steps = 0

    def __getattr__(self, name):
        if name == "inner":  # not set yet: no recursion through it
            raise AttributeError(name)
        return getattr(self.inner, name)

    def step(self) -> None:
        self._step(self.inner.get_lr())

    @torch.no_grad()
    def _step(self, lr: float) -> None:
        params = [p for _, p in self.inner._params()]
        if self._slow is None:
            self._slow = {id(p): p.detach().clone() for p in params}
        self.inner._step(lr)
        self._steps += 1
        if self._steps % self.k == 0:
            for p in params:
                slow = self._slow[id(p)] + self.alpha * (
                    p - self._slow[id(p)])
                self._slow[id(p)] = slow
                p.copy_(slow.to(p.dtype))

    def clear_grad(self):
        self.inner.clear_grad()

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
