"""Optimizers (port of ``paddle_tpu/optimizer/optimizer.py:30-270,
404-447``): the ``Optimizer`` base with ``step``, ``clear_grad`` and
``state_dict``, ``Adam`` and ``AdamW``.

The update rule is the JAX package's, operation for operation:

- ``AdamW``'s decay is decoupled and uses the parameter's value before
  the Adam update: ``new = (v - adam_update) - (lr * wd) * v``
  (``optimizer.py:212-226``), for every parameter, LayerNorm scales and
  biases included (the JAX AdamW stores ``apply_decay_param_fun`` but
  never applies it);
- ``eps`` is added outside ``sqrt(v_hat)``;
- bias correction ``1 - beta ** step`` is taken in float32, and so is
  ``lr * wd``, as the JAX step computes them from a float32 step and a
  float32 learning rate;
- the moments take the parameter's dtype unless ``multi_precision``.

Where the JAX package returns new arrays, the port updates parameters
and moments in place (no second copy of a 1.3B model's state). State is
keyed by parameter name, so a JAX ``TrainStep.opt_state`` loads without
renaming (:func:`load_jax_optimizer_state`): construct the optimizer
with ``parameters=model.named_parameters()``, or without parameters
and let ``jit.TrainStep`` bind the model's.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .clip import GradClipBase


def _named(parameters) -> List[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` pairs from named pairs or bare tensors (named
    ``param_<i>``)."""
    out = []
    for i, item in enumerate(parameters):
        if isinstance(item, tuple):
            out.append((str(item[0]), item[1]))
        else:
            out.append((f"param_{i}", item))
    names = [n for n, _ in out]
    if len(set(names)) != len(names):
        raise ValueError("optimizer: parameter names must be unique")
    return out


def _f32(x) -> np.float32:
    return np.float32(x)


class Optimizer:
    """Base class: subclasses give ``_init_state`` and ``_update``."""

    _decoupled_wd = False  # AdamW overrides

    def __init__(self, learning_rate: float = 0.001,
                 parameters: Optional[Iterable] = None, weight_decay=None,
                 grad_clip: Optional[GradClipBase] = None, name=None,
                 multi_precision: bool = False):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not yet ported, see "
                "ROADMAP.md")
        self._learning_rate = float(learning_rate)
        self._named = None if parameters is None else _named(parameters)
        self._weight_decay = self._parse_wd(weight_decay)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._state: Dict[str, Dict[str, torch.Tensor]] = {}
        self._global_step = 0

    @staticmethod
    def _parse_wd(weight_decay) -> float:
        if weight_decay is None:
            return 0.0
        if isinstance(weight_decay, (int, float)):
            return float(weight_decay)
        if getattr(weight_decay, "mode", "l2") != "l2":
            raise NotImplementedError(
                "L1 weight decay is not yet ported, see ROADMAP.md")
        return float(getattr(weight_decay, "_coeff",
                             getattr(weight_decay, "coeff", 0.0)))

    def bind(self, parameters: Iterable) -> None:
        """Give an optimizer built without ``parameters=`` its
        parameters, as ``jit.TrainStep`` does with the model's named
        ones (the JAX ``TrainStep`` takes ``AdamW(1e-4)`` the same way)."""
        if self._named is not None:
            raise ValueError("optimizer: parameters are already bound")
        self._named = _named(parameters)

    def _params(self) -> List[Tuple[str, torch.Tensor]]:
        if self._named is None:
            raise ValueError("optimizer: constructed without parameters; "
                             "pass parameters= or hand it to "
                             "jit.TrainStep")
        return self._named

    def get_lr(self) -> float:
        return self._learning_rate

    def _init_state(self, value: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _update(self, value, grad, state, lr: np.float32, step: int):
        """Return the new value; ``state`` is updated in place."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self) -> None:
        """One update of every parameter that has a gradient (those
        without keep their value and state, as a None gradient does in
        the JAX package)."""
        self._global_step += 1
        live = [(n, p) for n, p in self._params() if p.grad is not None]
        grads = {n: p.grad for n, p in live}
        if self._grad_clip is not None:
            grads = self._grad_clip.apply(grads)
        lr = _f32(self.get_lr())
        wd = self._weight_decay
        lr_wd = float(lr * _f32(wd))
        for n, p in live:
            if n not in self._state:
                self._state[n] = self._init_state(p)
            g = grads[n]
            if wd and not self._decoupled_wd:
                g = g + wd * p
            decay = p * lr_wd if wd and self._decoupled_wd else None
            nv = self._update(p, g, self._state[n], lr, self._global_step)
            if decay is not None:
                nv = nv - decay
            p.copy_(nv.to(p.dtype))

    def clear_grad(self) -> None:
        for _, p in self._params():
            p.grad = None

    def state_dict(self) -> Dict[str, Any]:
        """``{"global_step": n, "<param>.<slot>": tensor}``, the JAX
        package's keys. The tensors are the live state that ``step``
        updates in place: clone them to keep a snapshot."""
        out: Dict[str, Any] = {"global_step": self._global_step}
        for pname, slots in self._state.items():
            for sname, t in slots.items():
                out[f"{pname}.{sname}"] = t
        return out

    def set_state_dict(self, state: Dict[str, Any]) -> None:
        self._global_step = int(state.get("global_step", 0))
        params = dict(self._params())
        self._state = {}
        for key, v in state.items():
            if key == "global_step":
                continue
            pname, _, sname = key.rpartition(".")
            if pname not in params:
                raise KeyError(f"optimizer state for unknown parameter "
                               f"{pname!r}")
            self._state.setdefault(pname, {})[sname] = torch.as_tensor(
                v, device=params[pname].device).clone()


class Adam(Optimizer):
    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision: bool = False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_state(self, value):
        acc = torch.float32 if self._multi_precision else value.dtype
        return {"moment1": torch.zeros(value.shape, dtype=acc,
                                       device=value.device),
                "moment2": torch.zeros(value.shape, dtype=acc,
                                       device=value.device)}

    def _update(self, value, grad, state, lr, step):
        m, v = state["moment1"], state["moment2"]
        g = grad.to(m.dtype)
        m.mul_(self._beta1).add_(g * (1 - self._beta1))
        v.mul_(self._beta2).add_(g * (1 - self._beta2) * g)
        step_f = _f32(step)
        bc1 = float(_f32(1.0) - _f32(self._beta1) ** step_f)
        bc2 = float(_f32(1.0) - _f32(self._beta2) ** step_f)
        upd = (m / bc1).mul_(float(lr)).div_(
            (v / bc2).sqrt_().add_(self._epsilon))
        return (value.to(m.dtype) - upd).to(value.dtype)


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01)."""

    _decoupled_wd = True

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay=0.01, grad_clip=None,
                 multi_precision: bool = False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision, name)


def load_jax_optimizer_state(optimizer: Optimizer,
                             opt_state: Dict[str, Any]) -> None:
    """Load a JAX ``TrainStep.opt_state`` (``{"slots": {name: {slot:
    array}}, "step": int}``, e.g. as numpy) into ``optimizer``, whose
    parameters must carry the JAX model's names. Missing or unexpected
    names, slots or shapes raise."""
    slots = opt_state["slots"]
    own = dict(optimizer._params())
    missing = sorted(set(own) - set(slots))
    extra = sorted(set(slots) - set(own))
    if missing or extra:
        raise KeyError(f"optimizer state does not match the parameters: "
                       f"missing {missing[:4]}, unexpected {extra[:4]}")
    state = {}
    for name, p in own.items():
        fresh = optimizer._init_state(p)
        if set(fresh) != set(slots[name]):
            raise KeyError(f"{name}: slots {sorted(slots[name])} != "
                           f"{sorted(fresh)}")
        for sname, t in fresh.items():
            src = np.asarray(slots[name][sname]).astype(np.float32)
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}.{sname}: shape {src.shape} != "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(src).to(t.dtype))
        state[name] = fresh
    optimizer._state = state
    optimizer._global_step = int(np.asarray(opt_state["step"]))
