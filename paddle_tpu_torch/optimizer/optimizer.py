"""Optimizers (port of ``paddle_tpu/optimizer/optimizer.py``): the
``Optimizer`` base with ``step``, ``minimize``, ``clear_grad``,
learning-rate schedulers and ``state_dict``, and SGD, Momentum, Adagrad,
Adadelta, RMSProp, Adam, AdamW, Adamax, Lamb, LarsMomentum, Ftrl, Dpsgd,
DecayedAdagrad and Rprop.

Each update rule is the JAX package's, operation for operation:

- weight decay as in ``_apply_flat``: L2 adds ``wd * p`` to the gradient,
  ``L1Decay`` adds ``wd * sign(p)``; decoupled decay (AdamW) subtracts
  ``p * (lr * wd)``, from the value before the update, for every
  parameter (the JAX AdamW stores ``apply_decay_param_fun`` but never
  applies it);
- Adam adds ``eps`` outside ``sqrt(v_hat)``; bias corrections
  ``1 - beta ** step`` are taken in float32, and so is ``lr * wd``, as
  the JAX step computes them from a float32 step and a float32 rate;
- Adam's moments take the parameter's dtype unless ``multi_precision``.

The learning rate is a number or an ``LRScheduler`` (``lr.py``), read
once a step. Under the ``fuse_optimizer`` flag (``core/flags.py``) the
parameters are grouped by (dtype, slot dtypes) and each group is
updated at once, unless the rule is not elementwise (Lamb, LarsMomentum,
Dpsgd) or ``apply_decay_param_fun`` is set (``optimizer.py:236-273``).
Adam and AdamW update a group, or one parameter without the flag, with
one hand-written CUDA pass on the card (``ops/kernels/
optimizer_update.py``; its plain version on the CPU); L1 decay and the
other optimizers are plain PyTorch, as their JAX rules reach no Pallas
kernel. A fused group gives the same bits as its parameters one by one.

Where the JAX package returns new arrays, the port writes each new
value into the parameter (``copy_``) and Adam's moments in place (no
second copy of a 1.3B model's state). State is keyed by parameter name,
so a JAX ``TrainStep.opt_state`` loads without renaming
(:func:`load_jax_optimizer_state`): construct the optimizer with
``parameters=model.named_parameters()``, or without parameters and let
``jit.TrainStep`` bind the model's.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..core.flags import get_flag
from ..ops.nn_functional import weak_scalar
from ..ops.kernels.optimizer_update import (DECAY_DECOUPLED, DECAY_L2,
                                            DECAY_NONE, adam_update,
                                            adam_update_reference,
                                            bias_corrections)
from .clip import GradClipBase
from .lr import LRScheduler


def _named(parameters) -> List[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` pairs from named pairs or bare tensors (named
    ``param_<i>``)."""
    if isinstance(parameters, torch.Tensor):
        raise TypeError("optimizer: parameters must be an iterable of "
                        "tensors or (name, tensor) pairs")
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
    """Base class: subclasses give ``_init_state`` and ``_update`` (or,
    like Adam, ``_update_group``)."""

    _decoupled_wd = False  # AdamW overrides
    # an elementwise rule may update a dtype group at once; rules with
    # per-tensor norms or draws opt out (Lamb, LarsMomentum, Dpsgd)
    _elementwise_update = True
    # _init_state has Python side effects (Dpsgd's noise-id counter):
    # called exactly once per parameter
    _stateful_slot_init = False

    def __init__(self, learning_rate=0.001,
                 parameters: Optional[Iterable] = None, weight_decay=None,
                 grad_clip: Optional[GradClipBase] = None, name=None,
                 multi_precision: bool = False):
        if isinstance(learning_rate, LRScheduler):
            self._learning_rate = learning_rate
        elif isinstance(learning_rate, (int, float, np.floating)):
            self._learning_rate = float(learning_rate)
        else:
            raise TypeError(f"optimizer: learning_rate must be a number or "
                            f"an LRScheduler, got {type(learning_rate)}")
        self._named = None if parameters is None else _named(parameters)
        self._weight_decay = self._parse_wd(weight_decay)
        # L1Decay adds coeff * sign(w) instead of coeff * w
        self._wd_mode = getattr(weight_decay, "mode", "l2")
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

    # -- learning rate --------------------------------------------------------

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise ValueError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    @property
    def _lr_scheduler(self) -> Optional[LRScheduler]:
        return self._learning_rate if isinstance(
            self._learning_rate, LRScheduler) else None

    # -- update rule (override in subclasses) ---------------------------------

    def _init_state(self, value: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _update(self, value, grad, state, lr: np.float32, step: int):
        """Return the new value; the new slots go into ``state``."""
        raise NotImplementedError

    def _update_with_wd(self, value, grad, state, lr, step):
        """``_update`` with the weight decay around it
        (``_apply_flat``'s ``update_with_wd``), in the value's dtype."""
        wd = self._weight_decay
        if wd:
            direction = torch.sign(value) if self._wd_mode == "l1" \
                else value
            if not self._decoupled_wd:
                grad = grad + wd * direction
            else:
                decay = direction * float(lr * _f32(wd))
        nv = self._update(value, grad, state, lr, step)
        if wd and self._decoupled_wd:
            nv = nv - decay
        return nv.to(value.dtype)

    def _update_group(self, values, grads, states, lr, step) -> None:
        """Update ``values`` (one dtype group, or one parameter) in
        place; the plain rule runs tensor by tensor."""
        for p, g, s in zip(values, grads, states):
            p.copy_(self._update_with_wd(p, g, s, lr, step))

    # -- eager step -----------------------------------------------------------

    def step(self) -> None:
        """One update of every parameter that has a gradient (those
        without keep their value and state, as a None gradient does in
        the JAX package), at the current learning rate."""
        self._step(self.get_lr())

    @torch.no_grad()
    def _step(self, lr: float) -> None:
        """``step`` at the learning rate ``lr`` (``jit.TrainStep`` reads
        it once a call, as the JAX step passes one rate to its scan)."""
        self._global_step += 1
        live = [(n, p) for n, p in self._params() if p.grad is not None]
        grads = {n: p.grad for n, p in live}
        if self._grad_clip is not None:
            grads = self._grad_clip.apply(grads)
        lr = _f32(lr)
        for n, p in live:
            if n not in self._state:
                self._state[n] = self._init_state(p)
        fuse = (get_flag("fuse_optimizer") and self._elementwise_update
                and getattr(self, "_apply_decay_param_fun", None) is None)
        groups: Dict[Any, List[Tuple[str, torch.Tensor]]] = {}
        for n, p in live:
            s = self._state[n]
            if fuse and all(torch.is_tensor(t) and t.shape == p.shape
                            for t in s.values()):
                key = (p.dtype, p.device,
                       tuple((k, s[k].dtype) for k in sorted(s)))
            else:
                key = n  # a group of its own
            groups.setdefault(key, []).append((n, p))
        for members in groups.values():
            self._update_group([p for _, p in members],
                               [grads[n] for n, _ in members],
                               [self._state[n] for n, _ in members], lr,
                               self._global_step)

    def clear_grad(self) -> None:
        for _, p in self._params():
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None) -> None:
        """Backward of ``loss``, then ``step`` (the reference's eager
        ``Optimizer.minimize``)."""
        loss.backward()
        self.step()

    # -- state dict -----------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """``{"global_step": n, "<param>.<slot>": tensor}``, the JAX
        package's keys, and ``"LR_Scheduler"`` under a scheduler. The
        tensors are the live state (Adam's moments are updated in place):
        clone them to keep a snapshot."""
        out: Dict[str, Any] = {"global_step": self._global_step}
        for pname, slots in self._state.items():
            for sname, t in slots.items():
                out[f"{pname}.{sname}"] = t
        if self._lr_scheduler is not None:
            out["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return out

    def set_state_dict(self, state: Dict[str, Any]) -> None:
        self._global_step = int(state.get("global_step", 0))
        if "LR_Scheduler" in state and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state["LR_Scheduler"])
        params = dict(self._params())
        self._state = {}
        for key, v in state.items():
            if key in ("global_step", "LR_Scheduler"):
                continue
            pname, _, sname = key.rpartition(".")
            if pname not in params:
                raise KeyError(f"optimizer state for unknown parameter "
                               f"{pname!r}")
            self._state.setdefault(pname, {})[sname] = torch.as_tensor(
                v, device=params[pname].device).clone()


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _update(self, value, grad, state, lr, step):
        return value - float(lr) * grad.to(value.dtype)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, value):
        return {"velocity": torch.zeros_like(value)}

    def _update(self, value, grad, state, lr, step):
        # the momentum takes the velocity's dtype (JAX's weak typing); the
        # float32 rate widens the step to f32, and _update_with_wd rounds
        # the new value back, as the JAX step with its float32 rate does
        g = grad.to(value.dtype)
        mu = weak_scalar(self._momentum, state["velocity"])
        v = mu * state["velocity"] + g
        state["velocity"] = v
        wide = torch.promote_types(value.dtype, torch.float32)
        step_dir = g + mu * v if self._nesterov else v
        return value.to(wide) - float(lr) * step_dir.to(wide)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, value):
        return {"moment": torch.full_like(value, self._init_acc)}

    def _update(self, value, grad, state, lr, step):
        g = grad.to(value.dtype)
        m = state["moment"] + g * g
        state["moment"] = m
        return value - float(lr) * g / (torch.sqrt(m) + self._epsilon)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._rho = rho

    def _init_state(self, value):
        return {"avg_squared_grad": torch.zeros_like(value),
                "avg_squared_update": torch.zeros_like(value)}

    def _update(self, value, grad, state, lr, step):
        g = grad.to(value.dtype)
        rho, eps = self._rho, self._epsilon
        asg = rho * state["avg_squared_grad"] + (1 - rho) * g * g
        update = g * torch.sqrt(state["avg_squared_update"] + eps) \
            / torch.sqrt(asg + eps)
        state["avg_squared_update"] = rho * state["avg_squared_update"] + \
            (1 - rho) * update * update
        state["avg_squared_grad"] = asg
        return value - float(lr) * update


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _init_state(self, value):
        s = {"mean_square": torch.zeros_like(value),
             "momentum": torch.zeros_like(value)}
        if self._centered:
            s["mean_grad"] = torch.zeros_like(value)
        return s

    def _update(self, value, grad, state, lr, step):
        g = grad.to(value.dtype)
        rho = self._rho
        ms = rho * state["mean_square"] + (1 - rho) * g * g
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g
            denom = torch.sqrt(ms - mg * mg + self._epsilon)
            state["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * state["momentum"] + float(lr) * g / denom
        state["mean_square"], state["momentum"] = ms, mom
        return value - mom


class Adam(Optimizer):
    """Adam; on the card a dtype group (or one parameter) is one pass of
    the ``adam_update`` kernel. L1 decay takes the plain chain."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay=None, grad_clip=None,
                 lazy_mode=False, multi_precision: bool = False, name=None,
                 **kw):
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

    def _hyper(self, lr, step):
        return dict(lr=float(lr), beta1=self._beta1, beta2=self._beta2,
                    eps=self._epsilon, step=step)

    def _update(self, value, grad, state, lr, step):
        nv = value.clone()
        adam_update_reference([nv], [grad], [state["moment1"]],
                              [state["moment2"]], **self._hyper(lr, step))
        return nv

    def _update_group(self, values, grads, states, lr, step):
        if self._weight_decay and self._wd_mode == "l1":
            super()._update_group(values, grads, states, lr, step)
            return
        decay = DECAY_NONE
        if self._weight_decay:
            decay = DECAY_DECOUPLED if self._decoupled_wd else DECAY_L2
        adam_update(list(values), list(grads),
                    [s["moment1"] for s in states],
                    [s["moment2"] for s in states],
                    weight_decay=self._weight_decay, decay=decay,
                    **self._hyper(lr, step))


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01).
    ``apply_decay_param_fun`` is stored and, as in the JAX package, not
    applied; setting it turns ``fuse_optimizer``'s grouping off."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay=0.01, grad_clip=None,
                 lazy_mode=False, multi_precision: bool = False,
                 apply_decay_param_fun=None, name=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name)
        self._apply_decay_param_fun = apply_decay_param_fun


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_state(self, value):
        return {"moment": torch.zeros_like(value),
                "inf_norm": torch.zeros_like(value)}

    def _update(self, value, grad, state, lr, step):
        g = grad.to(value.dtype)
        m = self._beta1 * state["moment"] + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * state["inf_norm"], torch.abs(g))
        lr_t = lr / (_f32(1.0) - _f32(self._beta1) ** _f32(step))
        state["moment"], state["inf_norm"] = m, u
        return value - float(lr_t) * m / (u + self._epsilon)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x))


class Lamb(Optimizer):
    """Layer-wise adaptive moments for large-batch training; never
    grouped (a trust ratio from each tensor's norms)."""

    _elementwise_update = False

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lamb_wd = lamb_weight_decay
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, value):
        return {"moment1": torch.zeros_like(value, dtype=torch.float32),
                "moment2": torch.zeros_like(value, dtype=torch.float32)}

    def _update(self, value, grad, state, lr, step):
        g = grad.to(torch.float32)
        v32 = value.to(torch.float32)
        b1, b2 = self._beta1, self._beta2
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g * g
        bc1, bc2 = bias_corrections(b1, b2, step)
        r = (m / float(bc1)) / (torch.sqrt(v / float(bc2)) + self._epsilon) \
            + self._lamb_wd * v32
        w_norm, r_norm = _norm(v32), _norm(r)
        one = torch.ones((), device=value.device)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            one)
        state["moment1"], state["moment2"] = m, v
        return (v32 - float(lr) * trust * r).to(value.dtype)


class LarsMomentum(Optimizer):
    """LARS; never grouped (a local rate from each tensor's norms)."""

    _elementwise_update = False

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005, parameters=None,
                 grad_clip=None, epsilon=1e-9, name=None, **kw):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._epsilon = epsilon

    def _init_state(self, value):
        return {"velocity": torch.zeros_like(value)}

    def _update(self, value, grad, state, lr, step):
        g = grad.to(value.dtype)
        w_norm = _norm(value.to(torch.float32))
        g_norm = _norm(g.to(torch.float32))
        one = torch.ones((), device=value.device)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self._lars_coeff * w_norm /
            (g_norm + self._lars_wd * w_norm + self._epsilon), one)
        v = self._momentum * state["velocity"] + float(lr) * local_lr * (
            g + self._lars_wd * value)
        state["velocity"] = v
        return value - v


class Ftrl(Optimizer):
    """Follow-the-regularized-leader."""

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _init_state(self, value):
        return {"squared": torch.zeros_like(value),
                "linear": torch.zeros_like(value)}

    def _update(self, value, grad, state, lr, step):
        g = grad.to(value.dtype)
        sq, lin = state["squared"], state["linear"]
        lr = float(lr)
        new_sq = sq + g * g
        lp = -self._lr_power
        sigma = (new_sq ** lp - sq ** lp) / lr
        new_lin = lin + g - sigma * value
        pre = new_sq ** lp / lr + 2.0 * self._l2
        l1 = self._l1
        new_value = torch.where(
            torch.abs(new_lin) > l1,
            (torch.sign(new_lin) * l1 - new_lin) / pre,
            torch.zeros((), dtype=new_lin.dtype, device=value.device))
        state["squared"], state["linear"] = new_sq, new_lin
        return new_value.to(value.dtype)


class Dpsgd(Optimizer):
    """Differentially private SGD: each gradient clipped to its own norm
    ``clip``, plus Gaussian noise of std ``clip * sigma / batch_size``.
    Never grouped (a per-tensor norm and draw). The noise of a parameter
    at a step comes from a ``torch.Generator`` seeded from (``seed``,
    step, the parameter's noise id), where the JAX package folds the same
    three into its key: parameters draw independent noise, and a restart
    from a ``state_dict`` draws the same noise again."""

    _elementwise_update = False
    _stateful_slot_init = True  # the noise-id counter below

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16.0,
                 sigma=1.0, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, seed: int = 0, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._clip, self._batch, self._sigma = clip, batch_size, sigma
        self._seed = seed
        self._next_noise_id = 0

    def _init_state(self, value):
        nid = self._next_noise_id
        self._next_noise_id += 1
        return {"noise_id": torch.tensor(nid, dtype=torch.int32)}

    def _noise(self, shape, device, step: int, nid: int) -> torch.Tensor:
        gen = torch.Generator(device=device)
        gen.manual_seed(((self._seed * 1000003 + step) * 1000033 + nid)
                        % (1 << 63))
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32)

    def _update(self, value, grad, state, lr, step):
        g = grad.to(torch.float32)
        norm = torch.sqrt(torch.sum(g * g))
        scale = torch.clamp_max(self._clip / norm.clamp_min(1e-12), 1.0)
        g = g * scale
        noise = self._noise(g.shape, value.device, step,
                            int(state["noise_id"])) * (
            self._clip * self._sigma / self._batch)
        return (value.to(torch.float32) -
                float(lr) * (g + noise)).to(value.dtype)


class DecayedAdagrad(Optimizer):
    """Adagrad with a decaying accumulator."""

    def __init__(self, learning_rate=0.001, decay=0.95, epsilon=1e-6,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._decay, self._epsilon = decay, epsilon

    def _init_state(self, value):
        return {"moment": torch.zeros_like(value)}

    def _update(self, value, grad, state, lr, step):
        g = grad.to(value.dtype)
        m = self._decay * state["moment"] + (1 - self._decay) * g * g
        state["moment"] = m
        return value - float(lr) * g / (torch.sqrt(m) + self._epsilon)


class Rprop(Optimizer):
    """Resilient backprop: sign-based per-weight step sizes."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 etas=(0.5, 1.2), parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_minus, self._eta_plus = etas

    def _init_state(self, value):
        return {"prev_grad": torch.zeros_like(value),
                "step_size": torch.full_like(value, float(self.get_lr()))}

    def _update(self, value, grad, state, lr, step):
        g = grad.to(value.dtype)
        prev, sz = state["prev_grad"], state["step_size"]
        sign = torch.sign(g * prev)
        sz = torch.clamp(
            torch.where(sign > 0, sz * self._eta_plus,
                        torch.where(sign < 0, sz * self._eta_minus, sz)),
            self._lr_min, self._lr_max)
        g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
        state["prev_grad"], state["step_size"] = g_eff, sz
        return value - torch.sign(g_eff) * sz


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
