"""Loss scaling for fp16 (port of ``paddle_tpu/amp/grad_scaler.py``):
dynamic scaling with the reference's increase and decrease ratios
(``check_finite_and_unscale`` + ``update_loss_scaling`` semantics), a
pass-through when ``enable=False``.

Kept from the reference as it is: ``step`` unscales, steps the optimizer
unless a gradient was not finite, and then calls ``update`` itself, so
the usual ``scale -> backward -> step -> update`` loop updates twice a
step, and the second call, with the flag already cleared, counts a good
step. ``unscale_`` divides the gradients in place even when one of them
is not finite.

Where the JAX package reads one flag back per parameter
(``bool(jnp.any(...))``), the port computes one found-inf flag over all
gradients on their device and reads it once a step.
"""

from __future__ import annotations

from typing import Dict

import torch


def _params(optimizer):
    """The optimizer's parameter tensors (a ``Lookahead`` delegates)."""
    return [p for _, p in optimizer._params()]


class GradScaler:
    def __init__(self, enable: bool = True, init_loss_scaling: float =
                 2.0 ** 15, incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def get_loss_scaling(self) -> float:
        return self._scale

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer) -> None:
        """Multiply every gradient by ``1 / scale`` in place and set the
        found-inf flag: one device flag over all gradients, one host
        read."""
        if not self._enable:
            return
        grads = [p.grad for p in _params(optimizer) if p.grad is not None]
        inv = 1.0 / self._scale
        for g in grads:
            g.mul_(inv)
        if not grads:
            self._found_inf = False
            return
        finite = torch.stack([torch.isfinite(g).all() for g in grads])
        self._found_inf = not bool(finite.all())

    def step(self, optimizer) -> None:
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss) -> None:
        scaled_loss.backward()
        self.step(optimizer)

    def update(self) -> None:
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def state_dict(self) -> Dict:
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps, "enable": self._enable,
                "use_dynamic_loss_scaling": self._dynamic}

    def load_state_dict(self, state: Dict) -> None:
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)
        self._enable = state.get("enable", self._enable)
        self._dynamic = state.get("use_dynamic_loss_scaling", self._dynamic)


AmpScaler = GradScaler
