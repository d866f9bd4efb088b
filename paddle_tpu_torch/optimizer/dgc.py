"""Deep Gradient Compression momentum (port of
``paddle_tpu/optimizer/dgc.py``): momentum correction, local gradient
accumulation and top-k sparsification with error feedback (Lin et al.,
"Deep Gradient Compression"), after a warm-up of plain momentum and
with a sparsity ramp.

As in the JAX package, the top-k threshold of a tensor is the
``sparsity`` quantile (linear interpolation, ``torch.quantile`` as
``jnp.quantile``) of a strided sample of at most about 4096 of its
magnitudes, and the compressed update is applied as a masked dense
tensor. Each tensor takes its own threshold, so the update is never
grouped (``_elementwise_update = False``). Plain PyTorch: the JAX rule
reaches no Pallas kernel.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .optimizer import Momentum

_SAMPLE_CAP = 4096


def _threshold(v_abs: torch.Tensor, sparsity: float) -> torch.Tensor:
    """The |v| threshold keeping ~(1 - sparsity) of the entries, from a
    strided sample (reference: the dgc lib's sampling estimator)."""
    flat = v_abs.reshape(-1).to(torch.float32)
    stride = max(1, flat.numel() // _SAMPLE_CAP)
    sample = flat[::stride]
    return torch.quantile(sample, min(max(sparsity, 0.0), 1.0))


def _interp(x: float, xp, fp) -> np.float32:
    """``jnp.interp`` at one point in float32: ``fp`` linearly between
    the sample points ``xp`` (increasing), clamped to its ends."""
    x = np.float32(x)
    xp = np.asarray(xp, np.float32)
    fp = np.asarray(fp, np.float32)
    i = int(np.clip(np.searchsorted(xp, x, side="right"), 1, len(xp) - 1))
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    f = fp[i - 1] + (delta / dx) * (fp[i] - fp[i - 1])
    if x < xp[0]:
        return fp[0]
    if x > xp[-1]:
        return fp[-1]
    return np.float32(f)


class DGCMomentum(Momentum):
    """Momentum with deep-gradient-compression semantics.

    Up to ``rampup_begin_step`` it is exactly ``Momentum``; after it each
    step accumulates a velocity ``u`` and an error-feedback buffer ``v``
    and applies only the entries of ``v`` whose magnitude reaches the
    threshold of the ramped ``sparsity`` (``>=``, so a tensor of equal
    magnitudes still updates), keeping the rest for later steps. Tensors
    of one element always take plain momentum."""

    # the top-k threshold is per tensor: a fused flat buffer would share
    # one threshold and starve small-magnitude parameters
    _elementwise_update = False

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 rampup_begin_step: int = 0, rampup_step: int = 1,
                 sparsity: Sequence[float] = (0.999,),
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, momentum, parameters,
                         use_nesterov, weight_decay, grad_clip, name, **kw)
        self._rampup_begin = int(rampup_begin_step)
        self._rampup_step = max(1, int(rampup_step))
        self._sparsity = tuple(float(s) for s in sparsity)

    def _init_state(self, value):
        return {"velocity": torch.zeros_like(value),
                "u": torch.zeros_like(value),
                "v": torch.zeros_like(value)}

    def sparsity_at(self, step) -> np.float32:
        """The sparsity of ``step``: the list walked over ``rampup_step``
        steps from ``rampup_begin_step`` (reference: dgc_configs)."""
        levels = np.asarray(self._sparsity, np.float32)
        if len(levels) == 1:
            return levels[0]
        n = len(levels)
        pos = (np.float32(step) - np.float32(self._rampup_begin)) \
            / np.float32(self._rampup_step) * np.float32(n - 1)
        return _interp(np.clip(pos, np.float32(0.0), np.float32(n - 1)),
                      np.arange(n, dtype=np.float32), levels)

    def _update(self, value, grad, state, lr, step):
        g = grad.to(value.dtype)
        m = self._momentum
        if value.dim() == 0 or value.numel() <= 1 or \
                step <= self._rampup_begin:
            # plain momentum: the warm-up, and scalars (never worth
            # sparsifying)
            vel = m * state["velocity"] + g
            state["velocity"] = vel
            if self._nesterov:
                return value - float(lr) * (g + m * vel)
            return value - float(lr) * vel
        # momentum correction: the velocity accumulates locally...
        u = m * state["u"] + g
        v = state["v"] + u
        # ...and only the top-magnitude slice is applied this step
        thr = _threshold(v.abs(), float(self.sparsity_at(step))).to(
            value.dtype)
        mask = v.abs() >= thr
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        applied = torch.where(mask, v, zero)
        state["v"] = torch.where(mask, zero, v)
        state["u"] = torch.where(mask, zero, u)
        return value - float(lr) * applied
