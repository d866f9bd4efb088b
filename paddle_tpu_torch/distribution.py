"""Probability distributions (port of ``paddle_tpu/distribution.py``;
reference: ``python/paddle/distribution.py``: ``Distribution:41``,
``Uniform:168``, ``Normal:390``, ``Categorical:640``).

The JAX package's surface (``sample`` / ``entropy`` / ``log_prob`` /
``probs`` / ``kl_divergence``), its argument validation and its dtype
promotion, on torch tensors. Python numbers, lists and arrays become
tensors on the expected place (the card unless ``paddle.set_device``
names another); tensors stay where they are. ``sample(shape, seed)``
draws from a ``torch.Generator`` on the parameters' device seeded with
``seed``; ``seed=0`` draws from the eager random ops' generator of that
device (``core.rng.default_generator``, seeded by ``paddle.seed``), as
the JAX package takes the framework's key stream. Draws are held to
statistics, not bits, as the random ops are; densities, entropies and
divergences are the JAX package's formulas.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from .tensor import Tensor


def _val(x):
    if isinstance(x, Tensor):
        return x.value
    if isinstance(x, torch.Tensor):
        return x
    from .device import resolve_device
    return torch.as_tensor(np.asarray(x, np.float32),
                           device=resolve_device(None))


def _x32(a: np.ndarray) -> np.ndarray:
    """64-bit numpy data as 32-bit, as the JAX package's x32 policy
    reads it."""
    return a.astype({np.dtype(np.float64): np.float32,
                     np.dtype(np.int64): np.int32}.get(a.dtype, a.dtype))


def _generator(seed, device) -> torch.Generator:
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    from .core.rng import default_generator
    return default_generator(device)


class Distribution:
    """Abstract base (reference ``distribution.py:41``)."""

    def sample(self, shape, seed=0):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        raise NotImplementedError

    # -- argument plumbing (reference distribution.py:70-136) ---------------

    @staticmethod
    def _validate_args(*args):
        """Mixing tensors with Python numbers or lists is rejected, as in
        the reference (``:70``): True when the arguments are tensors."""
        is_variable = any(isinstance(a, (Tensor, torch.Tensor))
                          for a in args)
        is_number = any(not isinstance(a, (Tensor, torch.Tensor))
                        for a in args)
        if is_variable and is_number:
            raise ValueError(
                "if one argument is Tensor, all arguments should be "
                "Tensor")
        return is_variable

    @staticmethod
    def _to_tensor(*args):
        """Float / list / ndarray arguments as mutually broadcast tensors
        (reference ``:92``): floats become shape-[1] tensors, dtypes
        other than f32 / f64 warn and convert to f32, and the common
        dtype is numpy's promotion read under x32 (f64 is f32)."""
        from .device import resolve_device
        arrays = []
        for arg in args:
            if isinstance(arg, float):
                arg = [arg]
            if isinstance(arg, int):
                arg = [float(arg)]
            if not isinstance(arg, (list, tuple, np.ndarray, Tensor,
                                    torch.Tensor)):
                raise TypeError(
                    "Type of input args must be float, list, "
                    "numpy.ndarray or Tensor, but received type "
                    f"{type(arg)}")
            if isinstance(arg, (Tensor, torch.Tensor)):
                arg = _val(arg).detach().cpu().numpy()
            a = np.asarray(arg)
            if a.dtype not in (np.float32, np.float64):
                warnings.warn(
                    "data type of argument only support float32 and "
                    "float64, your argument will be convert to float32.")
                a = a.astype(np.float32)
            arrays.append(a)
        common = _x32(np.empty(0, np.result_type(*arrays))).dtype
        shape = np.broadcast_shapes(*(a.shape for a in arrays))
        dev = resolve_device(None)
        return tuple(torch.as_tensor(np.array(
            np.broadcast_to(a.astype(common), shape)), device=dev)
            for a in arrays)

    @staticmethod
    def _check_values_dtype_in_probs(param, value):
        """``value`` cast to the parameters' dtype, with a warning when
        they differ (reference ``:136``); a non-floating value raises."""
        if isinstance(value, (Tensor, torch.Tensor)):
            v = _val(value)
        else:
            v = torch.as_tensor(_x32(np.asarray(value)),
                                device=param.device)
        if not v.is_floating_point():
            raise TypeError(
                f"value dtype must be floating, got {v.dtype}")
        if v.dtype != param.dtype:
            warnings.warn(
                "dtype of input 'value' needs to be the same as "
                "parameters of distribution class. dtype of 'value' "
                "will be converted.")
            v = v.to(param.dtype)
        return v.to(param.device)


class Uniform(Distribution):
    """U(low, high) (reference ``distribution.py:168``)."""

    def __init__(self, low, high, name=None):
        if not self._validate_args(low, high):
            low, high = self._to_tensor(low, high)
        self.low = _val(low)
        self.high = _val(high)
        self.name = name

    def sample(self, shape, seed=0):
        shape = tuple(shape) + tuple(torch.broadcast_shapes(
            self.low.shape, self.high.shape))
        dev = self.low.device
        u = torch.rand(shape, generator=_generator(seed, dev), device=dev,
                       dtype=self.low.dtype)
        return Tensor(self.low + u * (self.high - self.low))

    def log_prob(self, value):
        v = self._check_values_dtype_in_probs(self.low, value)
        inside = (v >= self.low) & (v < self.high)
        lp = -torch.log(self.high - self.low)
        return Tensor(torch.where(inside, lp,
                                  torch.full_like(lp, -math.inf)))

    def probs(self, value):
        return Tensor(torch.exp(self.log_prob(value).value))

    def entropy(self):
        return Tensor(torch.log(self.high - self.low))


class Normal(Distribution):
    """N(loc, scale) (reference ``distribution.py:390``)."""

    def __init__(self, loc, scale, name=None):
        if not self._validate_args(loc, scale):
            loc, scale = self._to_tensor(loc, scale)
        self.loc = _val(loc)
        self.scale = _val(scale)
        self.name = name

    def sample(self, shape, seed=0):
        shape = tuple(shape) + tuple(torch.broadcast_shapes(
            self.loc.shape, self.scale.shape))
        dev = self.loc.device
        z = torch.randn(shape, generator=_generator(seed, dev), device=dev,
                        dtype=self.loc.dtype)
        return Tensor(self.loc + z * self.scale)

    def log_prob(self, value):
        v = self._check_values_dtype_in_probs(self.loc, value)
        var = self.scale * self.scale
        return Tensor(-((v - self.loc) ** 2) / (2.0 * var)
                      - torch.log(self.scale)
                      - 0.5 * math.log(2.0 * math.pi))

    def probs(self, value):
        return Tensor(torch.exp(self.log_prob(value).value))

    def entropy(self):
        return Tensor(0.5 + 0.5 * math.log(2.0 * math.pi)
                      + torch.log(self.scale)
                      + torch.zeros_like(self.loc))

    def kl_divergence(self, other):
        """KL(self || other) for two Normals (reference ``:595``)."""
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return Tensor(0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio)))


class Categorical(Distribution):
    """Categorical over unnormalised logits (reference
    ``distribution.py:640``)."""

    def __init__(self, logits, name=None):
        self.logits = _val(logits)
        self.name = name

    def _log_norm(self):
        return self.logits - torch.logsumexp(self.logits, dim=-1,
                                             keepdim=True)

    def sample(self, shape, seed=0):
        """int32 draws ``[*shape, *logits.shape[:-1]]``: the Gumbel-max
        draw ``jax.random.categorical`` makes."""
        logp = self._log_norm()
        dev = logp.device
        out_shape = tuple(shape) + tuple(logp.shape[:-1])
        u = torch.rand(out_shape + tuple(logp.shape[-1:]),
                       generator=_generator(seed, dev), device=dev,
                       dtype=logp.dtype)
        tiny = torch.finfo(logp.dtype).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        return Tensor(torch.argmax(logp + gumbel, dim=-1).to(torch.int32))

    def probs(self, value=None):
        p = torch.exp(self._log_norm())
        if value is None:
            return Tensor(p)
        idx = _val(value).to(device=p.device, dtype=torch.int64)
        if p.dim() == 1:
            p = p.expand(tuple(idx.shape[:-1]) + tuple(p.shape[-1:]))
        return Tensor(torch.gather(p, -1, idx))

    def log_prob(self, value):
        return Tensor(torch.log(torch.clamp_min(self.probs(value).value,
                                                1e-38)))

    def entropy(self):
        logp = self._log_norm()
        return Tensor(-(torch.exp(logp) * logp).sum(-1))

    def kl_divergence(self, other):
        """KL(self || other) for two Categoricals (reference ``:774``)."""
        logp = self._log_norm()
        logq = other._log_norm()
        return Tensor((torch.exp(logp) * (logp - logq)).sum(-1))
