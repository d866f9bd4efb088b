"""Random ops (port of ``paddle_tpu/ops/random.py``).

Every draw comes from an explicit ``torch.Generator``: the one passed as
``generator=`` (the JAX functions' ``key=``), else the innermost
``core.rng.key_scope``'s, else the device's generator of
``paddle.seed`` (``core.rng.default_generator``). So ``paddle.seed(s)``
makes a run's draws repeat. The bits cannot match JAX's PRNG: the
port's random ops are held to shapes, dtypes, seed determinism and the
distributions' moments.
"""

from __future__ import annotations

import torch

from ..core.dtype import convert_dtype, default_dtype
from ..core.rng import generator_for
from ._eager import device_of, shape_arg, tensor


def _float(dtype):
    return convert_dtype(dtype) if dtype else default_dtype()


def _gen(generator, device):
    return generator if generator is not None else generator_for(device)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0,  # noqa: A002
            generator=None):
    """``U[min, max)``; a nonzero ``seed`` pins the draw."""
    dev = device_of()
    if isinstance(seed, int) and seed and generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    out = torch.empty(shape_arg(shape), dtype=_float(dtype), device=dev)
    return out.uniform_(float(min), float(max),
                        generator=_gen(generator, dev))


def normal(mean=0.0, std=1.0, shape=None, dtype=None, generator=None):
    dev = device_of(mean, std)
    z = torch.randn(shape_arg(shape or ()), dtype=_float(dtype), device=dev,
                    generator=_gen(generator, dev))
    return mean + std * z


def randn(shape, dtype=None, generator=None):
    return normal(0.0, 1.0, shape, dtype, generator)


def rand(shape, dtype=None, generator=None):
    return uniform(shape, dtype, 0.0, 1.0, generator=generator)


def randint(low=0, high=None, shape=(1,), dtype="int64", generator=None):
    if high is None:
        low, high = 0, low
    dev = device_of()
    return torch.randint(int(low), int(high), shape_arg(shape),
                         dtype=convert_dtype(dtype), device=dev,
                         generator=_gen(generator, dev))


def randint_like(x, low=0, high=None, dtype=None, generator=None):
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), tuple(x.shape),
                         dtype=convert_dtype(dtype or x.dtype),
                         device=x.device,
                         generator=_gen(generator, x.device))


def randperm(n, dtype="int64", generator=None):
    dev = device_of()
    return torch.randperm(int(n), device=dev,
                          generator=_gen(generator, dev)).to(
        convert_dtype(dtype))


def shuffle(x, axis=0, generator=None):
    perm = torch.randperm(x.shape[int(axis)], device=x.device,
                          generator=_gen(generator, x.device))
    return torch.index_select(x, int(axis), perm)


def bernoulli(x, generator=None):
    return torch.bernoulli(x, generator=_gen(generator, x.device))


def multinomial(x, num_samples=1, replacement=False, generator=None):
    return torch.multinomial(x, int(num_samples), replacement=replacement,
                             generator=_gen(generator, x.device)).to(
        torch.int32)


def poisson(x, generator=None):
    return torch.poisson(x, generator=_gen(generator, x.device)).to(x.dtype)


def exponential(x, lam=1.0, generator=None):
    return torch.empty_like(x).exponential_(
        1.0, generator=_gen(generator, x.device)) / lam


def standard_gamma(alpha, generator=None):
    """Gamma(alpha, 1) by Marsaglia and Tsang's squeeze (alpha < 1 by
    the ``U^(1/alpha)`` boost), vectorised: each round redraws the
    entries not yet accepted."""
    alpha = tensor(alpha)
    alpha = alpha if alpha.is_floating_point() else alpha.to(
        default_dtype())
    gen = _gen(generator, alpha.device)
    a = torch.where(alpha < 1, alpha + 1, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while bool(todo.any()):
        z = torch.randn(a.shape, dtype=a.dtype, device=a.device,
                        generator=gen)
        u = torch.rand(a.shape, dtype=a.dtype, device=a.device,
                       generator=gen)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(torch.clamp_min(v, 1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    boost = torch.rand(a.shape, dtype=a.dtype, device=a.device,
                       generator=gen) ** (1.0 / alpha)
    return torch.where(alpha < 1, out * boost, out)


def normal_like(x, mean=0.0, std=1.0, generator=None):
    z = torch.randn(tuple(x.shape), dtype=x.dtype, device=x.device,
                    generator=_gen(generator, x.device))
    return mean + std * z


def uniform_like(x, min=-1.0, max=1.0, generator=None):  # noqa: A002
    return torch.empty_like(x).uniform_(
        float(min), float(max), generator=_gen(generator, x.device))


def rand_like(x, generator=None):
    return uniform_like(x, 0.0, 1.0, generator)


def gumbel(shape, dtype=None, generator=None):
    dev = device_of()
    u = torch.empty(shape_arg(shape), dtype=_float(dtype), device=dev)
    u.uniform_(generator=_gen(generator, dev))
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(torch.clamp(u, tiny, 1.0)))


def binomial(count, prob, generator=None):
    """Binomial(count, prob) elementwise, int32."""
    c = tensor(count)
    p = tensor(prob, c.device)
    c, p = torch.broadcast_tensors(c.to(torch.float32), p.to(torch.float32))
    return torch.binomial(c.contiguous(), p.contiguous(),
                          generator=_gen(generator, c.device)).to(torch.int32)


def lognormal(mean=1.0, std=2.0, shape=(1,), dtype=None, generator=None):
    return torch.exp(normal(mean, std, shape, dtype, generator))


def standard_normal(shape, dtype=None, generator=None):
    """N(0, 1) samples."""
    return randn(shape, dtype, generator)
