"""Elementwise, reduction and comparison math ops (port of
``paddle_tpu/ops/math.py``).

Raw functions on ``torch.Tensor``s with the JAX functions' semantics,
where torch's differ:

- ``max`` / ``min`` / ``amax`` / ``amin`` split a tie's gradient evenly
  (``torch.amax``; ``torch.max(dim)`` gives it to one index), as do
  ``maximum`` / ``minimum`` and so ``clip`` at either bound;
- ``median`` is the midpoint of the two middle values of a stable sort
  (``torch.median`` returns the lower one);
- ``abs`` has gradient 1 at 0, as ``jnp.abs``;
- integer ``floor_divide`` / ``mod`` by zero give JAX's values (-1 for
  0 // 0, -2 for any other x // 0, x % 0 == 0) where torch raises;
- ``mean`` / ``std`` / ``var`` of integers are float32, ``sum`` /
  ``cumsum`` of int32 stay int32 (the dispatch layer canonicalises
  torch's int64 results).
"""

from __future__ import annotations

import builtins

import torch

from ..core.dtype import convert_dtype
from ._eager import floating, pair, reduce_dims, scalar_like, tensor

_max = builtins.max


# --- binary elementwise -----------------------------------------------------

def add(x, y):
    x, y = pair(x, y)
    return torch.add(x, y)


def subtract(x, y):
    x, y = pair(x, y)
    return torch.subtract(x, y)


def multiply(x, y):
    x, y = pair(x, y)
    return torch.multiply(x, y)


def divide(x, y):
    x, y = pair(x, y)
    return torch.true_divide(x, y)


def _int(t: torch.Tensor) -> bool:
    return not (t.is_floating_point() or t.is_complex())


def floor_divide(x, y):
    x, y = pair(x, y)
    if not (_int(x) and _int(y)):
        return torch.floor_divide(x, y)
    x, y = torch.broadcast_tensors(x, y)
    zero = y == 0
    q = torch.floor_divide(x, torch.where(zero, torch.ones_like(y), y))
    return torch.where(zero, torch.where(x == 0, -1, -2).to(q.dtype), q)


def mod(x, y):
    x, y = pair(x, y)
    if not (_int(x) and _int(y)):
        return torch.remainder(x, y)
    x, y = torch.broadcast_tensors(x, y)
    zero = y == 0
    r = torch.remainder(x, torch.where(zero, torch.ones_like(y), y))
    return torch.where(zero, torch.zeros_like(r), r)


remainder = mod


def pow(x, y):  # noqa: A001 - mirrors the public API name
    if isinstance(x, torch.Tensor) and isinstance(y, (int, float)) and \
            not isinstance(y, bool):
        return torch.pow(x, y)
    x, y = pair(x, y)
    return torch.pow(x, y)


def maximum(x, y):
    x, y = pair(x, y)
    return torch.maximum(x, y)


def minimum(x, y):
    x, y = pair(x, y)
    return torch.minimum(x, y)


def fmax(x, y):
    x, y = pair(x, y)
    return torch.fmax(x, y)


def fmin(x, y):
    x, y = pair(x, y)
    return torch.fmin(x, y)


def atan2(x, y):
    x, y = pair(x, y)
    return torch.atan2(floating(x), floating(y))


def hypot(x, y):
    x, y = pair(x, y)
    return torch.hypot(floating(x), floating(y))


def logaddexp(x, y):
    x, y = pair(x, y)
    return torch.logaddexp(floating(x), floating(y))


def heaviside(x, y):
    x, y = pair(x, y)
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.where(x < 0, torch.zeros((), dtype=dt, device=x.device),
                       torch.where(x > 0, torch.ones((), dtype=dt,
                                                     device=x.device),
                                   y.to(dt)))


def copysign(x, y):
    x, y = pair(x, y)
    return torch.copysign(floating(x), y)


def nextafter(x, y):
    x, y = pair(x, y)
    return torch.nextafter(x, y)


def lcm(x, y):
    x, y = pair(x, y)
    return torch.lcm(x, y)


def gcd(x, y):
    x, y = pair(x, y)
    return torch.gcd(x, y)


# --- unary elementwise ------------------------------------------------------

def abs(x):  # noqa: A001
    if x.is_floating_point():
        return torch.where(x >= 0, x, -x)
    return torch.abs(x)


def neg(x):
    return torch.negative(x)


def exp(x):
    return torch.exp(floating(x))


def expm1(x):
    return torch.expm1(floating(x))


def log(x):
    return torch.log(floating(x))


def log2(x):
    return torch.log2(floating(x))


def log10(x):
    return torch.log10(floating(x))


def log1p(x):
    return torch.log1p(floating(x))


def sqrt(x):
    return torch.sqrt(floating(x))


def rsqrt(x):
    return torch.rsqrt(floating(x))


def square(x):
    return torch.square(x)


def reciprocal(x):
    return torch.reciprocal(x) if not _int(x) else torch.floor_divide(
        torch.ones_like(x), x)


def sin(x):
    return torch.sin(floating(x))


def cos(x):
    return torch.cos(floating(x))


def tan(x):
    return torch.tan(floating(x))


def asin(x):
    return torch.asin(floating(x))


def acos(x):
    return torch.acos(floating(x))


def atan(x):
    return torch.atan(floating(x))


def sinh(x):
    return torch.sinh(floating(x))


def cosh(x):
    return torch.cosh(floating(x))


def tanh(x):
    return torch.tanh(floating(x))


def asinh(x):
    return torch.asinh(floating(x))


def acosh(x):
    return torch.acosh(floating(x))


def atanh(x):
    return torch.atanh(floating(x))


def floor(x):
    return torch.floor(x) if not _int(x) else x


def ceil(x):
    return torch.ceil(x) if not _int(x) else x


def round(x):  # noqa: A001
    return torch.round(x) if not _int(x) else x


def trunc(input):  # noqa: A002 - reference name
    return torch.trunc(input) if not _int(input) else input


def frac(x):
    return x - torch.trunc(x)


def sign(x):
    return torch.sign(x) if not x.is_complex() else torch.sgn(x)


def sgn(x):
    return sign(x)


def erf(x):
    return torch.erf(floating(x))


def erfinv(x):
    return torch.erfinv(floating(x))


def lgamma(x):
    return torch.lgamma(floating(x))


def digamma(x):
    return torch.digamma(floating(x))


def angle(x):
    return torch.angle(floating(x))


def conj(x):
    return torch.conj_physical(x) if x.is_complex() else x


def real(x):
    return torch.real(x) if x.is_complex() else x


def imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def clip(x, min=None, max=None):  # noqa: A002
    """``jnp.clip``: a maximum then a minimum, so a value at a bound
    takes half the gradient, as in JAX."""
    if isinstance(min, torch.Tensor) or min is not None:
        x = torch.maximum(x, min if isinstance(min, torch.Tensor)
                          else scalar_like(min, x))
    if isinstance(max, torch.Tensor) or max is not None:
        x = torch.minimum(x, max if isinstance(max, torch.Tensor)
                          else scalar_like(max, x))
    return x


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None):
    out = x * scale + bias if bias_after_scale else (x + bias) * scale
    if act is not None:
        from .registry import all_ops
        ops = all_ops()
        opdef = ops.get(act) or ops.get(act.replace("_", ""))
        if opdef is None:
            from ..core.enforce import InvalidArgumentError
            raise InvalidArgumentError(
                "scale(): unknown activation %r (not a registered op)"
                % (act,))
        out = opdef.fn(out)
    return out


def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


def lerp(x, y, weight):
    x, y = pair(x, y)
    return x + weight * (y - x)


def rad2deg(x):
    return torch.rad2deg(floating(x))


def deg2rad(x):
    return torch.deg2rad(floating(x))


def exponent(x):
    return torch.frexp(floating(x))[1]


# --- nan handling -----------------------------------------------------------

def isnan(x):
    return torch.isnan(x)


def isinf(x):
    return torch.isinf(x)


def isfinite(x):
    return torch.isfinite(x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def nansum(x, axis=None, keepdim=False):
    return torch.nansum(x, dim=reduce_dims(x, axis), keepdim=keepdim)


def nanmean(x, axis=None, keepdim=False):
    return torch.nanmean(floating(x), dim=reduce_dims(x, axis), keepdim=keepdim)


# --- reductions -------------------------------------------------------------

def sum(x, axis=None, keepdim=False, dtype=None):  # noqa: A001
    dt = None if dtype is None else convert_dtype(dtype)
    if x.dtype == torch.bool and dt is None:
        dt = torch.int32
    return torch.sum(x, dim=reduce_dims(x, axis), keepdim=keepdim, dtype=dt)


def mean(x, axis=None, keepdim=False):
    return torch.mean(floating(x), dim=reduce_dims(x, axis), keepdim=keepdim)


def _amax(x, axis, keepdim):
    if x.dim() == 0:
        return x.clone()
    return torch.amax(x, dim=reduce_dims(x, axis), keepdim=keepdim)


def _amin(x, axis, keepdim):
    if x.dim() == 0:
        return x.clone()
    return torch.amin(x, dim=reduce_dims(x, axis), keepdim=keepdim)


def max(x, axis=None, keepdim=False):  # noqa: A001
    return _amax(x, axis, keepdim)


def min(x, axis=None, keepdim=False):  # noqa: A001
    return _amin(x, axis, keepdim)


def amax(x, axis=None, keepdim=False):
    return _amax(x, axis, keepdim)


def amin(x, axis=None, keepdim=False):
    return _amin(x, axis, keepdim)


def prod(x, axis=None, keepdim=False, dtype=None):
    dt = None if dtype is None else convert_dtype(dtype)
    out = x if dt is None else x.to(dt)
    for d in sorted((a % _max(x.dim(), 1) for a in reduce_dims(x, axis)),
                    reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out


def logsumexp(x, axis=None, keepdim=False):
    return torch.logsumexp(floating(x), dim=reduce_dims(x, axis),
                           keepdim=keepdim)


def all(x, axis=None, keepdim=False):  # noqa: A001
    return torch.all(x.bool(), dim=reduce_dims(x, axis), keepdim=keepdim)


def any(x, axis=None, keepdim=False):  # noqa: A001
    return torch.any(x.bool(), dim=reduce_dims(x, axis), keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False):
    return torch.std(floating(x), dim=reduce_dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False):
    return torch.var(floating(x), dim=reduce_dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _moved_flat(x, axis):
    """``x`` with the reduced axes moved last and flattened into one:
    (tensor, keepdim shape)."""
    dims = tuple(a % _max(x.dim(), 1) for a in reduce_dims(x, axis))
    keep = [1 if i in dims else s for i, s in enumerate(x.shape)]
    rest = [i for i in range(x.dim()) if i not in dims]
    moved = x.permute(*rest, *dims) if x.dim() else x.reshape(1)
    flat = moved.reshape(*[x.shape[i] for i in rest], -1)
    return flat, keep


def median(x, axis=None, keepdim=False):
    """The midpoint of the two middle values of a stable sort (one
    value for an odd count), as ``jnp.median``."""
    flat, keep = _moved_flat(floating(x), axis)
    n = flat.shape[-1]
    s = torch.sort(flat, dim=-1, stable=True).values
    out = (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5
    if torch.isnan(flat).any():
        out = torch.where(torch.isnan(flat).any(-1),
                          torch.full_like(out, float("nan")), out)
    return out.reshape(keep) if keepdim else out


def quantile(x, q, axis=None, keepdim=False):
    flat, keep = _moved_flat(floating(x), axis)
    qt = torch.as_tensor(q, dtype=flat.dtype, device=flat.device)
    out = torch.quantile(flat, qt, dim=-1)
    if keepdim:
        out = out.reshape(*qt.shape, *keep)
    return out


def count_nonzero(x, axis=None, keepdim=False):
    return torch.sum(x != 0, dim=reduce_dims(x, axis), keepdim=keepdim,
                     dtype=torch.int32)


# --- cumulative -------------------------------------------------------------

def cumsum(x, axis=None, dtype=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    dt = None if dtype is None else convert_dtype(dtype)
    return torch.cumsum(x, dim=int(axis), dtype=dt)


def cumprod(x, dim=None, dtype=None):
    if dim is None:
        x, dim = x.reshape(-1), 0
    dt = None if dtype is None else convert_dtype(dtype)
    return torch.cumprod(x, dim=int(dim), dtype=dt)


def _cum_index(x, vals, axis):
    """The JAX functions' index output: along ``axis``, the last
    position where ``x`` equals the running value (the axis reduced)."""
    ar = torch.arange(x.shape[axis], device=x.device).reshape(
        [-1 if i == axis % x.dim() else 1 for i in range(x.dim())])
    return torch.argmax(torch.where(x == vals, ar, -1), dim=axis)


def cummax(x, axis=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    vals = torch.cummax(x, dim=axis).values
    return vals, _cum_index(x, vals, axis)


def cummin(x, axis=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    vals = torch.cummin(x, dim=axis).values
    return vals, _cum_index(x, vals, axis)


def logcumsumexp(x, axis=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(floating(x), dim=axis)


# --- comparison -------------------------------------------------------------

def equal(x, y):
    x, y = pair(x, y)
    return torch.eq(x, y)


def not_equal(x, y):
    x, y = pair(x, y)
    return torch.ne(x, y)


def greater_than(x, y):
    x, y = pair(x, y)
    return torch.gt(x, y)


def greater_equal(x, y):
    x, y = pair(x, y)
    return torch.ge(x, y)


def less_than(x, y):
    x, y = pair(x, y)
    return torch.lt(x, y)


def less_equal(x, y):
    x, y = pair(x, y)
    return torch.le(x, y)


def equal_all(x, y):
    x, y = pair(x, y)
    same = x.shape == y.shape and bool(torch.equal(x, y.to(x.dtype)))
    return torch.tensor(same, device=x.device)


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    x, y = pair(x, y)
    return torch.all(torch.isclose(x, y, rtol=rtol, atol=atol,
                                   equal_nan=equal_nan))


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    x, y = pair(x, y)
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


# --- logical / bitwise ------------------------------------------------------

def logical_and(x, y):
    x, y = pair(x, y)
    return torch.logical_and(x, y)


def logical_or(x, y):
    x, y = pair(x, y)
    return torch.logical_or(x, y)


def logical_xor(x, y):
    x, y = pair(x, y)
    return torch.logical_xor(x, y)


def logical_not(x):
    return torch.logical_not(x)


def bitwise_and(x, y):
    x, y = pair(x, y)
    return torch.bitwise_and(x, y)


def bitwise_or(x, y):
    x, y = pair(x, y)
    return torch.bitwise_or(x, y)


def bitwise_xor(x, y):
    x, y = pair(x, y)
    return torch.bitwise_xor(x, y)


def bitwise_not(x):
    return torch.bitwise_not(x)


def left_shift(x, y):
    x, y = pair(x, y)
    return torch.bitwise_left_shift(x, y)


def right_shift(x, y):
    x, y = pair(x, y)
    return torch.bitwise_right_shift(x, y)


# --- matmul family ----------------------------------------------------------

def matmul(x, y, transpose_x=False, transpose_y=False):
    x, y = pair(x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def dot(x, y):
    x, y = pair(x, y)
    if x.dim() == 1:
        return torch.sum(x * y)
    return torch.sum(x * y, dim=-1)


def mm(input, mat2):  # noqa: A002 - reference names
    return torch.matmul(input, mat2)


def bmm(x, y):
    return torch.matmul(x, y)


def addmm(input, x, y, beta=1.0, alpha=1.0):  # noqa: A002
    return beta * input + alpha * torch.matmul(x, y)


def inner(x, y):
    x, y = pair(x, y)
    return torch.inner(x, y)


def outer(x, y):
    x, y = pair(x, y)
    return torch.outer(x.reshape(-1), y.reshape(-1))


def kron(x, y):
    x, y = pair(x, y)
    return torch.kron(x, y)


def cross(x, y, axis=-1):
    x, y = pair(x, y)
    return torch.linalg.cross(x, y, dim=axis)


def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)


def multiply_sum(x, y, axis=None):
    x, y = pair(x, y)
    p = x * y
    return torch.sum(p, dim=reduce_dims(p, axis))


def diff(x, n=1, axis=-1):
    return torch.diff(x, n=n, dim=axis)


def histogram(input, bins=100, min=0, max=0):  # noqa: A002
    x = floating(input).detach()
    if min == 0 and max == 0:
        lo, hi = float(x.min()), float(x.max())
    else:
        lo, hi = float(min), float(max)
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    return torch.histc(x.float(), bins=int(bins), min=lo, max=hi).to(
        torch.float32)


def add_n(inputs):
    """Sum a list of same-shaped tensors."""
    if not isinstance(inputs, (list, tuple)):
        return tensor(inputs)
    out = tensor(inputs[0])
    for t in inputs[1:]:
        out = out + tensor(t, out.device)
    return out


def floor_mod(x, y):
    """Alias of mod."""
    return mod(x, y)


def broadcast_shape(x_shape, y_shape):
    """The broadcast shape of two shapes, as a list (host)."""
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))
