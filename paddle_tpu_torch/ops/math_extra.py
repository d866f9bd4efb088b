"""The long tail of math, linalg and manipulation ops (port of
``paddle_tpu/ops/math_extra.py``): frexp / ldexp, trapezoids, strided
views, masked scatter, LU unpacking, pairwise distances and the rest.

Raw functions on ``torch.Tensor``s with the JAX functions' formulas
(``cdist``, ``renorm``, ``diag_embed``, ``as_strided`` and
``masked_scatter`` are written as JAX writes them, so values and
gradients follow the same arithmetic). ``float_power`` computes in
float32, as the JAX package does in x32 mode.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ._eager import floating, long, pair, tensor


# --- elementwise / numeric utilities ----------------------------------------

def frexp(x):
    m, e = torch.frexp(floating(x))
    return m, e.to(torch.int32)


def ldexp(x, y):
    x, y = pair(x, y)
    return floating(x) * torch.pow(2.0, y.to(torch.int32).to(
        floating(x).dtype))


def renorm(x, p, axis, max_norm):
    """Clamp the p-norm of every sub-tensor along ``axis`` to max_norm."""
    ax = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    norms = torch.sum(torch.abs(x) ** p, dim=ax, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return x * factor


def trapezoid(y, x=None, dx=None, axis=-1):
    if x is not None:
        return torch.trapezoid(y, tensor(x, y.device), dim=int(axis))
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=int(axis))


def _slice_axis(a, axis, start, stop):
    idx = [slice(None)] * a.dim()
    idx[axis % a.dim()] = slice(start, stop)
    return a[tuple(idx)]


def cumulative_trapezoid(y, x=None, dx=None, axis=-1):
    y1 = _slice_axis(y, axis, 1, None)
    y0 = _slice_axis(y, axis, 0, -1)
    if x is not None:
        x = tensor(x, y.device)
        d = _slice_axis(x, axis, 1, None) - _slice_axis(x, axis, 0, -1)
    else:
        d = 1.0 if dx is None else dx
    return torch.cumsum(d * (y0 + y1) / 2.0, dim=int(axis))


def vander(x, n=None, increasing=False):
    n = x.shape[0] if n is None else int(n)
    powers = torch.arange(n, dtype=x.dtype, device=x.device)
    if not increasing:
        powers = powers.flip(0)
    return torch.pow(x[:, None], powers)


def nanmedian(x, axis=None, keepdim=False):
    return nanquantile(x, 0.5, axis, keepdim)


def nanquantile(x, q, axis=None, keepdim=False):
    from .math import _moved_flat
    flat, keep = _moved_flat(floating(x), axis)
    qt = torch.as_tensor(q, dtype=flat.dtype, device=flat.device)
    out = torch.nanquantile(flat, qt, dim=-1)
    if keepdim:
        out = out.reshape(*qt.shape, *keep)
    return out


# --- combinatorics ----------------------------------------------------------

def cartesian_prod(xs):
    """List of 1-D tensors -> [prod(len), k] cartesian product."""
    dev = xs[0].device if isinstance(xs[0], torch.Tensor) else None
    grids = torch.meshgrid(*[tensor(v, dev) for v in xs], indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


def combinations(x, r=2, with_replacement=False):
    """All r-combinations of a 1-D tensor's elements, as [C, r]."""
    n = x.shape[0]
    gen = itertools.combinations_with_replacement if with_replacement \
        else itertools.combinations
    idx = np.array(list(gen(range(n), r)), dtype=np.int64)
    if idx.size == 0:
        return torch.zeros((0, r), dtype=x.dtype, device=x.device)
    return x[torch.from_numpy(idx).to(x.device)]


# --- indexing / views -------------------------------------------------------

def index_fill(x, index, axis, value):
    return torch.index_fill(x, int(axis), long(index, x.device).reshape(-1),
                            value)


def masked_scatter(x, mask, value):
    """Fill the True positions of ``mask`` with consecutive elements of
    ``value`` (row-major)."""
    m = torch.broadcast_to(tensor(mask, x.device).bool(), x.shape)
    pos = torch.cumsum(m.reshape(-1).long(), 0) - 1
    src = value.reshape(-1)
    gathered = src[torch.clamp(pos, 0, src.shape[0] - 1)].reshape(x.shape)
    return torch.where(m, gathered.to(x.dtype), x)


def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    """Batch of vectors -> batch of diagonal matrices."""
    n = x.shape[-1] + abs(offset)
    base = torch.zeros(*x.shape[:-1], n, n, dtype=x.dtype, device=x.device)
    rng = torch.arange(x.shape[-1], device=x.device)
    r = rng + max(-offset, 0)
    c = rng + max(offset, 0)
    out = base.clone()
    out[..., r, c] = x
    nd = out.dim()
    d1, d2 = dim1 % nd, dim2 % nd
    if (d1, d2) != (nd - 2, nd - 1):
        perm = [i for i in range(nd) if i not in (nd - 2, nd - 1)]
        for dest, src in sorted([(d1, nd - 2), (d2, nd - 1)]):
            perm.insert(dest, src)
        out = out.permute(*perm)
    return out


def unflatten(x, axis, shape):
    axis = axis % x.dim()
    return x.reshape(*x.shape[:axis], *[int(s) for s in shape],
                     *x.shape[axis + 1:])


def view_as(x, other):
    return x.reshape(other.shape)


def as_strided(x, shape, stride, offset=0):
    """A strided view by gather over the flattened tensor."""
    flat = x.reshape(-1)
    idx = torch.as_tensor(int(offset), device=x.device)
    for s, st in zip(shape, stride):
        idx = idx[..., None] + torch.arange(int(s), device=x.device) * int(st)
    return flat[idx.reshape(-1)].reshape([int(s) for s in shape])


# --- counting ---------------------------------------------------------------

def bincount(x, weights=None, minlength=0):
    """Data-dependent length: ``max(x) + 1`` or ``minlength``."""
    flat = x.reshape(-1).long()
    w = None if weights is None else tensor(weights, x.device).reshape(-1)
    out = torch.bincount(flat, weights=w, minlength=int(minlength))
    return out if w is None else out.to(w.dtype)


# --- linalg tail ------------------------------------------------------------

def lu_unpack(lu_data, pivots, unpack_ludata=True, unpack_pivots=True):
    """(LU, pivots) -> (P, L, U); ``pivots`` are 1-based sequential row
    swaps as ``lu()`` returns them."""
    m, n = lu_data.shape[-2], lu_data.shape[-1]
    k = min(m, n)
    L = U = P = None
    if unpack_ludata:
        L = torch.tril(lu_data[..., :, :k], -1) + torch.eye(
            m, k, dtype=lu_data.dtype, device=lu_data.device)
        U = torch.triu(lu_data[..., :k, :])
    if unpack_pivots:
        piv = long(pivots, lu_data.device) - 1
        perm = torch.arange(m, device=lu_data.device).expand(
            *piv.shape[:-1], m).clone()
        for i in range(piv.shape[-1]):
            pi = piv[..., i:i + 1]
            a = perm[..., i:i + 1].clone()
            b = torch.take_along_dim(perm, pi, dim=-1)
            perm = perm.scatter(-1, torch.full_like(pi, i), b)
            perm = perm.scatter(-1, pi, a)
        P = torch.nn.functional.one_hot(perm, m).to(lu_data.dtype)
        P = P.transpose(-1, -2)
    return P, L, U


def cdist(x, y, p=2.0):
    """Pairwise p-distance between row sets: [..., M, D] x [..., N, D]
    -> [..., M, N]."""
    diff = torch.abs(x[..., :, None, :] - y[..., None, :, :])
    if p == float("inf"):
        return torch.amax(diff, dim=-1)
    if p == 0:
        return torch.sum((diff != 0).to(x.dtype), dim=-1)
    return torch.sum(diff ** p, dim=-1) ** (1.0 / p)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    d = torch.abs(x - y) + epsilon
    if p == float("inf"):
        return torch.amax(d, dim=-1, keepdim=keepdim)
    return torch.sum(d ** p, dim=-1, keepdim=keepdim) ** (1.0 / p)


# --- complex construction ---------------------------------------------------

def complex(real, imag):  # noqa: A001 - mirrors the public API name
    real, imag = pair(real, imag)
    return torch.complex(floating(real), floating(imag))


def polar(abs, angle):  # noqa: A002 - mirrors the public API name
    return torch.polar(abs, angle)


# --- tensor-API tail --------------------------------------------------------

def take(x, index, mode="raise"):
    """Flattened-index gather; ``raise`` clamps as the JAX function does
    (it cannot raise under jit)."""
    if mode not in ("raise", "wrap", "clip"):
        raise ValueError(f"take mode must be raise/wrap/clip, got {mode!r}")
    flat = x.reshape(-1)
    n = flat.shape[0]
    idx = long(index, x.device)
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    elif mode == "clip":
        idx = torch.clamp(idx, 0, n - 1)
    else:
        idx = torch.clamp(idx, -n, n - 1)
    return flat[idx]


def logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def polygamma(x, n):
    return torch.polygamma(int(n), floating(x))


def i0(x):
    return torch.special.i0(floating(x))


def i0e(x):
    return torch.special.i0e(floating(x))


def i1(x):
    return torch.special.i1(floating(x))


def i1e(x):
    return torch.special.i1e(floating(x))


def digitize(x, bins, right=False):
    return torch.bucketize(x, tensor(bins, x.device), right=not right,
                           out_int32=True)


def tensordot(x, y, axes=2):  # noqa: A002 - reference name
    if isinstance(axes, (list, tuple)):
        axes = [list(a) if isinstance(a, (list, tuple)) else [a]
                for a in axes]
    return torch.tensordot(x, y, dims=axes)


def tensor_split(x, num_or_indices, axis=0):
    if isinstance(num_or_indices, (int, np.integer)):
        return list(torch.tensor_split(x, int(num_or_indices), dim=axis))
    return list(torch.tensor_split(x, [int(i) for i in num_or_indices],
                                   dim=axis))


def hsplit(x, num_or_indices):
    return tensor_split(x, num_or_indices, axis=1 if x.dim() > 1 else 0)


def vsplit(x, num_or_indices):
    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices):
    return tensor_split(x, num_or_indices, axis=2)


def _atleast(fn, xs):
    out = fn(*[tensor(v) for v in xs])
    return list(out) if isinstance(out, tuple) else out


def atleast_1d(*xs):
    return _atleast(torch.atleast_1d, xs)


def atleast_2d(*xs):
    return _atleast(torch.atleast_2d, xs)


def atleast_3d(*xs):
    return _atleast(torch.atleast_3d, xs)


def block_diag(xs):
    return torch.block_diag(*xs)


def float_power(x, y):
    x, y = pair(x, y)
    return torch.pow(floating(x), floating(y))


def addcmul(x, tensor1, tensor2, value=1.0):
    return x + value * tensor1 * tensor2


def addcdiv(x, tensor1, tensor2, value=1.0):
    return x + value * tensor1 / tensor2


def bitwise_left_shift(x, y):
    x, y = pair(x, y)
    return torch.bitwise_left_shift(x, y)


def bitwise_right_shift(x, y):
    x, y = pair(x, y)
    return torch.bitwise_right_shift(x, y)


def is_complex(x):
    return bool(tensor(x).is_complex())


def is_floating_point(x):
    return bool(tensor(x).is_floating_point())


def rank(x):
    return tensor(x).dim()
