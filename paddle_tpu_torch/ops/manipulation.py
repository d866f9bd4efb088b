"""Shape and layout ops (port of ``paddle_tpu/ops/manipulation.py``).

Raw functions on ``torch.Tensor``s with the JAX functions' semantics,
where torch's differ: ``split(num_or_sections)`` counts sections (a
torch int is a chunk size), ``gather(index, axis)`` takes whole slices
along ``axis`` (``jnp.take``; torch's gather is elementwise), ``scatter``
with duplicate indices keeps the last update and gives only it a
gradient (``.at[].set``), ``expand`` keeps a dim for ``-1``, and the
index outputs are int32. Indices go to torch's gathers and scatters as
int64. ``pad`` and ``one_hot`` are ``nn_functional``'s (the same
semantics); the dynamic-shape ops (``nonzero``, ``masked_select``,
``unique``, ...) run on the tensor's own device.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.dtype import convert_dtype
from ._eager import axes, device_of, long, pair, shape_arg, tensor

_slice = builtins.slice


def reshape(x, shape):
    return torch.reshape(x, shape_arg(shape))


def transpose(x, perm):
    return x.permute(*[int(p) for p in perm])


def t(input):  # noqa: A002
    return input.permute(*reversed(range(input.dim())))


def moveaxis(x, source, destination):
    return torch.movedim(x, axes(source), axes(destination))


def swapaxes(x, axis1, axis2):
    return torch.swapaxes(x, int(axis1), int(axis2))


def _tensors(xs):
    dev = device_of(*xs)
    return [tensor(x, dev) for x in xs]


def concat(xs, axis=0):
    return torch.cat(_tensors(list(xs)), dim=int(axis))


def stack(x, axis=0):
    return torch.stack(_tensors(list(x)), dim=int(axis))


def unstack(x, axis=0, num=None):
    return list(torch.unbind(x, dim=int(axis)))


def unbind(input, axis=0):  # noqa: A002 - reference name
    return unstack(input, axis=axis)


def split(x, num_or_sections, axis=0):
    """An int is a count of equal sections (it must divide the dim);
    a list gives each section's size, one ``-1`` for the rest."""
    axis = int(axis)
    n = x.shape[axis]
    if isinstance(num_or_sections, (int, np.integer)):
        if n % int(num_or_sections):
            raise ValueError(f"split: {n} does not divide into "
                             f"{num_or_sections} equal sections")
        return list(torch.split(x, n // int(num_or_sections), dim=axis))
    sections = [int(s) for s in num_or_sections]
    if -1 in sections:
        known = builtins.sum(s for s in sections if s != -1)
        sections[sections.index(-1)] = n - known
    return list(torch.split(x, sections, dim=axis))


def chunk(x, chunks, axis=0):
    return list(torch.tensor_split(x, int(chunks), dim=int(axis)))


def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    ax = axes(axis)
    return torch.squeeze(x, dim=ax)


def unsqueeze(x, axis):
    ax = axes(axis)
    if isinstance(ax, tuple):
        for a in sorted(ax):
            x = torch.unsqueeze(x, a)
        return x
    return torch.unsqueeze(x, ax)


def flatten(x, start_axis=0, stop_axis=-1):
    nd = x.dim()
    if nd == 0:
        return x.reshape(-1)
    start, stop = start_axis % nd, stop_axis % nd
    return x.reshape(*x.shape[:start], -1, *x.shape[stop + 1:])


def ravel(x):
    return x.reshape(-1)


def expand(x, shape):
    shape = shape_arg(shape)
    lead = len(shape) - x.dim()
    shape = tuple(x.shape[i - lead] if s == -1 else s
                  for i, s in enumerate(shape))
    return torch.broadcast_to(x, shape)


def broadcast_to(x, shape):
    return torch.broadcast_to(x, shape_arg(shape))


def broadcast_tensors(inputs):
    return list(torch.broadcast_tensors(*_tensors(list(inputs))))


def expand_as(x, y):
    return torch.broadcast_to(x, y.shape)


def tile(x, repeat_times):
    return torch.tile(x, shape_arg(repeat_times))


def repeat_interleave(x, repeats, axis=None):
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.long()
    return torch.repeat_interleave(x, repeats, dim=axis)


def flip(x, axis):
    ax = axes(axis)
    return torch.flip(x, dims=ax if isinstance(ax, tuple) else (ax,))


def roll(x, shifts, axis=None):
    ax = axes(axis)
    sh = axes(shifts)
    if ax is None:
        return torch.roll(x, sh)
    return torch.roll(x, sh, ax)


def rot90(x, k=1, axes=(0, 1)):  # noqa: A002 - reference name
    return torch.rot90(x, int(k), [int(a) for a in axes])


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):  # noqa: A002
    from .nn_functional import pad as _pad
    return _pad(x, pad, mode=mode, value=value, data_format=data_format)


def gather(x, index, axis=0):
    """``jnp.take(x, index, axis)``: the slices of ``x`` along ``axis``
    at ``index`` (any shape)."""
    axis = int(axis) % x.dim()
    idx = long(index, x.device)
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(*x.shape[:axis], *idx.shape, *x.shape[axis + 1:])


def index_select(x, index, axis=0):
    return gather(x, index, axis)


def take_along_axis(x, indices, axis):
    return torch.take_along_dim(x, long(indices, x.device), dim=int(axis))


def put_along_axis(x, indices, values, axis, reduce="assign"):  # noqa: A002
    idx = long(indices, x.device)
    axis = int(axis)
    vals = torch.broadcast_to(tensor(values, x.device).to(x.dtype),
                              idx.shape)
    if reduce == "assign":
        return torch.scatter(x, axis, idx, vals)
    op = {"add": "add", "multiply": "multiply", "mul": "multiply"}[reduce]
    base = torch.zeros_like(x) if op == "add" else torch.ones_like(x)
    y = torch.scatter(base, axis, idx, vals)
    return x + y if op == "add" else x * y


def gather_nd(x, index):
    idx = long(index, x.device)
    return x[tuple(torch.movedim(idx, -1, 0))]


def _last_of_duplicates(index: torch.Tensor) -> torch.Tensor:
    """A mask of the entries of a 1-D index that no later entry
    repeats (the update a ``.at[].set`` keeps)."""
    n = index.numel()
    pos = torch.arange(n, device=index.device)
    size = int(index.max()) + 1 if n else 1
    last = torch.full((size,), -1, dtype=torch.long, device=index.device)
    last = last.scatter_reduce(0, index, pos, reduce="amax")
    return last[index] == pos


def scatter(x, index, updates, overwrite=True):
    """Row scatter: ``index`` selects rows of ``x``. Overwrite keeps the
    last of duplicate rows (and only it takes a gradient); otherwise the
    rows are zeroed, then every update added."""
    idx = long(index, x.device)
    if idx.dim() == 2:
        idx = idx[:, 0]
    updates = tensor(updates, x.device).to(x.dtype)
    if overwrite:
        keep = _last_of_duplicates(idx)
        return x.index_put((idx[keep],), updates[keep])
    zeroed = x.index_put((idx,), torch.zeros_like(updates))
    return zeroed.index_put((idx,), updates, accumulate=True)


def scatter_nd_add(x, index, updates):
    idx = long(index, x.device)
    return x.index_put(tuple(torch.movedim(idx, -1, 0)),
                       tensor(updates, x.device).to(x.dtype),
                       accumulate=True)


def scatter_nd(index, updates, shape):
    updates = tensor(updates)
    return scatter_nd_add(torch.zeros(shape_arg(shape), dtype=updates.dtype,
                                      device=updates.device), index, updates)


def index_add(x, index, axis, value):
    return torch.index_add(x, int(axis), long(index, x.device),
                           tensor(value, x.device).to(x.dtype))


def index_put(x, indices, value, accumulate=False):
    idx = tuple(long(i, x.device) for i in indices)
    return x.index_put(idx, tensor(value, x.device).to(x.dtype),
                       accumulate=bool(accumulate))


def slice(input, axes, starts, ends):  # noqa: A001,A002
    """Static slice."""
    idx = [_slice(None)] * input.dim()
    for ax, s, e in zip(axes, starts, ends):
        idx[int(ax)] = _slice(int(s), int(e))
    return input[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides):
    """Python slicing per axis, negative strides included."""
    out = x
    for ax, s, e, st in zip(axes, starts, ends, strides):
        ax = int(ax)
        rng = range(*_slice(int(s), int(e), int(st)).indices(x.shape[ax]))
        out = torch.index_select(out, ax, torch.tensor(
            list(rng), dtype=torch.long, device=x.device))
    return out


def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    cond = tensor(condition).bool()
    x, y = pair(x, y)
    return torch.where(cond, x, y)


def nonzero(x, as_tuple=False):
    """Data-dependent shape: the indices of the nonzero entries, int32."""
    res = torch.nonzero(x).to(torch.int32)
    if as_tuple:
        return tuple(res[:, i] for i in range(res.shape[1]))
    return res


def masked_select(x, mask):
    mask = tensor(mask, x.device).bool()
    if mask.shape != x.shape:
        return torch.masked_select(x, mask)
    return x[mask]


def masked_fill(x, mask, value):
    value = value if isinstance(value, torch.Tensor) else torch.full(
        (), value, dtype=x.dtype, device=x.device)
    return torch.where(tensor(mask, x.device).bool(), value.to(x.dtype), x)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64"):
    """Sorted unique values (numpy's ``unique``) and, on request, the
    first index of each, the inverse and the counts, in ``dtype``."""
    idx_dt = convert_dtype(dtype)
    vals, inv, cnt = torch.unique(x, sorted=True, return_inverse=True,
                                  return_counts=True, dim=axis)
    if not (return_index or return_inverse or return_counts):
        return vals
    out = [vals]
    if return_index:
        flat_inv = inv.reshape(-1)
        n = flat_inv.numel()
        first = torch.full((vals.shape[0] if axis is not None
                            else vals.numel(),), n, dtype=torch.long,
                           device=x.device)
        first = first.scatter_reduce(0, flat_inv, torch.arange(
            n, device=x.device), reduce="amin")
        out.append(first.to(idx_dt))
    if return_inverse:
        out.append(inv.to(idx_dt))
    if return_counts:
        out.append(cnt.to(idx_dt))
    return tuple(out)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    """Runs of equal values collapsed (flattened unless ``axis``, which
    returns the values alone, as the JAX function does)."""
    if axis is not None:
        return torch.unique_consecutive(x, dim=int(axis))
    res = torch.unique_consecutive(x.reshape(-1),
                                   return_inverse=return_inverse,
                                   return_counts=return_counts)
    if not isinstance(res, tuple):
        return res
    return tuple(r if i == 0 else r.to(torch.int32)
                 for i, r in enumerate(res))


def one_hot(x, num_classes):
    from .nn_functional import one_hot as _one_hot
    return _one_hot(x, num_classes)


def cast(x, dtype):
    return tensor(x).to(convert_dtype(dtype))


def numel(x):
    return torch.tensor(x.numel(), dtype=torch.int32, device=x.device)


def shard_index(input, index_num, nshards, shard_id,  # noqa: A002
                ignore_value=-1):
    """Map global ids to shard-local ids (``ignore_value`` off-shard)."""
    shard_size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(input, shard_size, rounding_mode="floor") == \
        shard_id
    return torch.where(in_shard, torch.remainder(input, shard_size),
                       torch.full_like(input, ignore_value))


def as_real(x):
    return torch.view_as_real(x).clone()


def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


def view(x, shape):
    return torch.reshape(x, shape_arg(shape))


def crop(x, shape, offsets=None):
    offsets = offsets or [0] * x.dim()
    idx = tuple(_slice(int(o), int(o) + int(s))
                for o, s in zip(offsets, shape))
    return x[idx]


def reverse(x, axis):
    """Reverse ``x`` along the given axis or axes."""
    ax = axes(axis)
    return torch.flip(x, dims=ax if isinstance(ax, tuple) else (ax,))


def shape(x):
    """The shape as an int32 tensor."""
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


def is_empty(x):
    return torch.tensor(x.numel() == 0, device=x.device)
