"""Tensor creation ops (port of ``paddle_tpu/ops/creation.py``).

Raw functions on ``torch.Tensor``s; the eager ``Tensor`` layer is
``dispatch.py``. Ops with no tensor input create on the expected place
(``core/place.py``: the card unless ``set_device`` names another). As in
the JAX package, ``empty`` is zero-filled and a float op with no dtype
takes the default dtype.
"""

from __future__ import annotations

import torch

from ..core.dtype import convert_dtype, default_dtype
from ._eager import device_of, dtype_or, shape_arg, tensor


def _dev():
    return device_of()


def to_array(data, dtype=None):
    return tensor(data, dtype=dtype) if isinstance(data, torch.Tensor) \
        else tensor(data, _dev(), dtype)


def zeros(shape, dtype=None):
    return torch.zeros(shape_arg(shape), dtype=dtype_or(dtype),
                       device=_dev())


def ones(shape, dtype=None):
    return torch.ones(shape_arg(shape), dtype=dtype_or(dtype),
                      device=_dev())


def full(shape, fill_value, dtype=None):
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    return torch.full(shape_arg(shape), fill_value, dtype=dtype_or(dtype),
                      device=_dev())


def zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=dtype_or(dtype, x))


def ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=dtype_or(dtype, x))


def full_like(x, fill_value, dtype=None):
    return torch.full_like(x, fill_value, dtype=dtype_or(dtype, x))


def empty(shape, dtype=None):
    return zeros(shape, dtype)


def empty_like(x, dtype=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None):
    if end is None:
        start, end = 0, start
    vals = [v.item() if isinstance(v, torch.Tensor) else v
            for v in (start, end, step)]
    if dtype is None:
        dtype = default_dtype() if any(isinstance(v, float)
                                       for v in vals) else torch.int32
    return torch.arange(*vals, dtype=convert_dtype(dtype), device=_dev())


def linspace(start, stop, num, dtype=None):
    return torch.linspace(float(start), float(stop), int(num),
                          dtype=dtype_or(dtype), device=_dev())


def logspace(start, stop, num, base=10.0, dtype=None):
    return torch.logspace(float(start), float(stop), int(num),
                          base=float(base), dtype=dtype_or(dtype),
                          device=_dev())


def eye(num_rows, num_columns=None, dtype=None):
    return torch.eye(int(num_rows), int(num_columns if num_columns
                                        is not None else num_rows),
                     dtype=dtype_or(dtype), device=_dev())


def diag(x, offset=0, padding_value=0):
    x = tensor(x)
    if x.dim() == 1 and padding_value != 0:
        # the JAX function's arithmetic, rounding included
        n = x.shape[0] + abs(offset)
        base = torch.full((n, n), padding_value, dtype=x.dtype,
                          device=x.device)
        return base + torch.diag(x - 0, offset) - torch.diag(
            torch.full_like(x, padding_value), offset)
    return torch.diag(x, offset)


def diagflat(x, offset=0):
    return torch.diagflat(x, offset)


def tril(x, diagonal=0):
    return torch.tril(x, diagonal)


def triu(x, diagonal=0):
    return torch.triu(x, diagonal)


def meshgrid(*arrays, indexing="ij"):
    arrays = arrays[0] if len(arrays) == 1 and isinstance(
        arrays[0], (list, tuple)) else arrays
    dev = device_of(*arrays)
    return list(torch.meshgrid(*[tensor(a, dev) for a in arrays],
                               indexing=indexing))


def assign(x, output=None):
    return tensor(x).clone()


def clone(x):
    return x.clone()


def tril_indices(row, col=None, offset=0):
    col = row if col is None else col
    return torch.tril_indices(int(row), int(col), int(offset),
                              device=_dev()).to(torch.int32)


def triu_indices(row, col=None, offset=0):
    col = row if col is None else col
    return torch.triu_indices(int(row), int(col), int(offset),
                              device=_dev()).to(torch.int32)


def complex_(real, imag):
    real = tensor(real)
    imag = tensor(imag, real.device)
    dt = torch.promote_types(torch.promote_types(real.dtype, imag.dtype),
                             torch.float32)
    return torch.complex(real.to(dt), imag.to(dt))
