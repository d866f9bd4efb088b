"""Argument helpers shared by the eager op modules (``creation.py``,
``math.py``, ``manipulation.py``, ``search.py``, ``random.py``,
``math_extra.py``).

The op functions take ``torch.Tensor``s, Python numbers, lists and
numpy arrays, as the JAX package's take jax arrays and numbers; these
helpers turn the non-tensors into tensors on the device of the tensors
beside them (the expected place when there is none), with the JAX
package's x32 dtypes and its weak typing of Python scalars (an int32
tensor times 2.5 is float32, a bf16 tensor plus 1.0 stays bf16).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.dtype import convert_dtype, default_dtype


def device_of(*xs) -> torch.device:
    """The device of the first tensor among ``xs`` (lists searched one
    level down), else the expected place."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
        if isinstance(x, (list, tuple)):
            for y in x:
                if isinstance(y, torch.Tensor):
                    return y.device
    from ..core.place import expected_device
    return expected_device()


def host(x) -> np.ndarray:
    """``x`` as a numpy array for a host-side op: a tensor, on any
    device, is copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor (a tensor stays itself, cast to ``dtype`` when
    given)."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(convert_dtype(dtype))
    from ..tensor import to_value
    return to_value(x, dtype, device if device is not None else
                    device_of(x))


def scalar_like(s, t: torch.Tensor) -> torch.Tensor:
    """A Python number beside tensor ``t`` as a 0-d tensor of the dtype
    the pair promotes to (a weak scalar)."""
    return torch.full((), s, dtype=torch.result_type(t, s),
                      device=t.device)


def pair(x, y):
    """Two operands as tensors: a Python number takes the other side's
    weak promotion, anything else becomes a tensor beside it."""
    xt, yt = isinstance(x, torch.Tensor), isinstance(y, torch.Tensor)
    if xt and yt:
        return x, y
    if xt:
        return x, _other(y, x)
    if yt:
        return _other(x, y), y
    dev = device_of(x, y)
    x = tensor(x, dev)
    return x, _other(y, x)


def _other(v, t: torch.Tensor) -> torch.Tensor:
    if isinstance(v, (bool, int, float, complex, np.number)) and not \
            isinstance(v, np.ndarray):
        return scalar_like(v.item() if isinstance(v, np.number) else v, t)
    return tensor(v, t.device)


def axes(axis):
    """An axis argument as torch takes it: None, an int, or a tuple."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def shape_arg(shape):
    """A shape argument (an int, a list / tuple of ints or 0-d tensors,
    or a tensor) as a tuple of ints."""
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def long(idx, device=None) -> torch.Tensor:
    """An index as an int64 tensor (torch's gathers and scatters take
    int64; the port's index tensors are int32, as JAX's)."""
    return tensor(idx, device).long()


def floating(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the default floating dtype when it is integer or bool
    (JAX's ``mean`` / ``std`` of an int array is float32)."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(default_dtype())


def dtype_or(dtype, like: Optional[torch.Tensor] = None):
    if dtype is not None:
        return convert_dtype(dtype)
    return like.dtype if like is not None else default_dtype()


def reduce_dims(x: torch.Tensor, axis):
    """A reduction's dims: every dim for None, else the tuple."""
    ax = axes(axis)
    if ax is None:
        return tuple(range(x.dim()))
    return ax if isinstance(ax, tuple) else (ax,)
