"""The dtype names and their spellings (port of ``paddle_tpu/core/
dtype.py``).

The port's dtypes are ``torch.dtype`` objects. Every spelling (a
string, a numpy dtype or type, a Python type, a torch dtype) normalises
through :func:`convert_dtype`, which canonicalises 64-bit dtypes to
their 32-bit counterparts as the JAX package does in x32 mode
(``dtype.py:58-75``): ``int64`` is ``int32``, ``float64`` is
``float32`` and ``complex128`` is ``complex64``. So ``to_tensor([1, 2])``
is int32 here as it is there, and no tensor of the eager API holds a
64-bit dtype.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from .flags import get_flag, set_flags

bfloat16 = torch.bfloat16
float16 = torch.float16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
uint16 = torch.uint16
uint32 = torch.uint32
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_ALIASES = {
    "bf16": "bfloat16",
    "fp16": "float16",
    "half": "float16",
    "fp32": "float32",
    "float": "float32",
    "fp64": "float64",
    "double": "float64",
    "bool_": "bool",
    "int": "int32",
    "long": "int64",
}

_NAME_TO_DTYPE = {
    "bfloat16": bfloat16, "float16": float16, "float32": float32,
    "float64": float64, "int8": int8, "int16": int16, "int32": int32,
    "int64": int64, "uint8": uint8, "uint16": uint16, "uint32": uint32,
    "uint64": torch.uint64, "bool": bool_, "complex64": complex64,
    "complex128": complex128,
}

_64BIT_CANON = {torch.int64: torch.int32, torch.uint64: torch.uint32,
                torch.float64: torch.float32,
                torch.complex128: torch.complex64}

DTypeLike = Union[str, np.dtype, type, torch.dtype, Any]


def _named(name: str) -> torch.dtype:
    name = _ALIASES.get(name, name)
    try:
        return _NAME_TO_DTYPE[name]
    except KeyError:
        raise TypeError(f"unknown dtype {name!r}") from None


def convert_dtype(dtype: DTypeLike) -> torch.dtype:
    """Any dtype spelling as a ``torch.dtype``, 64-bit canonicalised to
    32-bit; None is the default dtype."""
    if dtype is None:
        return default_dtype()
    if isinstance(dtype, torch.dtype):
        d = dtype
    elif isinstance(dtype, str):
        d = _named(dtype)
    elif dtype is bool:
        d = torch.bool
    elif dtype is int:
        d = torch.int32
    elif dtype is float:
        d = torch.float32
    elif dtype is complex:
        d = torch.complex64
    else:
        npd = np.dtype(dtype)
        if npd.name == "bfloat16" or npd == _bf16_host():
            d = torch.bfloat16
        else:
            d = _named(npd.name)
    return _64BIT_CANON.get(d, d)


def _bf16_host() -> np.dtype:
    from ..nn.layer import numpy_dtype
    return numpy_dtype(torch.bfloat16)


def dtype_name(dtype: DTypeLike) -> str:
    """The numpy-style name of a dtype (``"float32"``, ``"bool"``)."""
    d = convert_dtype(dtype)
    return "bool" if d == torch.bool else str(d).rsplit(".", 1)[-1]


def default_dtype() -> torch.dtype:
    return convert_dtype(get_flag("default_dtype"))


def get_default_dtype() -> str:
    """reference: paddle.get_default_dtype."""
    return dtype_name(default_dtype())


def set_default_dtype(d: DTypeLike) -> None:
    """reference: paddle.set_default_dtype(d)."""
    set_flags({"default_dtype": dtype_name(d)})


def is_floating(dtype: DTypeLike) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype: DTypeLike) -> bool:
    d = convert_dtype(dtype)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


def finfo(dtype: DTypeLike) -> torch.finfo:
    """``jnp.finfo`` of the dtype (``core/dtype.py:104``): ``bits``,
    ``eps``, ``max``, ``min``, ``tiny``, ``resolution``."""
    return torch.finfo(convert_dtype(dtype))


def iinfo(dtype: DTypeLike) -> torch.iinfo:
    return torch.iinfo(convert_dtype(dtype))
