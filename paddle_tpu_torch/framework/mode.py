"""Execution-mode switch and small framework utilities (port of
``paddle_tpu/framework/mode.py``): ``enable_static`` /
``disable_static`` / ``in_dynamic_mode``, ``batch``, ``check_shape`` and
``set_printoptions``.

As in the JAX package there is no op-by-op static interpreter: "static
mode" is a flag that reference code branching on ``in_dynamic_mode()``
reads; programs are built by tracing (``static.build_program``).
"""

from __future__ import annotations

import numpy as np
import torch

_dynamic_mode = True


def enable_static() -> None:
    global _dynamic_mode
    _dynamic_mode = False


def disable_static() -> None:
    global _dynamic_mode
    _dynamic_mode = True


def in_dynamic_mode() -> bool:
    return _dynamic_mode


def in_dygraph_mode() -> bool:
    return _dynamic_mode


def batch(reader, batch_size, drop_last: bool = False):
    """Wrap a sample reader into a mini-batch reader (reference:
    ``paddle.batch``)."""
    if batch_size <= 0:
        raise ValueError("batch_size must be positive")

    def batched():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


def check_shape(shape) -> None:
    """Validate a shape argument: a list / tuple of ints, or an int32 /
    int64 tensor."""
    from ..tensor import Tensor
    if isinstance(shape, (Tensor, torch.Tensor)):
        if shape.dtype not in (torch.int32, torch.int64):
            raise TypeError(
                f"shape tensor must be int32/int64, got {shape.dtype}")
        return
    if not isinstance(shape, (list, tuple)):
        raise TypeError(f"shape must be a list/tuple/Tensor, got "
                        f"{type(shape).__name__}")
    for s in shape:
        if not isinstance(s, (int, np.integer)) and not hasattr(s, "dtype"):
            raise TypeError(f"shape elements must be ints, got "
                            f"{type(s).__name__}")


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None) -> None:
    """Tensor print formatting: a ``Tensor``'s repr renders through
    numpy, so this sets numpy's print options."""
    kw = {}
    if precision is not None:
        kw["precision"] = int(precision)
    if threshold is not None:
        kw["threshold"] = int(threshold)
    if edgeitems is not None:
        kw["edgeitems"] = int(edgeitems)
    if linewidth is not None:
        kw["linewidth"] = int(linewidth)
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)
