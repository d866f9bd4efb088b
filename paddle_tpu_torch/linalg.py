"""``paddle.linalg`` (port of ``paddle_tpu/linalg.py``): the eager
wrappers of ``ops/linalg.py``'s functions, with ``lu_unpack``,
``cdist``, ``block_diag`` and ``diag_embed`` of ``ops/math_extra.py``.
They take and return ``Tensor``s and record on autograd's graph."""

from . import dispatch as _dispatch
from .ops import linalg as _kernels
from .ops.registry import has_op as _has_op

_NAMES = [n for n in dir(_kernels) if not n.startswith("_")
          and callable(getattr(_kernels, n))
          and getattr(_kernels, n).__module__ == _kernels.__name__
          and _has_op(n)]
_EXTRA = [n for n in ("lu_unpack", "cdist", "block_diag", "diag_embed")
          if _has_op(n)]

for _n in _NAMES + _EXTRA:
    globals()[_n] = _dispatch.wrapped_ops[_n]

__all__ = sorted(set(_NAMES + _EXTRA))
del _n
