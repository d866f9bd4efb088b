"""``paddle.fft`` (port of ``paddle_tpu/fft.py``): the eager wrappers of
``ops/fft.py``'s transforms. They take and return ``Tensor``s and record
on autograd's graph; the raw functions on ``torch.Tensor``s are
``paddle_tpu_torch.ops.fft``'s."""

from . import dispatch as _dispatch
from .ops import fft as _kernels

_NAMES = [n for n in dir(_kernels) if not n.startswith("_")
          and callable(getattr(_kernels, n))
          and getattr(_kernels, n).__module__ == _kernels.__name__]

for _n in _NAMES:
    globals()[_n] = _dispatch.wrapped_ops[_n]

__all__ = sorted(_NAMES)
del _n
