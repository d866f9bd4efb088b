"""The eager API published at the package's top level (port of
``paddle_tpu/__init__.py:13-218``): the wrapped ops of the registry,
``Tensor`` / ``Parameter`` / ``to_tensor``, the dtype and place names,
the grad-mode switches and the reference's top-level helpers.

``paddle_tpu_torch/__init__.py`` loads this module on the first read of
one of its names, so importing the package (as the serving supervisor
does) stays light.
"""

from __future__ import annotations

import numpy as _np
import torch as _torch

from . import dispatch as _dispatch
from ._not_ported import NotPorted as _NotPorted
from .autograd.engine import (enable_grad, grad,  # noqa: F401
                              is_grad_enabled, no_grad, set_grad_enabled)
from .core.dtype import (bfloat16, bool_, complex64,  # noqa: F401
                         complex128, float16, float32, float64,
                         get_default_dtype, int8, int16, int32, int64,
                         set_default_dtype, uint8)
from .core.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace,  # noqa
                         GPUPlace, NPUPlace, Place, TPUPlace, XPUPlace,
                         get_device, set_device)
from .core.rng import seed  # noqa: F401
from .framework.mode import (batch, check_shape,  # noqa: F401
                             disable_static, enable_static, in_dygraph_mode,
                             in_dynamic_mode, set_printoptions)
from .tensor import Parameter, Tensor, to_tensor  # noqa: F401

# every wrapped op; the names that are namespace modules in the
# reference (paddle.fft, paddle.linalg) stay unpublished
_MODULE_NAMES = {"fft", "linalg"}
OPS = {name: fn for name, fn in _dispatch.wrapped_ops.items()
       if name not in _MODULE_NAMES}
globals().update({n: f for n, f in OPS.items() if n not in globals()})

rand = _dispatch.wrapped_ops["rand"]
randn = _dispatch.wrapped_ops["randn"]
randint = _dispatch.wrapped_ops["randint"]
uniform = _dispatch.wrapped_ops["uniform"]
normal = _dispatch.wrapped_ops["normal"]

# paddle.dtype: Tensor.dtype is a torch.dtype
dtype = _torch.dtype
bool = bool_  # noqa: A001 - paddle.bool


def Model(*args, **kwargs):  # noqa: N802 - reference name
    from .hapi import Model as _M
    return _M(*args, **kwargs)


def flops(net, input_size, custom_ops=None, print_detail=False):
    """reference: paddle.flops."""
    from .hapi.flops import flops as _flops
    return _flops(net, input_size, custom_ops, print_detail)


def summary(net, input_size=None, dtypes=None):
    """reference: paddle.summary."""
    from .hapi import Model as _M
    return _M(net).summary(input_size, dtypes)


DataParallel = _NotPorted("DataParallel",
                          "paddle_tpu/distributed/parallel.py")


def save(obj, path, **kwargs):
    from .framework.io import save as _save
    return _save(obj, path, **kwargs)


def load(path, **kwargs):
    from .framework.io import load as _load
    return _load(path, **kwargs)


def create_parameter(shape, dtype=None, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A free ``Parameter`` on the expected place (reference:
    ``paddle.create_parameter``)."""
    from .core.dtype import convert_dtype
    from .device import resolve_device
    from .nn.initializer import create_parameter as _create
    p = _create(tuple(shape), attr=attr,
                default_initializer=default_initializer, is_bias=is_bias,
                device=resolve_device(None),
                dtype=convert_dtype(dtype or get_default_dtype()))
    name = name or (getattr(attr, "name", None) if attr is not None
                    else None)
    return Parameter(p, name=name, trainable=p.requires_grad)


def is_tensor(x) -> bool:
    """reference: paddle.is_tensor."""
    return isinstance(x, Tensor)


def tolist(x):
    """reference: paddle.tolist."""
    return x.tolist() if isinstance(x, Tensor) else _np.asarray(x).tolist()


def get_cuda_rng_state():
    """The card's generator state (the eager random ops'), as a list."""
    from .core.place import expected_device
    from .core.rng import default_generator
    return [default_generator(expected_device()).get_state()]


def set_cuda_rng_state(state_list):
    from .core.place import expected_device
    from .core.rng import default_generator
    if state_list:
        default_generator(expected_device()).set_state(state_list[0])


def _inplace_top(name):
    def f(x, *args, **kwargs):
        return getattr(x, name)(*args, **kwargs)
    f.__name__ = name
    f.__doc__ = f"In-place variant (reference: paddle.{name})."
    return f


reshape_ = _inplace_top("reshape_")
squeeze_ = _inplace_top("squeeze_")
unsqueeze_ = _inplace_top("unsqueeze_")
scatter_ = _inplace_top("scatter_")
tanh_ = _inplace_top("tanh_")
del _inplace_top


def _with_out_param(name, unary):
    base = _dispatch.wrapped_ops[name]

    def _finish(res, out):
        if out is None:
            return res
        if not hasattr(out, "_inplace_assign"):
            raise TypeError(f"{name}: out= must be a paddle Tensor, got "
                            f"{type(out).__name__}")
        return out._inplace_assign(res)

    if unary:
        def f(x, out=None, name=None):
            return _finish(base(x), out)
    else:
        def f(x, y, out=None, name=None):
            return _finish(base(x, y), out)
    f.__name__ = name
    f.__doc__ = (base.__doc__ or "") + \
        "\n\nAccepts the reference's ``out=`` tensor (written in place)."
    return f


for _n in ("logical_and", "logical_or", "logical_xor",
           "bitwise_and", "bitwise_or", "bitwise_xor"):
    globals()[_n] = _with_out_param(_n, unary=False)
for _n in ("logical_not", "bitwise_not"):
    globals()[_n] = _with_out_param(_n, unary=True)
del _n, _with_out_param

# control_flow's names (``paddle_tpu/__init__.py:71-77``)
from .ops.control_flow import (TensorArray, array_length,  # noqa: F401,E402
                               array_read, array_to_lod_tensor, array_write,
                               create_array, lod_tensor_to_array,
                               tensor_array_to_tensor)

EAGER_NAMES = sorted(n for n in globals() if not n.startswith("_")
                     and n not in ("annotations", "OPS", "EAGER_NAMES"))
