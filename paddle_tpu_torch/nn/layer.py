"""``Layer``, the base of the port's layers and models (port of
``paddle_tpu/nn/layer.py:41-365``), and moving weights between the JAX
package and the port.

``Layer`` subclasses ``torch.nn.Module`` and adds Paddle's names that
torch lacks (``create_parameter``, ``add_sublayer``, ``sublayers``,
``set_state_dict``, ``clear_gradients``, ``register_forward_post_hook``,
...). Its ``__call__`` unwraps eager ``Tensor`` arguments to their
values and wraps the outputs back only when a ``Tensor`` came in:
plain ``torch.Tensor`` arguments reach ``forward`` untouched and come
back as they are, so inside a model every op sees plain tensors. Where
Paddle and torch give one name two meanings, torch's stays:
``parameters()`` is a generator (a list in the JAX package),
``state_dict()`` holds torch tensors, ``to()`` and ``register_buffer``
take torch's arguments as well as Paddle's spellings.

The port's modules name their parameters and buffers as the JAX
package's ``Layer`` does (``nn/layer.py:239-252``), so a JAX model's
``state_dict()`` turned into numpy, or ``paddle_tpu.models.gpt.
checkpoint_state``, loads without renaming or transposing: keys such as
``gpt.h.0.attn.qkv_proj.weight (E, 3E)``, ``layer1.0.bn1._mean`` or
``fc.weight (2048, 1000)``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..tensor import Tensor, unwrap


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a tensor of ``dtype`` travels as in a host state
    dict. numpy has no bfloat16: bf16 travels as its bit patterns in
    the prefix cache's ``BF16`` dtype, as bf16 pages do. Raises for a
    dtype outside the map."""
    if dtype == torch.bfloat16:
        from ..serving.prefix_cache import BF16
        return BF16
    try:
        return _NUMPY_DTYPES[dtype]
    except KeyError:
        raise TypeError(f"no host dtype for {dtype}") from None


_NUMPY_DTYPES = {torch.float32: np.dtype(np.float32),
                 torch.float64: np.dtype(np.float64),
                 torch.float16: np.dtype(np.float16),
                 torch.int8: np.dtype(np.int8),
                 torch.uint8: np.dtype(np.uint8),
                 torch.int16: np.dtype(np.int16),
                 torch.int32: np.dtype(np.int32),
                 torch.int64: np.dtype(np.int64),
                 torch.bool: np.dtype(np.bool_)}


def _to_host(t: torch.Tensor) -> np.ndarray:
    # a copy even on the CPU, where .cpu() would return the tensor
    # itself: a snapshot must not change when the model is later loaded
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(numpy_dtype(t.dtype))
    return t.numpy()


def _from_host(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.dtype == numpy_dtype(torch.bfloat16):
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def checkpoint_state(model: nn.Module) -> Dict[str, np.ndarray]:
    """A snapshot of the model's parameters and persistent buffers as
    host numpy arrays keyed by structured name, the JAX package's keys;
    bf16 tensors as ``BF16`` bit patterns (``numpy_dtype``). The arrays
    are copies on every device, so loading other weights into the model
    later leaves them as they were."""
    return {name: _to_host(t) for name, t in model.state_dict().items()}


def _convert_for_state(model: nn.Module, state: Dict[str, Any]) -> None:
    """Where ``state`` holds a weight-only int8 layer (``X.weight_int8``
    and ``X.weight_scale``, no ``X.weight``) and the model a float
    linear at ``X``, convert that layer in place first, so the state of
    a converted JAX model loads into a float port model."""
    from ..quantization.quant import WeightOnlyInt8Linear, _linear_types
    types = _linear_types()
    for name, sub in list(model.named_modules()):
        pre = f"{name}." if name else ""
        if (type(sub) in types and f"{pre}weight_int8" in state
                and f"{pre}weight" not in state):
            parent_name, _, attr = name.rpartition(".")
            setattr(model.get_submodule(parent_name), attr,
                    WeightOnlyInt8Linear(sub))


def load_jax_state(model: nn.Module, state: Dict[str, Any]) -> None:
    """Copy ``state`` (name -> array) into the model's parameters and
    buffers in place (``copy_``: every tensor keeps its storage, so a
    CUDA graph captured before reads the new values). Missing or
    unexpected keys and shape mismatches raise. The copies bump each
    tensor's version counter, which is what a cache keyed on
    ``(data_ptr(), _version)`` sees. The state of a model converted by
    ``convert_to_weight_only_int8`` converts the matching float layers
    first (new tensors, so graphs captured before are rebuilt), then
    loads its int8 weights and scales byte for byte."""
    _convert_for_state(model, state)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state does not match the model: missing "
                       f"{missing[:4]}, unexpected {extra[:4]}")
    with torch.no_grad():
        for name, t in own.items():
            src = _from_host(state[name])
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(t.shape)}")
            t.copy_(src.to(dtype=t.dtype))


# -- Layer --------------------------------------------------------------------

def _unwrap_args(obj):
    if isinstance(obj, Tensor):
        return obj.value
    if isinstance(obj, list):
        return [_unwrap_args(o) for o in obj]
    if isinstance(obj, tuple):
        return tuple(_unwrap_args(o) for o in obj)
    return obj


def _torch_spelling(v):
    """A device or dtype in Paddle's spelling (a place, ``"gpu:0"``,
    ``"float32"``) as torch takes it; torch's own pass unchanged."""
    from ..core.dtype import convert_dtype
    from ..core.place import Place, place_of
    if isinstance(v, Place):
        return v.torch_device
    if isinstance(v, str):
        head = v.split(":")[0].lower()
        if head in ("gpu", "tpu", "npu", "xpu"):
            return place_of(v).torch_device
        if head not in ("cpu", "cuda", "meta"):
            return convert_dtype(v)
    if isinstance(v, np.dtype) or (isinstance(v, type) and issubclass(
            v, np.generic)):
        return convert_dtype(v)
    return v


class Layer(nn.Module):
    """A ``torch.nn.Module`` with the reference ``Layer``'s names."""

    _name_scope: Optional[str] = None
    _dtype = torch.float32

    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        super().__init__()
        from ..core.dtype import convert_dtype
        self._dtype = convert_dtype(dtype)
        if name_scope is not None:
            self._name_scope = name_scope

    def __call__(self, *args, **kwargs):
        # every module call of the port passes here with plain tensors:
        # the scan is type checks inline, and the plain call goes to
        # what nn.Module.__call__ runs (_wrapped_call_impl) one frame
        # sooner, so a call costs the frames it cost before
        for a in args:
            t = type(a)
            if t is Tensor:
                return self._eager_call(args, kwargs)
            if t is list or t is tuple:
                for b in a:
                    if type(b) is Tensor:
                        return self._eager_call(args, kwargs)
        if kwargs:
            for a in kwargs.values():
                if type(a) is Tensor:
                    return self._eager_call(args, kwargs)
        if self._compiled_call_impl is not None:
            return self._compiled_call_impl(*args, **kwargs)
        return self._call_impl(*args, **kwargs)

    def _eager_call(self, args, kwargs):
        """A call with eager ``Tensor`` arguments: ``forward`` sees their
        values, and the outputs come back as ``Tensor``s."""
        from ..dispatch import _wrap
        out = self._wrapped_call_impl(
            *_unwrap_args(args),
            **{k: _unwrap_args(v) for k, v in kwargs.items()})
        return _wrap(out)

    # -- construction helpers -------------------------------------------------

    def create_parameter(self, shape, dtype=None, default_initializer=None,
                         is_bias: bool = False, attr=None):
        """A ``Parameter`` on the expected place, drawn by the
        initializer ``attr`` / ``default_initializer`` / the global one
        name (``xavier_uniform``, zeros for a bias)."""
        from ..core.dtype import convert_dtype
        from ..device import resolve_device
        from ..tensor import Parameter
        from .initializer import create_parameter
        p = create_parameter(tuple(shape), attr=attr,
                             default_initializer=default_initializer,
                             is_bias=is_bias, device=resolve_device(None),
                             dtype=convert_dtype(dtype or self._dtype))
        out = Parameter(p, name=getattr(p, "param_name", None),
                        trainable=p.requires_grad)
        return out

    def add_parameter(self, name: str, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer: nn.Module):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        persistent: Optional[bool] = None):
        """torch's ``register_buffer``; Paddle's third argument
        (``persistable``) means torch's ``persistent``, and an eager
        ``Tensor`` is stored as its value."""
        from ..tensor import unwrap
        keep = persistable if persistent is None else persistent
        super().register_buffer(name, unwrap(tensor), persistent=keep)
        return tensor

    # -- traversal ------------------------------------------------------------

    def named_sublayers(self, prefix: str = "", include_self: bool = False
                        ) -> Iterator[Tuple[str, nn.Module]]:
        if include_self:
            yield prefix, self
        for name, layer in self._modules.items():
            if layer is None:
                continue
            sub_prefix = f"{prefix}.{name}" if prefix else name
            yield sub_prefix, layer
            if isinstance(layer, Layer):
                yield from layer.named_sublayers(sub_prefix)
            else:
                for n, m in layer.named_modules(prefix=sub_prefix):
                    if m is not layer:
                        yield n, m

    def sublayers(self, include_self: bool = False) -> List[nn.Module]:
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def parameters(self, include_sublayers: bool = True,
                   recurse: Optional[bool] = None):
        """torch's generator, under Paddle's keyword too:
        ``include_sublayers`` is torch's ``recurse``."""
        return super().parameters(
            recurse=include_sublayers if recurse is None else recurse)

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True,
                         remove_duplicate: bool = True,
                         recurse: Optional[bool] = None):
        """torch's generator of ``(name, parameter)``, under Paddle's
        keywords too (``named_parameters(prefix, include_sublayers)``)."""
        return super().named_parameters(
            prefix=prefix,
            recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate)

    # -- hooks ----------------------------------------------------------------

    def register_forward_post_hook(self, hook: Callable):
        """``hook(layer, inputs, outputs)`` after each forward; a value
        it returns replaces the outputs. The handle's ``remove()`` takes
        it off."""
        return self.register_forward_hook(hook)

    # -- state dict -----------------------------------------------------------

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy ``state_dict`` (name -> Tensor, torch tensor or array)
        into the parameters and buffers in place, each in its own dtype;
        shape mismatches raise. Returns the names the dict lacks."""
        from ..tensor import unwrap
        own = self.state_dict(keep_vars=True)
        missing = []
        with torch.no_grad():
            for name, target in own.items():
                if name not in state_dict:
                    missing.append(name)
                    continue
                value = unwrap(state_dict[name])
                if not isinstance(value, torch.Tensor):
                    value = _from_host(value)
                if tuple(value.shape) != tuple(target.shape):
                    raise ValueError(
                        f"shape mismatch for {name}: {tuple(value.shape)} "
                        f"vs {tuple(target.shape)}")
                target.copy_(value.to(device=target.device,
                                      dtype=target.dtype))
        return missing

    load_dict = set_state_dict

    # -- dtype / device -------------------------------------------------------

    def to(self, *args, **kwargs):
        args = tuple(_torch_spelling(a) for a in args)
        kwargs = {k: _torch_spelling(v) if k in ("device", "dtype") else v
                  for k, v in kwargs.items()}
        return super().to(*args, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    # -- misc -----------------------------------------------------------------

    def clear_gradients(self) -> None:
        for p in self.parameters():
            p.grad = None

    def full_name(self) -> str:
        return self._name_scope or type(self).__name__.lower()


# -- functional capture (``paddle_tpu/nn/layer.py:333-420``) -------------------

def functional_state(layer: nn.Module, trainable_only: bool = False
                     ) -> Dict[str, Any]:
    """The layer's tensors, detached, as ``{"params": {name: tensor},
    "buffers": {name: tensor}}`` under the JAX package's names."""
    params = {n: p.detach() for n, p in layer.named_parameters()
              if p is not None and (not trainable_only or p.requires_grad)}
    buffers = {n: b.detach() for n, b in layer.named_buffers()
               if b is not None}
    return {"params": params, "buffers": buffers}


def _owner(layer: nn.Module, name: str):
    """The submodule holding ``name`` and its attribute, or (None, attr)
    when the layer has no such submodule."""
    mod, _, attr = name.rpartition(".")
    try:
        return (layer.get_submodule(mod) if mod else layer), attr
    except AttributeError:
        return None, attr


@contextlib.contextmanager
def bind_state(layer: nn.Module, state: Dict[str, Any]):
    """Substitute ``state``'s tensors for the layer's parameters and
    buffers of the same names for the duration (names the layer lacks
    are ignored); the originals come back on exit. The forward then
    computes on the substituted tensors, and autograd (or
    ``torch.func``) differentiates with respect to them."""
    swapped = []
    try:
        for kind, table in (("params", "_parameters"),
                            ("buffers", "_buffers")):
            for name, value in state.get(kind, {}).items():
                owner, attr = _owner(layer, name)
                slots = getattr(owner, table, {})
                if attr not in slots:
                    continue
                swapped.append((slots, attr, slots[attr]))
                slots[attr] = unwrap(value)
        yield layer
    finally:
        for slots, attr, old in reversed(swapped):
            slots[attr] = old


def functional_call(layer: nn.Module, state: Dict[str, Any], *args,
                    training: Optional[bool] = None, rng_key=None,
                    mutable_buffers: bool = False, **kwargs):
    """``layer(*args, **kwargs)`` as a function of ``state``: plain
    outputs, or ``(outputs, new buffers)`` with ``mutable_buffers`` (a
    BatchNorm's running statistics after the call). ``training`` sets
    the mode for the call only; ``rng_key`` (a ``torch.Generator``)
    drives the random ops inside. Unlike the JAX function, which runs
    under the eager tape's ``no_grad`` and is differentiated by
    ``jax.grad``, the call records on autograd's graph: that is how
    PyTorch differentiates it."""
    from ..core import rng as rng_mod
    prev_training = layer.training
    if training is not None:
        layer.train(training)
    try:
        with bind_state(layer, state):
            with rng_mod.key_scope(rng_key) if rng_key is not None else \
                    contextlib.nullcontext():
                out = layer(*[unwrap(a) for a in args],
                            **kwargs)
            if mutable_buffers:
                new_buffers = {n: b for n, b in layer.named_buffers()
                               if b is not None}
                return out, new_buffers
            return out
    finally:
        if training is not None:
            layer.train(prev_training)
