"""The eager ``Tensor``, ``Parameter`` and ``to_tensor`` (port of
``paddle_tpu/tensor.py:22``, ``:319``, ``:345``).

``Tensor`` wraps a ``torch.Tensor`` in ``.value``, as the JAX package's
wraps a ``jax.Array``. It is not a subclass of ``torch.Tensor`` and
``torch.Tensor`` is never patched: Paddle's methods (``transpose(perm)``,
``split(num_or_sections)``, ``gather(index, axis)``, the int ``size``, a
``numpy()`` that copies from the card) live on this class alone
(``dispatch.monkey_patch_tensor``), so nothing changes what a
``torch.Tensor`` means to other code.

Autograd is torch's own graph on ``.value``, with no second tape:
``stop_gradient`` is ``not requires_grad`` (set to true on a non-leaf,
it detaches the value), ``grad`` wraps ``value.grad``, ``grad_node`` is
``value.grad_fn`` and ``backward`` is ``torch.autograd.backward``.

``Parameter`` subclasses ``torch.nn.Parameter``, so it goes into the
port's modules and optimizers as it is, with ``nn.Parameter``'s
``__torch_function__`` (disabled: ops on it return plain tensors). It
adds the names ``torch.Tensor`` lacks (``stop_gradient``, ``trainable``,
``optimize_attr``, ``regularizer``, ``need_clip``, ``gradient()``,
``clear_grad()``, ``astype``) and touches two torch names only where
torch returns nothing or raises: ``name`` (None outside named tensors)
and ``numpy()``, which also copies from the card and from a tensor that
requires grad.

bf16 travels to the host as the port's ``BF16`` bit-pattern dtype
(``nn/layer.py`` ``numpy_dtype``): numpy has no bfloat16.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .core.dtype import convert_dtype


def host_array(value: torch.Tensor) -> np.ndarray:
    """``value`` as a numpy array on the host (a copy from the card;
    bf16 as ``BF16`` bit patterns)."""
    from .nn.layer import _to_host
    if value.device.type == "cpu" and value.dtype != torch.bfloat16:
        return value.detach().resolve_conj().numpy()
    return _to_host(value)


def _diff_dtype(value: torch.Tensor) -> bool:
    return value.is_floating_point() or value.is_complex()


class Tensor:
    """An eager tensor of the port: ``value`` is the ``torch.Tensor``."""

    __slots__ = ("value", "name", "persistable", "_inplace_version",
                 "is_distributed", "pspec", "__weakref__")

    def __init__(self, value, stop_gradient: bool = True,
                 name: Optional[str] = None):
        if isinstance(value, Tensor):
            value = value.value
        elif not isinstance(value, torch.Tensor):
            value = to_value(value)
        if stop_gradient and value.requires_grad:
            value = value.detach()
        elif not stop_gradient and not value.requires_grad and \
                _diff_dtype(value):
            value = value.detach().requires_grad_(True)
        self.value = value
        self.name = name
        self.persistable = False
        self._inplace_version = 0
        self.is_distributed = False
        self.pspec = None

    @classmethod
    def _wrap(cls, value: torch.Tensor) -> "Tensor":
        """The dispatch layer's wrap: no checks, no copy."""
        t = cls.__new__(cls)
        t.value = value
        t.name = None
        t.persistable = False
        t._inplace_version = 0
        t.is_distributed = False
        t.pspec = None
        return t

    # -- array protocol -------------------------------------------------------

    def __array__(self, dtype=None, copy=None):
        arr = host_array(self.value)
        return arr.astype(dtype) if dtype is not None else arr

    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.value.dtype

    @property
    def ndim(self) -> int:
        return self.value.dim()

    @property
    def size(self) -> int:
        return self.value.numel()

    @property
    def T(self):  # noqa: N802 - reference name
        from . import dispatch
        return dispatch.apply("t", self)

    @property
    def place(self):
        from .core.place import place_of
        return place_of(self.value.device)

    def numpy(self) -> np.ndarray:
        return host_array(self.value)

    def item(self):
        return self.value.item()

    def tolist(self):
        return self.numpy().tolist()

    def detach(self) -> "Tensor":
        return Tensor._wrap(self.value.detach())

    def clone(self) -> "Tensor":
        from . import dispatch
        return dispatch.apply("clone", self)

    def numel(self) -> int:
        return self.value.numel()

    def element_size(self) -> int:
        return self.value.element_size()

    def astype(self, dtype) -> "Tensor":
        from . import dispatch
        return dispatch.apply("cast", self, dtype)

    def cast(self, dtype) -> "Tensor":
        return self.astype(dtype)

    def cpu(self) -> "Tensor":
        return Tensor._wrap(self.value.cpu())

    def cuda(self, device_id=None, blocking=True) -> "Tensor":
        from .device import resolve_device
        dev = "cuda" if device_id is None else f"cuda:{int(device_id)}"
        return Tensor._wrap(self.value.to(resolve_device(dev)))

    def block_until_ready(self) -> "Tensor":
        if self.value.is_cuda:
            torch.cuda.synchronize(self.value.device)
        return self

    @property
    def block(self):
        """The current default program (the reference's owning
        block), or the startup program when none is active."""
        from .static.api import default_startup_program
        from .static.program import default_main_program
        return default_main_program() or default_startup_program()

    def to(self, *args, **kwargs) -> "Tensor":
        """``to(dtype)``, ``to(device)`` or ``to(device, dtype)``, with
        Paddle's spellings (``"gpu"``, a place, ``"float32"``)."""
        from .core.place import Place, place_of
        dev, dt = kwargs.get("device"), kwargs.get("dtype")
        for a in args:
            if isinstance(a, (Place, torch.device)) or (
                    isinstance(a, str) and a.split(":")[0].lower() in
                    ("cpu", "gpu", "cuda", "tpu", "npu", "xpu")):
                dev = a
            elif a is not None:
                dt = a
        out = self.value
        if dev is not None:
            out = out.to(place_of(dev).torch_device)
        if dt is not None:
            out = out.to(convert_dtype(dt))
        return Tensor._wrap(out)

    # -- autograd ---------------------------------------------------------------

    @property
    def stop_gradient(self) -> bool:
        return not self.value.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, flag: bool) -> None:
        v = self.value
        if flag:
            if v.grad_fn is not None:
                self.value = v.detach()
            elif v.requires_grad:
                v.requires_grad_(False)
        elif not v.requires_grad and _diff_dtype(v):
            v.requires_grad_(True)

    @property
    def grad(self) -> Optional["Tensor"]:
        g = self.value.grad
        return None if g is None else Tensor._wrap(g)

    @grad.setter
    def grad(self, g) -> None:
        self.value.grad = None if g is None else unwrap(g)

    @property
    def grad_node(self):
        return self.value.grad_fn

    @property
    def is_leaf(self) -> bool:
        return self.value.grad_fn is None

    def backward(self, grad_tensor=None, retain_graph: bool = False) -> None:
        from .autograd.engine import backward as _backward
        _backward(self, grad_tensor, retain_graph=retain_graph)

    def retain_grads(self) -> None:
        if self.value.grad_fn is not None:
            self.value.retain_grad()

    def register_hook(self, hook):
        """``hook(grad)`` on each gradient that reaches this tensor; it
        sees a ``Tensor`` and may return a replacement."""
        def torch_hook(g):
            res = hook(Tensor._wrap(g))
            return None if res is None else unwrap(res)
        return self.value.register_hook(torch_hook)

    def clear_grad(self) -> None:
        self.value.grad = None

    clear_gradient = clear_grad

    def gradient(self):
        """The accumulated gradient as a numpy array, or None."""
        g = self.value.grad
        return None if g is None else host_array(g)

    # -- in-place-style helpers (functional underneath, as in JAX) ------------

    def _inplace_assign(self, new) -> "Tensor":
        self.value = unwrap(new)
        self._inplace_version += 1
        return self

    def _set_raw(self, raw: torch.Tensor) -> None:
        """Replace the value outside the graph, keeping a leaf's
        requires-grad flag (the JAX package swaps the array)."""
        old = self.value
        raw = raw.detach().to(device=old.device, dtype=old.dtype)
        if old.grad_fn is None and old.requires_grad:
            raw = raw.clone().requires_grad_(True)
        self.value = raw
        self._inplace_version += 1

    def set_value(self, value) -> None:
        if not isinstance(value, (Tensor, torch.Tensor)):
            value = to_value(value, device=self.value.device)
        self._set_raw(unwrap(value))

    def fill_(self, v) -> "Tensor":
        self._set_raw(torch.full_like(self.value, v))
        return self

    def zero_(self) -> "Tensor":
        self._set_raw(torch.zeros_like(self.value))
        return self

    def scale_(self, v) -> "Tensor":
        self._set_raw(self.value.detach() * v)
        return self

    def add_(self, other) -> "Tensor":
        self._set_raw(self.value.detach() + unwrap(other))
        return self

    def subtract_(self, other) -> "Tensor":
        self._set_raw(self.value.detach() - unwrap(other))
        return self

    def _inplace_op(self, name: str, *args, **kwargs) -> "Tensor":
        from . import dispatch
        return self._inplace_assign(dispatch.apply(name, self, *args,
                                                   **kwargs))

    def reshape_(self, shape) -> "Tensor":
        return self._inplace_op("reshape", shape)

    def squeeze_(self, axis=None) -> "Tensor":
        return self._inplace_op("squeeze", axis)

    def unsqueeze_(self, axis) -> "Tensor":
        return self._inplace_op("unsqueeze", axis)

    def scatter_(self, index, updates, overwrite: bool = True) -> "Tensor":
        return self._inplace_op("scatter", index, updates, overwrite)

    def tanh_(self) -> "Tensor":
        return self._inplace_op("tanh")

    def ceil_(self) -> "Tensor":
        return self._inplace_op("ceil")

    def floor_(self) -> "Tensor":
        return self._inplace_op("floor")

    def round_(self) -> "Tensor":
        return self._inplace_op("round")

    def exp_(self) -> "Tensor":
        return self._inplace_op("exp")

    def sqrt_(self) -> "Tensor":
        return self._inplace_op("sqrt")

    def rsqrt_(self) -> "Tensor":
        return self._inplace_op("rsqrt")

    def reciprocal_(self) -> "Tensor":
        return self._inplace_op("reciprocal")

    def clip_(self, min=None, max=None) -> "Tensor":  # noqa: A002
        return self._inplace_op("clip", min, max)

    def flatten_(self, start_axis: int = 0, stop_axis: int = -1) -> "Tensor":
        return self._inplace_op("flatten", start_axis, stop_axis)

    @property
    def inplace_version(self) -> int:
        """Bumped on each in-place write (``setitem``, ``*_`` methods)."""
        return self._inplace_version

    def where(self, x, y) -> "Tensor":
        """``Tensor.where(x, y)``: self is the bool condition."""
        from . import dispatch
        return dispatch.apply("where", self, x, y)

    # -- python protocol --------------------------------------------------------

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("len() of a 0-d tensor")
        return self.shape[0]

    def __bool__(self) -> bool:
        return bool(self.value)

    def __int__(self) -> int:
        return int(self.value)

    def __float__(self) -> float:
        return float(self.value)

    def __index__(self) -> int:
        return int(self.value)

    def __repr__(self) -> str:
        return (f"Tensor(shape={list(self.shape)}, dtype={self.dtype}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},"
                f"\n{self.numpy()})")

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, idx):
        from . import dispatch
        return dispatch.getitem(self, idx)

    def __setitem__(self, idx, value):
        from . import dispatch
        dispatch.setitem(self, idx, value)

    def __hash__(self):
        return id(self)

    # arithmetic dunders and the op methods: dispatch.monkey_patch_tensor()


def unwrap(x):
    """The ``torch.Tensor`` inside a ``Tensor``; anything else as it is."""
    return x.value if isinstance(x, Tensor) else x


class Parameter(torch.nn.Parameter):
    """A trainable tensor: a ``torch.nn.Parameter`` with Paddle's names.

    ``Parameter(value, name=None, trainable=True)`` as in the JAX
    package; ``Parameter(data, requires_grad)`` as torch calls it when it
    copies one."""

    regularizer = None
    do_model_average = None
    need_clip = True
    is_distributed = False
    persistable = True

    def __new__(cls, value=None, name=None, trainable=True):
        if isinstance(name, bool):  # torch's (data, requires_grad)
            name, trainable = None, name
        if value is None:
            value = torch.empty(0)
        data = unwrap(value)
        if not isinstance(data, torch.Tensor):
            data = to_value(data)
        p = torch.Tensor._make_subclass(cls, data.detach(),
                                        bool(trainable))
        if name is not None:
            p.param_name = name
        return p

    def __init__(self, value=None, name=None, trainable=True):
        pass

    @property
    def name(self):  # noqa: D401 - torch's is None outside named tensors
        return getattr(self, "param_name", None)

    @name.setter
    def name(self, value) -> None:
        self.param_name = value

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, flag: bool) -> None:
        self.requires_grad_(not flag)

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, flag: bool) -> None:
        self.requires_grad_(bool(flag))

    @property
    def optimize_attr(self) -> dict:
        attr = self.__dict__.get("_optimize_attr")
        if attr is None:
            attr = self.__dict__["_optimize_attr"] = {"learning_rate": 1.0}
        return attr

    @optimize_attr.setter
    def optimize_attr(self, value) -> None:
        self.__dict__["_optimize_attr"] = value

    def gradient(self):
        return None if self.grad is None else host_array(self.grad)

    def clear_grad(self) -> None:
        self.grad = None

    clear_gradient = clear_grad

    def astype(self, dtype) -> Tensor:
        from . import dispatch
        return dispatch.apply("cast", self, dtype)

    def numpy(self) -> np.ndarray:
        return host_array(self)

    def __repr__(self) -> str:
        return "Parameter containing:\n" + super().__repr__()


def to_value(data: Any, dtype=None, device=None) -> torch.Tensor:
    """``data`` (a Python scalar or list, a numpy array, a torch tensor)
    as a ``torch.Tensor`` on ``device`` (the expected place when None)
    with the JAX package's x32 dtypes: int64 data is int32, float64 data
    float32 (``ops/creation.py`` ``to_array``)."""
    from .core.place import expected_device
    from .nn.layer import _from_host
    if device is None:
        device = expected_device()
    if isinstance(data, torch.Tensor):
        out = data.detach()
    else:
        if isinstance(data, (list, tuple)) and any(
                isinstance(d, (Tensor, torch.Tensor)) for d in data):
            data = [host_array(unwrap(d)) if isinstance(
                d, (Tensor, torch.Tensor)) else d for d in data]
        arr = np.asarray(data)
        if arr.dtype == object:
            raise TypeError(f"to_tensor: cannot convert {type(data)}")
        out = _from_host(np.array(arr, copy=True))
    target = convert_dtype(dtype if dtype is not None else out.dtype)
    return out.to(device=device, dtype=target)


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True
              ) -> Tensor:
    """``paddle.to_tensor``: a new ``Tensor`` holding a copy of ``data``
    on ``place`` (the expected place, the card by default)."""
    from .core.place import place_of
    device = None if place is None else place_of(place).torch_device
    if isinstance(data, Tensor):
        data = data.value
        if device is None:
            device = data.device
    value = to_value(data, dtype, device)
    if isinstance(data, torch.Tensor) and value.data_ptr() == \
            data.data_ptr():
        value = value.clone()
    if not stop_gradient and _diff_dtype(value):
        value.requires_grad_(True)
    return Tensor._wrap(value)
