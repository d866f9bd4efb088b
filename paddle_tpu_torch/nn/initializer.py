"""Weight initializers and ``ParamAttr`` (port of
``paddle_tpu/nn/initializer.py``).

``Constant``, ``Assign``, ``Normal``, ``TruncatedNormal``, ``Uniform``,
``XavierUniform`` / ``XavierNormal``, ``KaimingUniform`` /
``KaimingNormal``, ``Orthogonal``, ``Dirac`` and ``Bilinear``, with the
JAX package's fans (``_fans``) and formulas; ``get_initializer``,
``set_global_initializer`` and ``ParamAttr``; and
:func:`resolve_initializer` with the JAX order of precedence
(``initializer.py:295-309``): ``attr.initializer``, then the layer's
explicit initializer, then the global one, then the built-in default
(``xavier_uniform`` weights, zero biases). An attribute object without
an ``initializer`` takes the default.

An initializer is called as ``init(shape, dtype, device=..., generator=
...)``. Random ones draw in float32 from the explicit ``torch.Generator``
(``None``: the device's default generator) and cast to ``dtype``, as the
JAX ones draw float32 and cast. Torch's streams are not JAX's, so weights
cross between the packages through ``nn.layer.load_jax_state``. A plain
callable (``lambda shape, dtype: ...``) is called with ``(shape,
dtype)`` as in the JAX package.

:func:`create_parameter` is the JAX ``Layer.create_parameter``:
``trainable=False`` gives ``requires_grad=False`` (the optimizers then
skip it, as they skip a JAX parameter with ``trainable=False``) and a
``name`` is kept on the parameter as ``.param_name`` (a torch tensor's
``.name`` is read-only).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn


def _fans(shape: Tuple[int, ...]):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels [out, in, *spatial]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _empty32(shape, device) -> torch.Tensor:
    return torch.empty(tuple(shape), device=device, dtype=torch.float32)


class Initializer:
    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        return self._draw(tuple(int(s) for s in shape), device,
                          generator).to(dtype)

    def _draw(self, shape, device, generator) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def _draw(self, shape, device, generator):
        return torch.full(shape, float(self.value), device=device)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def _draw(self, shape, device, generator):
        v = self.value
        arr = v.detach().to("cpu") if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.array(v, dtype=np.float64))
        return arr.to(device=device, dtype=torch.float64).reshape(shape)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def _draw(self, shape, device, generator):
        z = _empty32(shape, device).normal_(0.0, 1.0, generator=generator)
        return self.mean + self.std * z


class TruncatedNormal(Initializer):
    """A standard normal truncated to [-2, 2] (``jax.random.
    truncated_normal(-2, 2)``), then ``mean + std * z``; drawn by
    inverting the normal CDF over the uniform draws of [cdf(-2),
    cdf(2)]."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def _draw(self, shape, device, generator):
        lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0)))
                  for b in (-2.0, 2.0))
        u = _empty32(shape, device).uniform_(lo, hi, generator=generator)
        z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
        return self.mean + self.std * z.clamp(-2.0, 2.0)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def _draw(self, shape, device, generator):
        return _empty32(shape, device).uniform_(self.low, self.high,
                                                generator=generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in: Optional[int] = None,
                 fan_out: Optional[int] = None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fans(self, shape):
        fi, fo = _fans(shape)
        return (self.fan_in if self.fan_in is not None else fi,
                self.fan_out if self.fan_out is not None else fo)

    def _draw(self, shape, device, generator):
        fi, fo = self._fans(shape)
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _empty32(shape, device).uniform_(-limit, limit,
                                                generator=generator)


class XavierNormal(XavierUniform):
    def _draw(self, shape, device, generator):
        fi, fo = self._fans(shape)
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return std * _empty32(shape, device).normal_(0.0, 1.0,
                                                     generator=generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in: Optional[int] = None,
                 negative_slope: float = 0.0, nonlinearity: str = "relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain(self):
        if self.nonlinearity == "leaky_relu":
            return math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return math.sqrt(2.0)

    def _fan_in(self, shape):
        return self.fan_in if self.fan_in is not None else _fans(shape)[0]

    def _draw(self, shape, device, generator):
        limit = self._gain() * math.sqrt(3.0 / self._fan_in(shape))
        return _empty32(shape, device).uniform_(-limit, limit,
                                                generator=generator)


class KaimingNormal(KaimingUniform):
    def _draw(self, shape, device, generator):
        std = self._gain() / math.sqrt(self._fan_in(shape))
        return std * _empty32(shape, device).normal_(0.0, 1.0,
                                                     generator=generator)


class Orthogonal(Initializer):
    """``gain`` times an orthogonal matrix: for ``[*rows, cols]`` the
    JAX ``nn.initializers.orthogonal()`` construction (the Q of a
    normal matrix's QR, signed by R's diagonal, transposed when there
    are fewer rows than columns). For a 1-D ``[n]`` shape the JAX
    initializer returns an ``[n, n]`` orthogonal matrix, and so does
    this one."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def _draw(self, shape, device, generator):
        if len(shape) == 1:
            rows, cols, out_shape = shape[0], shape[0], (shape[0],) * 2
        else:
            rows, cols, out_shape = int(np.prod(shape[:-1])), shape[-1], \
                shape
        a = _empty32((max(rows, cols), min(rows, cols)), device).normal_(
            0.0, 1.0, generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.t()
        return self.gain * q.reshape(out_shape)


class Dirac(Initializer):
    def __init__(self, groups: int = 1):
        self.groups = groups

    def _draw(self, shape, device, generator):
        out = np.zeros(shape, dtype=np.float32)
        oc, ic = shape[0], shape[1]
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(min(oc // self.groups, ic)):
                out[(g * (oc // self.groups) + i, i, *centers)] = 1.0
        return torch.from_numpy(out).to(device)


class Bilinear(Initializer):
    """The bilinear-upsampling filter of a transposed convolution's
    ``[c_out, c_in, kh, kw]`` weight, the same in every channel pair."""

    def _draw(self, shape, device, generator):
        if len(shape) != 4:
            raise ValueError(f"Bilinear initializer needs a 4-D weight "
                             f"[c_out, c_in, kh, kw], got {shape}")
        _, _, kh, kw = shape
        f_h, f_w = (kh + 1) // 2, (kw + 1) // 2
        ch = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        cw = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        yy = np.arange(kh)[:, None]
        xx = np.arange(kw)[None, :]
        filt = ((1 - np.abs(yy / f_h - ch)) *
                (1 - np.abs(xx / f_w - cw))).astype("float32")
        return torch.from_numpy(
            np.broadcast_to(filt, shape).astype("float32")).to(device)


_REGISTRY = {
    "zeros": lambda: Constant(0.0),
    "ones": lambda: Constant(1.0),
    "constant": Constant,
    "normal": Normal,
    "truncated_normal": TruncatedNormal,
    "uniform": Uniform,
    "xavier_uniform": XavierUniform,
    "xavier_normal": XavierNormal,
    "kaiming_uniform": KaimingUniform,
    "kaiming_normal": KaimingNormal,
    "orthogonal": Orthogonal,
    "bilinear": Bilinear,
}


def get_initializer(spec):
    """An initializer from an ``Initializer``, a callable, a number
    (``Constant``) or a registry name; raises ``ValueError`` otherwise."""
    if isinstance(spec, Initializer) or callable(spec):
        return spec
    if isinstance(spec, (int, float)):
        return Constant(float(spec))
    if isinstance(spec, str) and spec in _REGISTRY:
        return _REGISTRY[spec]()
    raise ValueError(f"Unknown initializer {spec!r}")


class ParamAttr:
    """Parameter attribute bundle (``initializer.py:197``). The port's
    layers read ``initializer``, ``trainable`` and ``name``; the rest is
    kept as the JAX package keeps it."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = (get_initializer(initializer)
                            if initializer is not None else None)
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip


_global_initializer = {"weight": None, "bias": None}


def set_global_initializer(weight_init, bias_init=None) -> None:
    """The initializers a layer uses where it names none of its own
    (``initializer.py:245-255``); ``None`` restores the defaults. The
    setting is process-wide, as in the JAX package."""
    _global_initializer["weight"] = (
        get_initializer(weight_init) if weight_init is not None else None)
    _global_initializer["bias"] = (
        get_initializer(bias_init) if bias_init is not None else None)


def global_initializer(is_bias: bool):
    return _global_initializer["bias" if is_bias else "weight"]


def resolve_initializer(init, attr=None, is_bias: bool = False):
    """``attr.initializer`` > ``init`` > the global initializer > the
    default (``xavier_uniform``, or zeros for a bias)."""
    if attr is not None and getattr(attr, "initializer", None) is not None:
        init = attr.initializer
    if init is None:
        return global_initializer(is_bias) or get_initializer(
            "zeros" if is_bias else "xavier_uniform")
    return get_initializer(init)


def draw(init, shape, dtype, device, generator) -> torch.Tensor:
    """Call ``init`` for ``shape``: an ``Initializer`` with the device
    and generator, a plain callable with ``(shape, dtype)`` (its result
    moved to ``device`` in ``dtype``)."""
    shape = tuple(int(s) for s in shape)
    if isinstance(init, Initializer):
        return init(shape, dtype, device=device, generator=generator)
    out = init(shape, dtype)
    if not isinstance(out, torch.Tensor):
        out = torch.from_numpy(np.array(out, dtype=np.float64))
    return out.to(device=device, dtype=dtype).reshape(shape)


def create_parameter(shape, *, attr=None, default_initializer=None,
                     is_bias: bool = False, device=None,
                     dtype=torch.float32,
                     generator: Optional[torch.Generator] = None
                     ) -> nn.Parameter:
    """The JAX ``Layer.create_parameter`` (``nn/layer.py:55-66``)."""
    init = resolve_initializer(default_initializer, attr, is_bias)
    value = draw(init, shape, dtype, device, generator)
    trainable = getattr(attr, "trainable", True) is not False \
        if attr is not None else True
    p = nn.Parameter(value, requires_grad=trainable)
    name = getattr(attr, "name", None) if attr is not None else None
    if name is not None:
        p.param_name = name
    return p
