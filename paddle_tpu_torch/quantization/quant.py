"""Quantization (port of ``paddle_tpu/quantization/quant.py``).

- QAT and PTQ (``quant.py:20-205``): :class:`QuantConfig`,
  :func:`fake_quant` (straight-through), :func:`quant_dequant`,
  :class:`FakeQuantLayer`, :class:`QuantizedLinear` /
  :class:`QuantizedConv2D`, :class:`ImperativeQuantAware` and
  :class:`PTQ`. The layers keep the JAX package's ``state_dict`` names
  (``inner.weight``, ``act_quant.scale``), so ``nn.layer.load_jax_state``
  carries a JAX QAT model across.
- int8 execution (``quant.py:217-316, 530-558``):
  :func:`quantize_int8` / :func:`dequantize_int8`, :class:`Int8Linear`
  and :class:`Int8Conv2D` over the port's own kernels
  (``ops/kernels/int8_matmul.py``, ``csrc/int8_gemm.cu``; the plain
  versions on CPU tensors) and :func:`convert_to_int8`.
- int8 KV-cache quantization (``quantize_kv`` / ``dequantize_kv``,
  :325-354), the host-side KV blob scale math of the prefix cache's
  spill codecs (:356-430), and weight-only int8 linears
  (``WeightOnlyInt8Linear``, ``convert_to_weight_only_int8``,
  :427-527).

``FakeQuantLayer`` keeps its moving average under ``jit.TrainStep``,
as under the JAX package's eager loop; the JAX ``TrainStep`` freezes its
first-call flag at trace time and sets the scale to each batch's abs-max
instead (ROADMAP.md Queue 3, "Decided").

KV quantization is symmetric per-(token, head) abs-max over the head
dim: ``deq = q * s / qmax`` — the convention the paged-decode kernel
applies to int8 pages, and the one every blob format decodes with
(``KV_QMAX_INT8`` = 127, ``KV_QMAX_INT4`` = 7). The ``*_np`` twins are
pure numpy: they run on page blocks already copied off the device
(``serving/prefix_cache.py pack_page_blob``), and are bitwise the JAX
package's on the same arrays. int4 packs two values a byte along the
head dim (low nibble first, ``ceil(D / 2)`` bytes a row).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops.kernels.int8_matmul import (int8_conv2d, int8_linear,
                                       quantize_activation)
from ..nn.layer import Layer

KV_QMAX_INT8 = 127.0
KV_QMAX_INT4 = 7.0


def quantize_kv(x: torch.Tensor, eps: float = 1e-8):
    """``(int8 values [..., H, D], float32 scales [..., H])``."""
    xf = x.to(torch.float32)
    s = torch.clamp_min(xf.abs().amax(dim=-1), eps)
    q = torch.clamp(torch.round(xf / s[..., None] * KV_QMAX_INT8),
                    -KV_QMAX_INT8, KV_QMAX_INT8).to(torch.int8)
    return q, s


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: ``q * scale / 127``."""
    return (q.to(torch.float32) *
            (scale.to(torch.float32) / KV_QMAX_INT8)[..., None]).to(dtype)


def quantize_kv_np(x: np.ndarray, eps: float = 1e-8):
    """Numpy twin of :func:`quantize_kv`: ``q = clip(round(x / s *
    127))`` int8, scales float32. Returns ``(q [..., H, D], s [...,
    H])``."""
    raw = np.asarray(x, np.float32)
    s = np.maximum(np.max(np.abs(raw), axis=-1), eps).astype(np.float32)
    q = np.clip(np.round(raw / s[..., None] * KV_QMAX_INT8),
                -KV_QMAX_INT8, KV_QMAX_INT8).astype(np.int8)
    return q, s


def dequantize_kv_np(q: np.ndarray, scale: np.ndarray,
                     dtype=np.float32) -> np.ndarray:
    """Numpy twin of :func:`dequantize_kv`: deq = q * s / 127."""
    return (np.asarray(q, np.float32) *
            (np.asarray(scale, np.float32) / KV_QMAX_INT8)[..., None]
            ).astype(dtype)


def quantize_kv_int4_np(x: np.ndarray, eps: float = 1e-8):
    """Symmetric int4 KV quantization: per-(token, head) abs-max scales,
    ``q = clip(round(x / s * 7), -7, 7)``, two nibbles a byte along the
    head dim (low nibble = even index; an odd head dim zero-pads the
    last high nibble). Returns ``(packed uint8 [..., H, ceil(D/2)], s
    float32 [..., H])``."""
    raw = np.asarray(x, np.float32)
    s = np.maximum(np.max(np.abs(raw), axis=-1), eps).astype(np.float32)
    q = np.clip(np.round(raw / s[..., None] * KV_QMAX_INT4),
                -KV_QMAX_INT4, KV_QMAX_INT4).astype(np.int8)
    d = q.shape[-1]
    if d % 2:
        q = np.concatenate(
            [q, np.zeros(q.shape[:-1] + (1,), np.int8)], axis=-1)
    # two's-complement nibbles: q & 0xF maps [-7, 7] into [0, 15]
    lo = (q[..., 0::2].astype(np.uint8)) & 0x0F
    hi = (q[..., 1::2].astype(np.uint8)) & 0x0F
    return (lo | (hi << 4)).astype(np.uint8), s


def dequantize_kv_int4_np(packed: np.ndarray, scale: np.ndarray,
                          head_dim: int, dtype=np.float32) -> np.ndarray:
    """Inverse of :func:`quantize_kv_int4_np`: unpack the nibbles
    (sign-extended), deq = q * s / 7, cut back to ``head_dim``."""
    p = np.asarray(packed, np.uint8)
    lo = (p & 0x0F).astype(np.int8)
    hi = ((p >> 4) & 0x0F).astype(np.int8)
    lo = np.where(lo > 7, lo - 16, lo)
    hi = np.where(hi > 7, hi - 16, hi)
    q = np.empty(p.shape[:-1] + (p.shape[-1] * 2,), np.int8)
    q[..., 0::2] = lo
    q[..., 1::2] = hi
    q = q[..., :head_dim]
    return (q.astype(np.float32) *
            (np.asarray(scale, np.float32) / KV_QMAX_INT4)[..., None]
            ).astype(dtype)


def quant_dequant(x, bits: int = 8, axis: Optional[int] = None):
    """Symmetric abs-max quantization (``quant.py:46-61``): ``(q int8,
    scale float32)`` with ``q = clip(round(x / s * qmax))``, ``qmax =
    2**(bits-1) - 1``; one scale for the tensor, or one per index of
    ``axis``. A tensor gives tensors on its device, each step in its
    dtype; anything else gives numpy arrays, as the JAX package does (a
    numpy ``float32`` scalar scale without ``axis``)."""
    if not torch.is_tensor(x):
        q, scale = quant_dequant(torch.from_numpy(np.array(x)), bits, axis)
        return q.numpy(), scale.numpy()[()]
    raw = x.detach()
    qmax = float(2 ** (bits - 1) - 1)
    if axis is None:
        scale = raw.abs().amax()
        q = torch.clamp(torch.round(raw / torch.clamp_min(scale, 1e-8)
                                    * qmax), -qmax, qmax)
        return q.to(torch.int8), scale.to(torch.float32)
    mv = torch.movedim(raw, axis, 0)
    scale = mv.reshape(mv.shape[0], -1).abs().amax(dim=1)
    bshape = (-1,) + (1,) * (mv.dim() - 1)
    q = torch.clamp(torch.round(mv / torch.clamp_min(scale, 1e-8)
                                .reshape(bshape) * qmax), -qmax, qmax)
    return torch.movedim(q, 0, axis).to(torch.int8), scale.to(torch.float32)


# -- QAT and PTQ --------------------------------------------------------------

@dataclasses.dataclass
class QuantConfig:
    weight_bits: int = 8
    activation_bits: int = 8
    weight_quantize_type: str = "channel_wise_abs_max"
    activation_quantize_type: str = "moving_average_abs_max"
    moving_rate: float = 0.9
    quantizable_layer_type: tuple = ("Linear", "Conv2D")


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


class _FakeQuant(torch.autograd.Function):
    """``v + stop_gradient(fq - v)`` (``quant.py:31-43``): the forward
    gives the JAX package's value (``v + (fq - v)``, not ``fq``), the
    backward passes the gradient straight through to ``v`` and none to
    the scale."""

    @staticmethod
    def forward(ctx, v, s, qmax):
        s = torch.clamp_min(s, 1e-8)
        qm = _f32(qmax, v)  # a tensor divisor: an IEEE quotient on CUDA too
        q = torch.clamp(torch.round(v / s * qmax), -qmax, qmax)
        return v + (q * s / qm - v)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def fake_quant(x: torch.Tensor, scale, bits: int = 8) -> torch.Tensor:
    """Symmetric fake quantization with the straight-through estimator:
    ``clip(round(x / s * qmax)) * s / qmax`` with ``s = max(scale,
    1e-8)`` and ``qmax = 2**(bits-1) - 1`` (``torch.round`` rounds half
    to even, as ``jnp.round`` does)."""
    s = scale.detach() if torch.is_tensor(scale) else _f32(scale, x)
    return _FakeQuant.apply(x, s, float(2 ** (bits - 1) - 1))


class FakeQuantLayer(Layer):
    """Observes the activation's abs-max in training (the first batch
    sets the buffer ``scale``, later ones move it by ``moving_rate``) and
    fake-quantizes against it."""

    def __init__(self, bits: int = 8, moving_rate: float = 0.9, *,
                 device=None):
        super().__init__()
        from ..device import resolve_device
        self.bits = bits
        self.moving_rate = moving_rate
        self.register_buffer("scale", torch.ones(
            (), device=resolve_device(device)))
        self._initialized = False

    def forward(self, x):
        if self.training:
            with torch.no_grad():
                cur = x.detach().abs().amax().to(self.scale.dtype)
                if not self._initialized:
                    self.scale.copy_(cur)
                    self._initialized = True
                else:
                    self.scale.copy_(self.moving_rate * self.scale +
                                     (1 - self.moving_rate) * cur)
        return fake_quant(x, self.scale, self.bits)


def _quantizable():
    from ..nn.common import Linear
    from ..nn.conv import Conv2D
    return Linear, Conv2D


class QuantizedLinear(Layer):
    """A ``Linear`` with fake-quantized weight (per output channel: the
    abs-max over axis 0 of the ``[in, out]`` weight, or one for the
    tensor) and activation."""

    def __init__(self, inner: nn.Module, config: QuantConfig):
        super().__init__()
        self.inner = inner
        self.act_quant = FakeQuantLayer(config.activation_bits,
                                        config.moving_rate,
                                        device=inner.weight.device)
        self.w_bits = config.weight_bits
        self.per_channel = "channel" in config.weight_quantize_type

    def _w_scale(self):
        w = self.inner.weight.detach().abs()
        return w.amax(dim=0, keepdim=True) if self.per_channel else w.amax()

    def forward(self, x):
        from ..amp.auto_cast import amp_cast
        x = self.act_quant(x)
        wq = fake_quant(self.inner.weight, self._w_scale(), self.w_bits)
        x, wq, b = amp_cast("linear", x, wq, self.inner.bias)
        out = torch.matmul(x, wq)
        return out if b is None else out + b


class QuantizedConv2D(Layer):
    """A ``Conv2D`` with a per-tensor fake-quantized weight and a
    fake-quantized activation."""

    def __init__(self, inner: nn.Module, config: QuantConfig):
        super().__init__()
        self.inner = inner
        self.act_quant = FakeQuantLayer(config.activation_bits,
                                        config.moving_rate,
                                        device=inner.weight.device)
        self.w_bits = config.weight_bits

    def forward(self, x):
        from ..ops import nn_functional as NF
        x = self.act_quant(x)
        w = self.inner.weight
        wq = fake_quant(w, w.detach().abs().amax(), self.w_bits)
        c = self.inner
        return NF.conv2d(x, wq, c.bias, c._stride, c._padding, c._dilation,
                         c._groups, c._data_format)


class ImperativeQuantAware:
    """Quantization-aware training: ``quantize`` swaps every ``Linear``
    (and subclass) and every plain ``Conv2D`` for its quant-aware
    version in place."""

    def __init__(self, config: Optional[QuantConfig] = None, **kw):
        self.config = config or QuantConfig(**kw)

    def quantize(self, model: nn.Module) -> nn.Module:
        self._convert(model)
        return model

    def _convert(self, layer: nn.Module) -> None:
        Linear, Conv2D = _quantizable()
        for name, sub in list(layer.named_children()):
            if isinstance(sub, Linear):
                setattr(layer, name, QuantizedLinear(sub, self.config))
            elif type(sub) is Conv2D:
                setattr(layer, name, QuantizedConv2D(sub, self.config))
            else:
                self._convert(sub)

    def save_quantized_model(self, model: nn.Module, path: str,
                             input_spec=None) -> None:
        """The eval-mode model as a static program
        (``static.program.build_program``) saved at ``path``."""
        from ..static.program import build_program
        model.eval()
        build_program(model, input_spec).save(path)


class PTQ:
    """Post-training quantization: calibration batches through observers
    on every ``Linear`` / ``Conv2D`` input (the largest abs value seen,
    ``act_ranges`` by layer name), then int8 weights and scales."""

    def __init__(self, bits: int = 8):
        self.bits = bits
        self.act_ranges: Dict[str, float] = {}
        self._hooks = []

    def _observer(self, name):
        def hook(layer, inputs, outputs):
            v = float(inputs[0].detach().abs().max())
            self.act_ranges[name] = max(self.act_ranges.get(name, 0.0), v)
        return hook

    def calibrate(self, model: nn.Module, data_iter,
                  num_batches: int = 8) -> None:
        """Run up to ``num_batches`` batches (an input, or a tuple whose
        first entry is the input; numpy or tensors) through the model in
        eval mode on its own device."""
        from ..device import module_device
        Linear, Conv2D = _quantizable()
        model.eval()
        dev = module_device(model)
        for name, sub in model.named_modules():
            if name and isinstance(sub, (Linear, Conv2D)):
                self._hooks.append(
                    sub.register_forward_hook(self._observer(name)))
        try:
            with torch.no_grad():
                for i, batch in enumerate(data_iter):
                    if i >= num_batches:
                        break
                    xs = batch[0] if isinstance(batch, (list, tuple)) \
                        else batch
                    model(xs.to(dev) if torch.is_tensor(xs) else
                          torch.as_tensor(np.asarray(xs), device=dev))
        finally:
            for h in self._hooks:
                h.remove()
            self._hooks.clear()

    def quantize_weights(self, model: nn.Module) -> Dict[str, dict]:
        """``{layer: {weight_int8, weight_scale, act_scale}}`` as numpy:
        a ``Linear``'s per output channel (axis 1 of ``[in, out]``), a
        ``Conv2D``'s per output channel (axis 0)."""
        Linear, Conv2D = _quantizable()
        out = {}
        for name, sub in model.named_modules():
            if name and isinstance(sub, (Linear, Conv2D)):
                q, s = quant_dequant(sub.weight.detach().cpu().numpy(),
                                     self.bits,
                                     axis=1 if isinstance(sub, Linear)
                                     else 0)
                out[name] = {"weight_int8": q, "weight_scale": s,
                             "act_scale": self.act_ranges.get(name)}
        return out


# -- int8 execution -----------------------------------------------------------

def quantize_int8(x: torch.Tensor, scale) -> torch.Tensor:
    """``clip(round(x / max(scale, 1e-8) * 127), -127, 127)`` as int8
    (the reference's ``quantize_op``): ``x`` promoted to fp32 beside an
    array scale, kept in its dtype beside a Python number, as ``jnp``
    types them."""
    weak = isinstance(scale, (int, float)) and \
        not isinstance(scale, np.generic)  # np.float64 is a float
    return quantize_activation(x, _f32(scale, x), promote=not weak)


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    """``q * (scale / 127)`` in float32 (``dequantize_op``)."""
    s = _f32(scale, q)
    return q.to(torch.float32) * (s / _f32(127.0, q))


def _scalar_buffer(value, device) -> torch.Tensor:
    return torch.tensor(np.float32(value), device=device)


class Int8Linear(Layer):
    """A ``Linear`` executing int8 x int8 -> int32 (``int8_linear``):
    the ``[in, out]`` weight held as the int8 buffer ``weight_int8`` with
    a per-output-channel ``weight_scale``, the activation quantized
    against the calibrated ``act_scale``, one fp32 epilogue."""

    def __init__(self, inner: nn.Module, act_scale: float, bits: int = 8):
        super().__init__()
        if bits != 8:
            raise ValueError("int8 execution supports 8-bit only")
        q, w_scale = quant_dequant(inner.weight, bits, axis=1)
        self.register_buffer("weight_int8", q)
        self.register_buffer("weight_scale", w_scale)
        self.register_buffer("act_scale",
                             _scalar_buffer(act_scale, q.device))
        self.bias = inner.bias

    def forward(self, x):
        return int8_linear(x, self.weight_int8, self.weight_scale,
                           self.act_scale, self.bias)


class Int8Conv2D(Layer):
    """A ``Conv2D`` executing int8 x int8 -> int32 (``int8_conv2d``), one
    weight scale for the tensor, NCHW."""

    def __init__(self, inner: nn.Module, act_scale: float, bits: int = 8):
        super().__init__()
        if bits != 8:
            raise ValueError("int8 execution supports 8-bit only")
        q, w_scale = quant_dequant(inner.weight, bits, axis=None)
        self.register_buffer("weight_int8", q)
        self.register_buffer("weight_scale", w_scale)
        self.register_buffer("act_scale",
                             _scalar_buffer(act_scale, q.device))
        self.bias = inner.bias
        self._stride = inner._stride
        self._padding = inner._padding
        self._dilation = inner._dilation
        self._groups = inner._groups
        self._data_format = inner._data_format

    def forward(self, x):
        # the fp32 conv2d's stride / padding / dilation resolution
        # (ops/nn_functional.py), so both accept the same configs
        from ..ops.nn_functional import _explicit_pads, _norm_tuple
        stride = _norm_tuple(self._stride, 2)
        dilation = _norm_tuple(self._dilation, 2)
        (top, bottom), (left, right) = _explicit_pads(
            self._padding, tuple(x.shape[2:]),
            tuple(self.weight_int8.shape[2:]), stride, dilation)
        return int8_conv2d(x, self.weight_int8, self.weight_scale,
                           self.act_scale, self.bias, stride,
                           (top, bottom, left, right), dilation,
                           self._groups)


def convert_to_int8(model: nn.Module, ptq: PTQ) -> nn.Module:
    """Swap every calibrated ``Linear`` / ``Conv2D`` (exactly those
    types) for its int8-executing version in place (the reference's
    ``quantization_pass.py`` rewrite). Raises ``InvalidArgumentError``
    for a layer with no calibration range (run ``ptq.calibrate`` first)
    and for a channels-last ``Conv2D``."""
    from ..core.enforce import InvalidArgumentError
    Linear, Conv2D = _quantizable()

    def convert(layer: nn.Module, prefix: str = "") -> None:
        for name, sub in list(layer.named_children()):
            full = f"{prefix}.{name}" if prefix else name
            act = ptq.act_ranges.get(full)
            if type(sub) is Linear or type(sub) is Conv2D:
                if act is None:
                    raise InvalidArgumentError(
                        f"no calibration range for layer {full!r}; run "
                        "PTQ.calibrate() over representative data first")
                if type(sub) is Conv2D:
                    if sub._data_format not in ("NCHW", None):
                        raise InvalidArgumentError(
                            f"int8 conversion of layer {full!r}: only "
                            "NCHW Conv2D is supported (got "
                            f"{sub._data_format!r})")
                    setattr(layer, name, Int8Conv2D(sub, act))
                else:
                    setattr(layer, name, Int8Linear(sub, act))
            else:
                convert(sub, full)

    with torch.no_grad():
        convert(model)
    return model


class WeightOnlyInt8Linear(Layer):
    """Weight-only int8 linear (``quant.py:427-474``): the ``[in, out]``
    weight quantized per output channel into the buffers ``weight_int8``
    (int8) and ``weight_scale`` (float32), the bias kept as it was. The
    product runs in the activation's dtype and the scale applies to its
    output: ``(x @ weight_int8) * (weight_scale / 127) (+ bias)``. It has
    no ``weight``, so the fused epilogues and the fused lm head decline
    it (``models/gpt.py`` ``head_params``, ``_fused_epilogue_params``)."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        q, s = quant_dequant(inner.weight, 8, axis=1)
        self.register_buffer("weight_int8", q)
        self.register_buffer("weight_scale", s)
        self.bias = getattr(inner, "bias", None)
        self.in_features = inner.weight.shape[0]
        self.out_features = inner.weight.shape[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.matmul(x, self.weight_int8.to(x.dtype))
        out = out * (self.weight_scale.to(x.dtype) / KV_QMAX_INT8)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


def _linear_types(extra_types=()):
    from ..nn.layers import ColumnParallelLinear, Linear, RowParallelLinear
    return (Linear, ColumnParallelLinear, RowParallelLinear, *extra_types)


def convert_to_weight_only_int8(model: nn.Module, extra_types=()) -> int:
    """Swap every ``Linear``, ``ColumnParallelLinear`` and
    ``RowParallelLinear`` (exactly those types, plus ``extra_types``) for
    a :class:`WeightOnlyInt8Linear` in place, and return how many were
    swapped (``quant.py:477-527``). Embeddings and norms stay float, so a
    tied lm head stays the float ``wte``: GPT converts 4 layers a block.
    The converted model's weights are new tensors: a CUDA graph captured
    before reads the old ones, and the graph runners key on the
    addresses to recapture."""
    types = _linear_types(extra_types)
    count = 0
    with torch.no_grad():
        for parent in list(model.modules()):
            for name, sub in list(parent.named_children()):
                if type(sub) in types:
                    setattr(parent, name, WeightOnlyInt8Linear(sub))
                    count += 1
    return count
