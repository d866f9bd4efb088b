"""int8 execution: the quantized linear and convolution
(``csrc/int8_gemm.cu``) and their plain versions.

The port's own kernels, with no TPU counterpart: the JAX package runs
``Int8Linear`` / ``Int8Conv2D`` (``paddle_tpu/quantization/quant.py:
250-266``, ``:292-316``) as XLA ``dot_general`` / ``conv_general_dilated``
with ``preferred_element_type=int32``. Both compute, in JAX's order::

    s   = max(act_scale, 1e-8)
    qx  = clip(rint(x / s * 127), -127, 127)      # true division, ties to even
    acc = sum(qx * wq)                             # int8 x int8 -> int32
    out = float(acc) * ((act_scale / 127) * (w_scale / 127)) + bias

on ``x`` in fp32 (bf16 promoted to fp32, as ``jnp`` promotes it beside
the fp32 scale). The linear takes ``x [..., K]``, ``wq int8 [K, N]`` and
a per-output-channel ``w_scale [N]``; the convolution NCHW ``x``, ``wq
int8 [M, C/groups, kh, kw]`` and one ``w_scale``; ``act_scale`` is a 0-d
fp32 tensor (a buffer, read by the kernel on the device).

- :func:`int8_linear_reference` / :func:`int8_conv2d_reference` are the
  plain versions: the same quantization, an exact integer product (an
  integer matmul on the CPU; float64 products of the int8 values, exact
  while 127^2 * K < 2^53, elsewhere) and the same fp32 epilogue. The
  kernel's outputs are bitwise theirs.
- :func:`int8_linear` / :func:`int8_conv2d` are the wrappers: CPU
  tensors take the plain version, CUDA tensors launch the kernel (two
  launches a call: the quantizing pass, then the product with its
  epilogue; counted once) or raise. They call the registered ops
  ``paddle_tpu_torch::int8_linear`` / ``int8_conv2d``
  (``_build.register_op``), so a program exported on the card records
  them and a loaded one launches them.
- Gradients are those ``jax.grad`` takes through the JAX functions (the
  JAX ``TrainStep``): the bias gets the output's gradient summed over
  every other dim, ``x`` zeros (``round`` and the int8 cast have zero
  derivatives), ``wq`` none (an integer). The scales are buffers that
  ``jax.grad`` never differentiates: the wrappers raise if one requires
  grad. (The JAX eager tape records nothing through these ops, so
  there the bias gets no gradient at all; ROADMAP.md Queue 3,
  "Decided".)
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build

QMAX = 127.0
X_DTYPES = (torch.float32, torch.bfloat16)


def quantize_activation(x: torch.Tensor, act_scale: torch.Tensor,
                        promote: bool = True) -> torch.Tensor:
    """``clip(round(x / max(act_scale, 1e-8) * 127), -127, 127)`` as
    int8 (``quant.py:217-222``), ``x`` promoted to fp32 first, as ``jnp``
    promotes it beside an fp32 array; with ``promote=False`` (a Python
    number's scale, weakly typed in JAX) the scale is rounded to ``x``'s
    dtype and each step taken in it."""
    s = torch.clamp_min(act_scale.to(torch.float32), 1e-8)
    if promote:
        x = x.to(torch.float32)
    else:
        s = s.to(x.dtype)
    return torch.clamp(torch.round(x / s * QMAX), -QMAX, QMAX).to(
        torch.int8)


def dequantize_output(acc: torch.Tensor, w_scale: torch.Tensor,
                      act_scale: torch.Tensor,
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The epilogue: ``float(acc) * ((act_scale / 127) * (w_scale / 127))
    (+ bias)``, each step rounded in fp32 (``quant.py:260-263``). The
    divisor is a tensor: PyTorch's CUDA division by a Python number
    multiplies by its reciprocal, which is not the IEEE quotient JAX and
    the kernel take."""
    qmax = torch.full((), QMAX, dtype=torch.float32, device=acc.device)
    out = acc.to(torch.float32) * ((act_scale / qmax) * (w_scale / qmax))
    return out if bias is None else out + bias


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two int8 tensors as exact int32: the CPU's integer
    matmul, or float64 products elsewhere (CUDA has no integer matmul;
    exact while 127^2 * K < 2^53)."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    return torch.matmul(a.to(torch.float64),
                        b.to(torch.float64)).to(torch.int32)


def int8_linear_reference(x, wq, w_scale, act_scale, bias=None):
    """The plain int8 linear: ``x [..., K]``, ``wq [K, N]`` -> fp32
    ``[..., N]``."""
    acc = _int_matmul(quantize_activation(x, act_scale), wq)
    return dequantize_output(acc, w_scale, act_scale, bias)


def conv_output_size(size: int, k: int, stride: int, lo: int, hi: int,
                     dilation: int) -> int:
    return (size + lo + hi - (k - 1) * dilation - 1) // stride + 1


def int8_conv2d_reference(x, wq, w_scale, act_scale, bias, stride,
                          padding, dilation, groups):
    """The plain int8 convolution on NCHW ``x``: ``padding`` is (top,
    bottom, left, right); the quantized input padded with zeros (the
    quantization of 0), a float64 convolution of the int8 values."""
    qx = quantize_activation(x, act_scale)
    top, bottom, left, right = padding
    qx = F.pad(qx.to(torch.float64), (left, right, top, bottom))
    acc = F.conv2d(qx, wq.to(torch.float64), None, tuple(stride), 0,
                   tuple(dilation), groups).to(torch.int32)
    if bias is not None:
        bias = bias.reshape(1, -1, 1, 1)
    return dequantize_output(acc, w_scale, act_scale, bias)


def int8_linear(x, wq, w_scale, act_scale, bias=None):
    """The int8 linear (see the module docstring); its registered op
    ``paddle_tpu_torch::int8_linear``."""
    _build.refuse_grad("int8_linear's scales", w_scale, act_scale)
    if x.device.type != "cpu":
        _check_linear(x, wq, w_scale, act_scale, bias)
    return torch.ops.paddle_tpu_torch.int8_linear(x, wq, w_scale, act_scale,
                                                  bias)


def int8_conv2d(x, wq, w_scale, act_scale, bias, stride: Sequence[int],
                padding: Sequence[int], dilation: Sequence[int],
                groups: int):
    """The int8 convolution on NCHW ``x``; ``padding`` is (top, bottom,
    left, right), as ``ops/nn_functional.py`` ``_explicit_pads``
    resolves the layer's spec. Its registered op
    ``paddle_tpu_torch::int8_conv2d``."""
    _build.refuse_grad("int8_conv2d's scales", w_scale, act_scale)
    if x.device.type != "cpu":
        _check_conv(x, wq, w_scale, act_scale, bias, groups)
    return torch.ops.paddle_tpu_torch.int8_conv2d(
        x, wq, w_scale, act_scale, bias, [int(s) for s in stride],
        [int(p) for p in padding], [int(d) for d in dilation], int(groups))


def _check_common(name, x, wq, w_scale, act_scale, bias):
    for tname, t in (("x", x), ("wq", wq), ("w_scale", w_scale),
                     ("act_scale", act_scale), ("bias", bias)):
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: all operands must be CUDA tensors "
                             f"on one device, got {tname} on {t.device}")
    if x.dtype not in X_DTYPES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if wq.dtype != torch.int8:
        raise TypeError(f"{name}: wq must be int8, got {wq.dtype}")
    for tname, t in (("w_scale", w_scale), ("act_scale", act_scale),
                     ("bias", bias)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name}: {tname} must be float32, got "
                            f"{t.dtype}")
    if act_scale.numel() != 1:
        raise ValueError(f"{name}: act_scale must hold one value")


def _check_linear(x, wq, w_scale, act_scale, bias):
    _check_common("int8_linear", x, wq, w_scale, act_scale, bias)
    if wq.dim() != 2 or x.shape[-1] != wq.shape[0]:
        raise ValueError(f"int8_linear: x {tuple(x.shape)} and wq "
                         f"{tuple(wq.shape)} do not chain")
    n = wq.shape[1]
    if tuple(w_scale.shape) != (n,) or (bias is not None and
                                       tuple(bias.shape) != (n,)):
        raise ValueError(f"int8_linear: w_scale / bias must be [{n}]")


def _check_conv(x, wq, w_scale, act_scale, bias, groups):
    _check_common("int8_conv2d", x, wq, w_scale, act_scale, bias)
    if x.dim() != 4 or wq.dim() != 4:
        raise ValueError(f"int8_conv2d: x {tuple(x.shape)} must be NCHW "
                         f"and wq {tuple(wq.shape)} [M, C/g, kh, kw]")
    c, m = x.shape[1], wq.shape[0]
    if c % groups or m % groups or wq.shape[1] != c // groups:
        raise ValueError(f"int8_conv2d: x {tuple(x.shape)}, wq "
                         f"{tuple(wq.shape)}, groups {groups}")
    if w_scale.numel() != 1 or (bias is not None and
                                tuple(bias.shape) != (m,)):
        raise ValueError(f"int8_conv2d: w_scale must hold one value and "
                         f"bias be [{m}]")


# -- the registered ops -------------------------------------------------------

def _linear_fake(x, wq, w_scale, act_scale, bias):
    return x.new_empty(tuple(x.shape[:-1]) + (wq.shape[1],),
                       dtype=torch.float32)


def _conv_out_shape(x, wq, stride, padding, dilation):
    b, _, h, w = x.shape
    top, bottom, left, right = padding
    oh = conv_output_size(h, wq.shape[2], stride[0], top, bottom,
                          dilation[0])
    ow = conv_output_size(w, wq.shape[3], stride[1], left, right,
                          dilation[1])
    return (b, wq.shape[0], oh, ow)


def _conv_fake(x, wq, w_scale, act_scale, bias, stride, padding, dilation,
               groups):
    return x.new_empty(_conv_out_shape(x, wq, stride, padding, dilation),
                       dtype=torch.float32)


def _linear_cuda(x, wq, w_scale, act_scale, bias):
    dev = _build.require_cuda("int8_linear", wq, w_scale, act_scale, bias)
    x = x.contiguous()
    _build.require_cuda("int8_linear", x)
    code = _build.dtype_code(x, "int8_linear x", X_DTYPES)
    k, n = wq.shape
    m = x.numel() // k if k else 0
    out = torch.empty(tuple(x.shape[:-1]) + (n,), device=dev,
                      dtype=torch.float32)
    qx = torch.empty(x.shape, device=dev, dtype=torch.int8)
    err = _build.lib().pt_int8_linear(
        x.data_ptr(), qx.data_ptr(), wq.data_ptr(), w_scale.data_ptr(),
        act_scale.data_ptr(), _build.ptr(bias), out.data_ptr(), m, k, n,
        code, int(bias is not None), _build.stream(dev))
    _build.check(err, f"int8_linear (M={m}, K={k}, N={n})")
    int8_linear.launches += 1
    return out


def _conv_cuda(x, wq, w_scale, act_scale, bias, stride, padding, dilation,
               groups):
    dev = _build.require_cuda("int8_conv2d", wq, w_scale, act_scale, bias)
    x = x.contiguous()
    _build.require_cuda("int8_conv2d", x)
    code = _build.dtype_code(x, "int8_conv2d x", X_DTYPES)
    b, c, h, w = x.shape
    shape = _conv_out_shape(x, wq, stride, padding, dilation)
    out = torch.empty(shape, device=dev, dtype=torch.float32)
    qx = torch.empty(x.shape, device=dev, dtype=torch.int8)
    m, _, kh, kw = wq.shape
    err = _build.lib().pt_int8_conv2d(
        x.data_ptr(), qx.data_ptr(), wq.data_ptr(), w_scale.data_ptr(),
        act_scale.data_ptr(), _build.ptr(bias), out.data_ptr(), b, c, h, w,
        m, kh, kw, shape[2], shape[3], stride[0], stride[1], padding[0],
        padding[2], dilation[0], dilation[1], groups, code,
        int(bias is not None), _build.stream(dev))
    _build.check(err, f"int8_conv2d (x {tuple(x.shape)}, w "
                 f"{tuple(wq.shape)}, groups {groups})")
    int8_conv2d.launches += 1
    return out


def _setup_grad(ctx, inputs, output):
    x = inputs[0]
    ctx.x_shape, ctx.x_dtype = tuple(x.shape), x.dtype


def _grads(ctx, grad, bias_dims):
    """``(x, wq, w_scale, act_scale, bias)``'s gradients: zeros for
    ``x``, the bias's summed over ``bias_dims``."""
    gx = gb = None
    if ctx.needs_input_grad[0]:
        gx = torch.zeros(ctx.x_shape, dtype=ctx.x_dtype, device=grad.device)
    if ctx.needs_input_grad[4]:
        gb = grad.sum(dim=bias_dims)
    return gx, None, None, None, gb


def _linear_backward(ctx, grad):
    return _grads(ctx, grad, tuple(range(grad.dim() - 1)))


def _conv_backward(ctx, grad):
    return _grads(ctx, grad, (0, 2, 3)) + (None,) * 4


_build.register_op(
    "int8_linear(Tensor x, Tensor wq, Tensor w_scale, Tensor act_scale, "
    "Tensor? bias) -> Tensor",
    int8_linear_reference, _linear_cuda, _linear_fake, _linear_backward,
    _setup_grad)
_build.register_op(
    "int8_conv2d(Tensor x, Tensor wq, Tensor w_scale, Tensor act_scale, "
    "Tensor? bias, int[] stride, int[] padding, int[] dilation, "
    "int groups) -> Tensor",
    int8_conv2d_reference, _conv_cuda, _conv_fake, _conv_backward,
    _setup_grad)

int8_linear.launches = 0
int8_conv2d.launches = 0
