"""Fused ResNet bottleneck block, eval mode (port of
``paddle_tpu/ops/pallas/fused_conv_block.py``).

One launch of ``csrc/fused_bottleneck.cu`` computes a stride-1 identity
bottleneck on BN-folded weights::

    out = relu(conv3(relu(conv2(relu(conv1(x) + b1)) + b2)) + b3 + x)

on NHWC ``x [N, H, W, C]`` with the packed layouts of the JAX package:
``w1 [C, M]``, ``w2 [9M, M]`` (the 3x3 taps ky-major), ``w3 [M, C]`` and
f32 biases ``[1, M]`` / ``[1, C]``. Sums run in f32; y1 and y2 are
rounded to ``x.dtype`` after their relu, and the output is in
``x.dtype``, where the TPU kernel rounds them.

- :func:`fused_bottleneck_reference` is the plain version.
- :func:`fused_bottleneck_eval` is the wrapper: the plain version for
  CPU tensors, the kernel for CUDA tensors (or it raises). It has no
  backward, as the TPU kernel has none.
- :func:`fold_bn` / :func:`pack_bottleneck` fold the three BNs.
- :func:`fused_bottleneck_supported` is the JAX gate, rule for rule.

The routing is opt-in, as in the JAX package: :func:`enable_fused_conv_eval`
or ``PT_FUSED_CONV_EVAL=1`` in the environment at import.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from . import _build

_FUSED_EVAL_ENABLED = bool(int(os.environ.get("PT_FUSED_CONV_EVAL", "0")))


def enable_fused_conv_eval(enabled: bool = True) -> None:
    """Opt in to routing eval bottleneck blocks through the fused kernel
    (``fused_conv_block.py:205-211``)."""
    global _FUSED_EVAL_ENABLED
    _FUSED_EVAL_ENABLED = bool(enabled)


def fold_bn(conv_w, gamma, beta, mean, var, eps):
    """BN -> conv scale/bias fold (``fused_conv_block.py:166-174``):
    ``(conv_w * scale per out-channel in f32, cast back to conv_w's
    dtype; bias [out] f32)``."""
    scale = (gamma / torch.sqrt(var + eps)).to(torch.float32)
    wf = (conv_w.to(torch.float32) *
          scale[:, None, None, None]).to(conv_w.dtype)
    bias = (beta - mean * scale).to(torch.float32)
    return wf, bias


@torch.no_grad()
def pack_bottleneck(block):
    """Fold a ``BottleneckBlock``'s three BNs and pack its conv weights
    into the kernel's layouts (``fused_conv_block.py:177-196``): returns
    ``(w1 [C, M], b1 [1, M], w2 [9M, M], b2 [1, M], w3 [M, C], b3 [1,
    C])``, contiguous and outside autograd (the kernel has no
    backward)."""
    def fold(conv, bn):
        return fold_bn(conv.weight, bn.weight, bn.bias, bn._mean,
                       bn._variance, bn._epsilon)

    w1, b1 = fold(block.conv1, block.bn1)
    w2, b2 = fold(block.conv2, block.bn2)
    w3, b3 = fold(block.conv3, block.bn3)
    m = w1.shape[0]
    w1m = w1[:, :, 0, 0].t()
    # [M_out, M_in, 3, 3] -> taps ky-major [9 * M_in, M_out]
    w2m = w2.permute(2, 3, 1, 0).reshape(9 * m, m)
    w3m = w3[:, :, 0, 0].t()
    return tuple(t.contiguous() for t in
                 (w1m, b1[None, :], w2m, b2[None, :], w3m, b3[None, :]))


def fused_bottleneck_reference(x, w1, b1, w2, b2, w3, b3):
    """The kernel's arithmetic in plain PyTorch (``fused_conv_block.py:
    70-114``). Every product takes f32 operands (exact for bf16), so the
    sums are f32 as with ``preferred_element_type=f32``; y1 and y2 are
    rounded to ``x.dtype`` after their relu."""
    f32 = torch.float32
    n, h, w, c = x.shape
    m = w1.shape[1]
    xf = x.to(f32).reshape(-1, c)
    y1 = torch.relu(xf @ w1.to(f32) + b1).to(x.dtype).to(f32)
    pad = F.pad(y1.reshape(n, h, w, m), (0, 0, 1, 1, 1, 1))
    cols = torch.cat([pad[:, dy:dy + h, dx:dx + w]
                      for dy in range(3) for dx in range(3)], dim=-1)
    y2 = torch.relu(cols.reshape(-1, 9 * m) @ w2.to(f32) + b2)
    y2 = y2.to(x.dtype).to(f32)
    y3 = y2 @ w3.to(f32) + b3 + xf
    return torch.relu(y3).to(x.dtype).reshape(n, h, w, c)


def fused_bottleneck_eval(x, w1, b1, w2, b2, w3, b3):
    """The block on NHWC ``x`` with packed weights (see the module
    docstring). CPU tensors take the plain version; CUDA tensors launch
    ``csrc/fused_bottleneck.cu`` or raise."""
    _build.refuse_grad("fused_bottleneck", x, w1, b1, w2, b2, w3, b3)
    if x.device.type == "cpu":
        return fused_bottleneck_reference(x, w1, b1, w2, b2, w3, b3)
    dev = _build.require_cuda("fused_bottleneck", x, w1, b1, w2, b2, w3, b3)
    if x.dim() != 4:
        raise ValueError(f"fused_bottleneck: x must be [N, H, W, C], got "
                         f"{tuple(x.shape)}")
    n, h, w, c = x.shape
    m = w1.shape[1] if w1.dim() == 2 else -1
    want = {"w1": (c, m), "b1": (1, m), "w2": (9 * m, m), "b2": (1, m),
            "w3": (m, c), "b3": (1, c)}
    got = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3}
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"fused_bottleneck: {name} {tuple(t.shape)}, "
                             f"want {want[name]} for x {tuple(x.shape)}")
    for name in ("w1", "w2", "w3"):
        if got[name].dtype != x.dtype:
            raise TypeError(f"fused_bottleneck: {name} must have x's dtype "
                            f"{x.dtype}, got {got[name].dtype}")
    for name in ("b1", "b2", "b3"):
        if got[name].dtype != torch.float32:
            raise TypeError(f"fused_bottleneck: {name} must be float32")
    code = _build.dtype_code(x, "fused_bottleneck x")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    err = _build.lib().pt_fused_bottleneck(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
        n, h, w, c, m, code, _build.stream(dev))
    _build.check(err, f"fused_bottleneck (x {tuple(x.shape)}, M={m})")
    fused_bottleneck_eval.launches += 1
    return out


fused_bottleneck_eval.launches = 0


def _device_admits(device_type) -> bool:
    """The JAX gate's backend test (TPU, or flash forced for AOT) becomes:
    the input lies on a CUDA device and ``plain_kernels()`` is not in
    force."""
    from ..nn_functional import plain_mode
    return device_type == "cuda" and not plain_mode()


def fused_bottleneck_supported(block, x_shape, data_format,
                               device_type=None) -> bool:
    """The gate (``fused_conv_block.py:214-249``): opted in, a CUDA input,
    a stride-1 dilation-1 ungrouped identity bottleneck with plain
    ``BatchNorm2D`` norms, NHWC, a plane of at least 784 positions, the
    JAX package's VMEM estimate under 100 MiB, and ``C == 4M``.
    ``device_type`` None means the device of the block's weights."""
    from ...nn.norm import BatchNorm2D
    if not _FUSED_EVAL_ENABLED:
        return False
    if device_type is None:
        device_type = block.conv1.weight.device.type
    if not _device_admits(device_type):
        return False
    if data_format != "NHWC" or block.downsample is not None:
        return False
    if block.conv2._stride not in (1, (1, 1)):
        return False
    if block.conv2._dilation not in (1, (1, 1)):
        return False
    if getattr(block.conv2, "_groups", 1) != 1:
        return False
    if not all(type(bn) is BatchNorm2D
               for bn in (block.bn1, block.bn2, block.bn3)):
        return False
    n, h, w, c = x_shape
    if h * w < 784:
        return False
    m = block.conv1.weight.shape[0]
    vmem = (2 * h * w * c * 2 + h * w * m * (2 * 2 + 4) +
            (c * m * 2 + 9 * m * m) * 2) * 2
    return vmem < 100 * 2 ** 20 and c == 4 * m
