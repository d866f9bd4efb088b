"""Kernel selection and the functional ops of the serving, training and
vision paths (port of the attention, sampling, dropout, cross-entropy,
convolution, pooling and batch-norm entries of
``paddle_tpu/ops/nn_functional.py``).

Each attention or sampling entry picks a CUDA kernel by the JAX
package's shape rules, gated on the tensors lying on a CUDA device where
the JAX package gated on a TPU backend; everywhere else it runs the
plain PyTorch math, as the JAX package runs XLA or its reference off the
TPU. Attention reaches its kernels only through the autograd Functions
of ``kernels/attention.py``, so training differentiates through them.

:func:`plain_kernels` switches the selection to the plain versions on
the card as well. It exists so that ``chip_smoke.py`` can hold the
kernel path against the plain path on the same inputs; serving and
training never enter it.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from ..core import rng
from .kernels.attention import (flash_attention, flash_attention_supported,
                                folded_attention,
                                folded_attention_supported)
from .kernels.fused_sample import (fused_argmax, fused_argmax_reference,
                                   fused_sample_supported,
                                   fused_topk_reference, _vocab_dim)
from .kernels.paged_attention import (decode_out_proj,
                                      fused_epilogue_supported, paged_decode,
                                      paged_attention_fused_reference,
                                      paged_attention_reference,
                                      paged_attention_supported)

# Flash-vs-plain crossovers of the JAX package (nn_functional.py:788-796):
# kept so that ``use_flash=None`` routes the same shapes as on the TPU
_FLASH_MIN_SEQ = 512
_FOLDED_MIN_SEQ = 256

_MODE = threading.local()


@contextlib.contextmanager
def plain_kernels(enabled: bool = True):
    """Run the plain PyTorch versions instead of the CUDA kernels in
    this thread for the duration (a comparison harness, not a
    fallback). ``enabled=False`` selects the kernels again."""
    prev = plain_mode()
    _MODE.plain = bool(enabled)
    try:
        yield
    finally:
        _MODE.plain = prev


def plain_mode() -> bool:
    """Whether :func:`plain_kernels` is in force in this thread."""
    return getattr(_MODE, "plain", False)


@contextlib.contextmanager
def saved_attention(saved):
    """Hand the attention kernels' forward outputs of this thread to
    ``saved`` (a ``kernels.attention.SavedAttention``, or None for none)
    for the duration: the remat segments of ``remat_save_attention``."""
    prev = getattr(_MODE, "saved", None)
    _MODE.saved = saved
    try:
        yield
    finally:
        _MODE.saved = prev


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda and not plain_mode()


def dropout(x, p: float = 0.5, training: bool = True,
            mode: str = "upscale_in_train", axis=None, generator=None):
    """``nn_functional.py:200-216``: keep each element (or each slice
    along ``axis``) with probability ``1 - p``; ``upscale_in_train``
    divides the kept ones by ``1 - p``. Draws from ``generator``, else
    from the :func:`core.rng.key_scope` generator, else the device's
    default one."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    gen = generator if generator is not None else rng.next_generator()
    if axis is not None:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        shape = tuple(s if i in axes else 1 for i, s in enumerate(x.shape))
    else:
        shape = x.shape
    keep = torch.rand(shape, device=x.device, generator=gen) < (1.0 - p)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), zero).to(x.dtype)
    return torch.where(keep, x, zero).to(x.dtype)


def cross_entropy(input, label, ignore_index: int = -100,  # noqa: A002
                  reduction: str = "mean", axis: int = -1):
    """Hard-label softmax cross entropy (``nn_functional.py:986-1027``):
    positions whose label is ``ignore_index`` give 0, and ``"mean"``
    divides by the number of the others. Soft labels, class weights and
    label smoothing are not ported yet."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: reduction {reduction!r}")
    label = label.long()
    if label.dim() == input.dim():
        label = label.squeeze(axis)
    logp = torch.log_softmax(input, dim=axis)
    valid = label != ignore_index
    picked = torch.gather(logp, axis, torch.where(valid, label, 0)
                          .unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, -picked, torch.zeros((), dtype=logp.dtype,
                                                   device=logp.device))
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1)
    if reduction == "sum":
        return loss.sum()
    return loss


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, scale=None,
                                 generator=None, use_flash=None):
    """q, k, v: [B, S, H, D]. ``use_flash``: None = the kernels from the
    JAX package's measured crossovers, True = a kernel whenever its gate
    admits, False = never (``nn_functional.py:799-866``). The kernels
    take no mask and no active dropout; they differentiate through their
    backward kernels. Dropout on the plain path draws from
    ``generator`` or the :func:`core.rng.key_scope` generator."""
    allowed = use_flash is True or (use_flash is None and
                                    k.shape[1] >= _FLASH_MIN_SEQ)
    folded_allowed = use_flash is True or (
        use_flash is None and k.shape[1] >= _FOLDED_MIN_SEQ)
    if (_on_card(q) and (allowed or folded_allowed) and attn_mask is None
            and (not is_causal or q.shape[1] == k.shape[1])
            and (dropout_p == 0.0 or not training)):
        saved = getattr(_MODE, "saved", None)
        if folded_allowed and folded_attention_supported(
                q.shape, k.shape, is_causal):
            return folded_attention(q, k, v, causal=is_causal, scale=scale,
                                    saved=saved)
        if allowed and flash_attention_supported(q.shape, k.shape):
            return flash_attention(q, k, v, causal=is_causal, scale=scale,
                                   saved=saved)[0]
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qT, kT, vT = (t.transpose(1, 2) for t in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qT.to(torch.float32),
                          kT.to(torch.float32)) * scale
    if is_causal:
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=q.device).tril(diagonal=sk - sq)
        logits = logits.masked_fill(~causal, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training:
        probs = dropout(probs, dropout_p, training=True, generator=generator)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vT)
    return out.transpose(1, 2)


def paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                    k_scale=None, v_scale=None, scale=None, q_offsets=None):
    """Ragged paged attention (``nn_functional.py:869-883``): the
    page-walk kernel for single-token decode on the card, the
    dense-gather reference for everything else."""
    b, sq, h, d = q.shape
    if (_on_card(q) and q_offsets is None
            and paged_attention_supported(q.shape, k_pages.shape)):
        # q is a slice of the fused QKV projection: the kernel takes
        # a contiguous [B, H, D] row per sequence
        return paged_decode(q.reshape(b, h, d).contiguous(), k_pages,
                            v_pages, page_table, seq_lens, k_scale=k_scale,
                            v_scale=v_scale,
                            scale=scale).reshape(b, sq, h, d)
    return paged_attention_reference(
        q, k_pages, v_pages, page_table, seq_lens, k_scale=k_scale,
        v_scale=v_scale, scale=scale, q_offsets=q_offsets)


def paged_attention_fused(q, k_pages, v_pages, page_table, seq_lens, w,
                          bias=None, k_scale=None, v_scale=None, scale=None,
                          q_offsets=None):
    """Paged attention with the output projection: the attention block's
    output [B, Sq, E_out] (``nn_functional.py:908-925``). On the card:
    :func:`paged_decode` then :func:`decode_out_proj`, two launches in
    one call; elsewhere the fused reference (the exact unfused math)."""
    b, sq, h, d = q.shape
    if (_on_card(q) and q_offsets is None
            and fused_epilogue_supported(q.shape, k_pages.shape, w.shape)):
        ctx = paged_decode(q.reshape(b, h, d).contiguous(), k_pages,
                           v_pages, page_table, seq_lens, k_scale=k_scale,
                           v_scale=v_scale, scale=scale)
        out = decode_out_proj(ctx.reshape(b, h * d), w, bias)
        return out.reshape(b, sq, w.shape[1])
    return paged_attention_fused_reference(
        q, k_pages, v_pages, page_table, seq_lens, w, bias=bias,
        k_scale=k_scale, v_scale=v_scale, scale=scale, q_offsets=q_offsets)


def fused_sample(hidden, weight, bias=None, transpose_y=False, top_k=None,
                 tile=2048):
    """Streaming lm-head sampling (``nn_functional.py:928-940``):
    greedy tokens [B] int32 (``top_k=None``) or the top-k reservoir
    ``(values, indices)``, without the [B, vocab] logits."""
    vdim = _vocab_dim(transpose_y)
    if top_k is not None:
        return fused_topk_reference(hidden, weight, vdim, top_k, bias=bias,
                                    tile=tile)
    if _on_card(hidden) and fused_sample_supported(
            hidden.shape, weight.shape, transpose_y=transpose_y):
        return fused_argmax(hidden, weight, bias=bias,
                            transpose_y=transpose_y)
    return fused_argmax_reference(hidden, weight, vdim, bias=bias,
                                  tile=tile)


# -- activations, convolution, pooling, batch norm (the vision path) ---------

def relu(x):
    """``nn_functional.py:26``."""
    return torch.relu(x)


def _norm_tuple(v, n: int):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _conv_padding(padding, nsp: int):
    """The JAX package's padding spec (``nn_functional.py:273-285``): an
    int, one int per spatial dim, ``2 * nsp`` ints (lo, hi per dim),
    per-dim pairs, or ``'SAME'`` / ``'VALID'`` (returned upper-cased)."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nsp
    padding = list(padding)
    if len(padding) == nsp and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * nsp:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nsp)]
    return [tuple(p) for p in padding]


def _explicit_pads(padding, in_sp, ksize, stride, dilation):
    """``_conv_padding`` with ``'SAME'`` and ``'VALID'`` resolved to
    (lo, hi) pairs as XLA resolves them: SAME gives ``ceil(in /
    stride)`` outputs, the odd pad on the high side."""
    pads = _conv_padding(padding, len(in_sp))
    if pads == "VALID":
        return [(0, 0)] * len(in_sp)
    if pads == "SAME":
        out = []
        for i, k, s, d in zip(in_sp, ksize, stride, dilation):
            total = max((-(-i // s) - 1) * s + (k - 1) * d + 1 - i, 0)
            out.append((total // 2, total - total // 2))
        return out
    if isinstance(pads, str):
        raise ValueError(f"padding {padding!r}: expected 'SAME' or 'VALID'")
    return [(int(lo), int(hi)) for lo, hi in pads]


def _pad_spatial(x_nchw, pads, value: float):
    """Pad H and W of an NCHW tensor with (lo, hi) pairs."""
    (hl, hh), (wl, wh) = pads
    return F.pad(x_nchw, (wl, wh, hl, hh), value=value)


def _to_nchw(x, channel_last: bool):
    # an NHWC tensor viewed as NCHW: channels-last memory, no copy, and
    # cuDNN / the pooling kernels then run in NHWC
    return x.permute(0, 3, 1, 2) if channel_last else x


def _from_nchw(y, channel_last: bool):
    return y.permute(0, 2, 3, 1) if channel_last else y


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """``nn_functional.py:287-302``. ``weight`` is ``[out, in/groups, kh,
    kw]`` whatever ``data_format`` is. XLA's convolution in the JAX
    package; cuDNN here (no kernel of the JAX package's own)."""
    channel_last = data_format in ("NHWC", "NLC", "NDHWC")
    stride = _norm_tuple(stride, 2)
    dilation = _norm_tuple(dilation, 2)
    xin = _to_nchw(x, channel_last)
    pads = _explicit_pads(padding, tuple(xin.shape[2:]),
                          tuple(weight.shape[2:]), stride, dilation)
    if all(lo == hi for lo, hi in pads):
        out = F.conv2d(xin, weight, bias, stride, [lo for lo, _ in pads],
                       dilation, groups)
    else:
        out = F.conv2d(_pad_spatial(xin, pads, 0.0), weight, bias, stride, 0,
                       dilation, groups)
    return _from_nchw(out, channel_last)


def _pool_args(x_nchw, kernel_size, stride, padding):
    ksize = _norm_tuple(kernel_size, 2)
    stride = _norm_tuple(stride if stride is not None else ksize, 2)
    pads = _explicit_pads(padding, tuple(x_nchw.shape[2:]), ksize, stride,
                          (1, 1))
    return ksize, stride, pads


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    """``nn_functional.py:431-465``: the window max with -inf padding
    (the dtype's minimum for integers). ``ceil_mode`` is ignored, as the
    JAX package's ``_pool`` ignores it."""
    if return_mask:
        raise NotImplementedError("max_pool2d(return_mask=True) is not yet "
                                  "ported, see ROADMAP.md")
    channel_last = data_format == "NHWC"
    xin = _to_nchw(x, channel_last)
    ksize, stride, pads = _pool_args(xin, kernel_size, stride, padding)
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, ksize)):
        # torch pads with -inf itself when the pad is symmetric and at
        # most half the window
        out = F.max_pool2d(xin, ksize, stride, [lo for lo, _ in pads])
    else:
        low = (-math.inf if x.dtype.is_floating_point
               else torch.iinfo(x.dtype).min)
        out = F.max_pool2d(_pad_spatial(xin, pads, low), ksize, stride, 0)
    return _from_nchw(out, channel_last)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    """``nn_functional.py:512-526``: the window sum over zero padding,
    divided by ``divisor_override``, else by the count of unpadded
    positions (``exclusive`` with numeric padding), else by the window
    size (also for ``'SAME'``/``'VALID'``, as in the JAX package)."""
    channel_last = data_format == "NHWC"
    xin = _to_nchw(x, channel_last)
    ksize, stride, pads = _pool_args(xin, kernel_size, stride, padding)
    summed = F.avg_pool2d(_pad_spatial(xin, pads, 0.0), ksize, stride, 0,
                          divisor_override=1)
    if divisor_override:
        out = summed / divisor_override
    elif exclusive and not isinstance(padding, str):
        ones = torch.ones((1, 1) + tuple(xin.shape[2:]), dtype=x.dtype,
                          device=x.device)
        counts = F.avg_pool2d(_pad_spatial(ones, pads, 0.0), ksize, stride,
                              0, divisor_override=1)
        out = summed / counts
    else:
        out = summed / (ksize[0] * ksize[1])
    return _from_nchw(out.to(x.dtype), channel_last)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """``nn_functional.py:576-614``: a plain average pool when each input
    size divides by its output size; otherwise the mean over the windows
    ``[floor(i*in/out), ceil((i+1)*in/out))``, one spatial axis after the
    other, as the JAX package computes it."""
    channel_last = data_format == "NHWC"
    out_size = _norm_tuple(output_size, 2)
    sp_axes = (1, 2) if channel_last else (2, 3)
    in_size = tuple(x.shape[a] for a in sp_axes)
    if all(i % o == 0 for i, o in zip(in_size, out_size)):
        k = tuple(i // o for i, o in zip(in_size, out_size))
        return avg_pool2d(x, k, k, 0, data_format=data_format)
    out = x
    for ax, osz in zip(sp_axes, out_size):
        isz = out.shape[ax]
        pieces = []
        for j in range(osz):
            s, e = (j * isz) // osz, ((j + 1) * isz + osz - 1) // osz
            pieces.append(out.narrow(ax, s, e - s).mean(dim=ax, keepdim=True))
        out = torch.cat(pieces, dim=ax)
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW"):
    """``nn_functional.py:685-715``; returns ``(out, new_mean,
    new_var)``. Training normalises with the batch statistics, the
    biased variance ``E[x^2] - E[x]^2`` in f32, and updates the running
    ones the JAX (and Paddle) way, ``momentum * old + (1 - momentum) *
    new`` (torch's ``F.batch_norm`` weighs the other way and keeps the
    unbiased variance, so it is not used)."""
    ch = 1 if data_format.startswith("NC") and x.dim() > 1 else x.dim() - 1
    axes = [i for i in range(x.dim()) if i != ch]
    if training:
        xf = x.to(torch.float32)
        mean = xf.mean(dim=axes)
        var = torch.clamp_min((xf * xf).mean(dim=axes) - mean * mean, 0.0)
        new_rm = momentum * running_mean + (1.0 - momentum) * mean.detach()
        new_rv = momentum * running_var + (1.0 - momentum) * var.detach()
    else:
        mean, var = running_mean, running_var
        new_rm, new_rv = running_mean, running_var
    shape = [1] * x.dim()
    shape[ch] = -1
    out = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                  + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out.to(x.dtype), new_rm, new_rv
