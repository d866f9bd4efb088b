"""Kernel selection and the functional ops of the serving, training and
vision paths (port of ``paddle_tpu/ops/nn_functional.py``: attention,
sampling, dropout, activations, embedding, convolution, pooling,
normalisation, the losses and the resampling ops).

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
import itertools
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ..amp.auto_cast import amp_cast
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


def weak_scalar(value: float, like: torch.Tensor) -> float:
    """A Python number as JAX's weak typing reads it beside ``like``:
    rounded to ``like``'s dtype (0.9 beside a bf16 tensor is 0.8984375).
    PyTorch would multiply a bf16 tensor by the float32 0.9."""
    return float(torch.tensor(value, dtype=like.dtype))


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


def _reduce(loss, reduction):
    """``nn_functional.py:972-977``: ``"mean"``, ``"sum"``, anything else
    unreduced."""
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _take_along_axis(arr, idx, axis: int):
    """``jnp.take_along_axis`` as JAX reads it: the dims other than
    ``axis`` broadcast, a negative index counts from the end and one
    outside the axis gives NaN (a floating ``arr``) or 0."""
    axis = axis % arr.dim()
    size = arr.shape[axis]
    rest = torch.broadcast_shapes(
        tuple(1 if i == axis else s for i, s in enumerate(arr.shape)),
        tuple(1 if i == axis else s for i, s in enumerate(idx.shape)))
    a_shape, i_shape = list(rest), list(rest)
    a_shape[axis], i_shape[axis] = size, idx.shape[axis]
    idx = idx.long().expand(i_shape)
    idx = torch.where(idx < 0, idx + size, idx)
    inside = (idx >= 0) & (idx < size)
    out = torch.gather(arr.expand(a_shape), axis,
                       torch.where(inside, idx, 0))
    fill = float("nan") if out.is_floating_point() else 0
    return torch.where(inside, out, torch.full((), fill, dtype=out.dtype,
                                               device=out.device))


def _take_weight(weight, label):
    """``jnp.take(weight, jnp.clip(label, 0, None))`` as JAX reads it: a
    label past the last class (an ``ignore_index`` of 255, say) gives
    NaN, which the caller's ``valid`` mask then drops."""
    idx = label.long().clamp_min(0)
    inside = idx < weight.shape[0]
    w = weight[torch.where(inside, idx, 0)]
    return torch.where(inside, w, torch.full((), float("nan"),
                                             dtype=w.dtype,
                                             device=w.device))


def _log_probs(logits, axis, use_softmax):
    if use_softmax:
        return torch.log_softmax(logits, dim=axis)
    return torch.log(torch.clamp_min(logits, 1e-15))


def _cross_entropy(logits, label, weight, ignore_index, reduction,
                   soft_label, axis, use_softmax, label_smoothing):
    if soft_label:
        logp = _log_probs(logits, axis, use_softmax)
        tgt = label
        if label_smoothing > 0.0:
            tgt = (1 - label_smoothing) * tgt + \
                label_smoothing / logits.shape[axis]
        return _reduce(-torch.sum(tgt * logp, dim=axis), reduction)
    label = label.to(torch.int32)
    if label.dim() == logits.dim():
        label = label.squeeze(axis)
    logp = _log_probs(logits, axis, use_softmax)
    if label_smoothing > 0.0:
        nll = -_take_along_axis(logp, label[..., None], axis)[..., 0]
        smooth = -torch.mean(logp, dim=axis)
        loss = (1 - label_smoothing) * nll + label_smoothing * smooth
    else:
        loss = -_take_along_axis(logp, label.unsqueeze(axis),
                                 axis).squeeze(axis)
    valid = label != ignore_index
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    if weight is not None:
        w = _take_weight(weight, label)
        loss = loss * w
        if reduction == "mean":
            denom = torch.where(valid, w, torch.zeros_like(w)).sum()
            return torch.where(valid, loss, zero).sum() / torch.clamp_min(
                denom, 1e-12)
    loss = torch.where(valid, loss, zero)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1)
    return _reduce(loss, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """``nn_functional.py:986-1027``, with its signature in its order.
    Hard labels: positions whose label is ``ignore_index`` give 0;
    ``"mean"`` divides by the number of the others, or under ``weight``
    by the sum of their picked class weights. ``soft_label`` takes a
    distribution (``weight`` and ``ignore_index`` unused there);
    ``use_softmax=False`` reads ``input`` as probabilities;
    ``label_smoothing`` mixes in the uniform distribution. A
    ``reduction`` other than ``"mean"`` / ``"sum"`` returns the
    per-position losses, as the JAX function's ``_reduce`` does."""
    input, label, weight = amp_cast(  # noqa: A001
        "cross_entropy", input, label, weight)
    return _cross_entropy(input, label, weight, ignore_index, reduction,
                          soft_label, axis, use_softmax, label_smoothing)


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, scale=None,
                                 generator=None, use_flash=None):
    """q, k, v: [B, S, H, D]. ``use_flash``: None = the kernels from the
    JAX package's measured crossovers, True = a kernel whenever its gate
    admits, False = never (``nn_functional.py:799-866``). The kernels
    take no mask and no active dropout; they differentiate through their
    backward kernels. Dropout on the plain path draws from
    ``generator`` or the :func:`core.rng.key_scope` generator."""
    q, k, v, attn_mask = amp_cast("scaled_dot_product_attention", q, k, v,
                                  attn_mask)
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


def paged_page_splice(pool, block, page=0):
    """Write restored page content into ``pool`` [P+1, page, ...] in
    place at the page indices ``page`` (an int or [n] ints):
    ``block`` is [page, ...] for one index or [n, page, ...] for n
    (``nn_functional.py:943-953``; the JAX op returns an updated pool,
    here ``index_copy_`` updates it, as the appends of
    ``paged_kv_append`` do). Returns ``pool``."""
    idx = torch.as_tensor(page, dtype=torch.long,
                          device=pool.device).reshape(-1)
    blk = block.to(device=pool.device, dtype=pool.dtype).reshape(
        (idx.numel(),) + tuple(pool.shape[1:]))
    pool.index_copy_(0, idx, blk)
    return pool


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


# -- activations --------------------------------------------------------------
# nn_functional.py:26-169 and :1398; the formulas are the JAX package's

def relu(x):
    """``nn_functional.py:26``."""
    return torch.relu(x)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def prelu(x, weight):
    """``weight`` of one element, or one a channel on axis 1."""
    if weight.numel() > 1:
        shape = [1] * x.dim()
        shape[1] = weight.numel()
        weight = weight.reshape(shape)
    return torch.where(x >= 0, x, weight * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True,
          generator=None):
    """In training each negative element takes a slope drawn uniformly
    from ``[lower, upper)`` (from ``generator``, else the
    :func:`core.rng.key_scope` generator); in eval the mean slope."""
    if training:
        gen = generator if generator is not None else rng.next_generator()
        slope = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        slope.uniform_(lower, upper, generator=gen)
    else:
        slope = (lower + upper) / 2.0
    return torch.where(x >= 0, x, slope * x)


def elu(x, alpha=1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0):
    return F.celu(x, alpha)


def gelu(x, approximate: bool = False):
    """``nn_functional.py:69``: the exact (erf) form by default, the
    tanh form for ``approximate=True``. BERT's ``hidden_act="gelu"``
    is the exact one; GPT's MLP calls ``nn.layers.gelu``, the tanh
    form. The exact form keeps ``+inf`` as ``jax.nn.gelu`` does (torch's
    vectorised CPU loop gives NaN there); ``-inf`` gives NaN in both."""
    if approximate:
        return F.gelu(x, approximate="tanh")
    return torch.where(x == math.inf, x, F.gelu(x, approximate="none"))


def silu(x):
    return F.silu(x)


swish = silu


def mish(x):
    return F.mish(x)


def sigmoid(x):
    return torch.sigmoid(x)


def log_sigmoid(x):
    return F.logsigmoid(x)


def hardsigmoid(x, slope=1.0 / 6.0, offset=0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0):  # noqa: A002
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def tanhshrink(x):
    return x - torch.tanh(x)


def softplus(x, beta=1.0, threshold=20.0):
    return torch.where(beta * x > threshold, x,
                       torch.log1p(torch.exp(beta * x)) / beta)


def softsign(x):
    return x / (1.0 + torch.abs(x))


def tanh(x):
    return torch.tanh(x)


def as_dtype(dtype):
    """A torch dtype from a torch dtype or its name (``"float32"``); None
    stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def softmax(x, axis=-1, dtype=None):
    (x,) = amp_cast("softmax", x)
    if dtype is not None:
        x = x.to(as_dtype(dtype))
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None):
    (x,) = amp_cast("log_softmax", x)
    if dtype is not None:
        x = x.to(as_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, generator=None):
    """``softmax((x + g) / temperature)`` with standard Gumbel noise
    ``g = -log(-log(u))`` drawn from ``generator`` (else the
    :func:`core.rng.key_scope` generator); ``hard`` returns the one-hot
    of the argmax with the soft gradient (straight-through)."""
    gen = generator if generator is not None else rng.next_generator()
    u = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    u.uniform_(0.0, 1.0, generator=gen)
    u = u.clamp_min(torch.finfo(x.dtype).tiny)
    g = -torch.log(-torch.log(u))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = (y_hard - y).detach() + y
    return y


def maxout(x, groups, axis=1):
    axis = axis % x.dim()
    shape = list(x.shape)
    shape[axis] = x.shape[axis] // groups
    shape.insert(axis + 1, groups)
    return torch.amax(x.reshape(shape), dim=axis + 1)


def glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, torch.zeros_like(x)).to(x.dtype)


# -- lookups, dropouts ---------------------------------------------------------

def embedding(x, weight, padding_idx=None, sparse=False):
    """``nn_functional.py:180-185``: the rows of ``weight`` at ``x``,
    zero where ``x == padding_idx``. ``sparse`` changes nothing, as in
    the JAX function (the gradient is dense)."""
    out = F.embedding(x, weight)
    if padding_idx is not None:
        out = out * (x != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


def dropout2d(x, p=0.5, training=True, data_format="NCHW", generator=None):
    """Whole channels (``nn_functional.py:219``)."""
    axis = (0, 1) if data_format == "NCHW" else (0, 3)
    return dropout(x, p, training, axis=axis, generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW",
              generator=None):
    axis = (0, 1) if data_format == "NCDHW" else (0, 4)
    return dropout(x, p, training, axis=axis, generator=generator)


def alpha_dropout(x, p=0.5, training=True, generator=None):
    """SELU-preserving dropout (``nn_functional.py:229-239``): dropped
    elements take ``-alpha * scale``, then the affine map that keeps the
    mean and variance."""
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    gen = generator if generator is not None else rng.next_generator()
    keep = torch.rand(x.shape, device=x.device, generator=gen) < (1.0 - p)
    a = (1.0 / math.sqrt((1.0 - p) * (1.0 + p * alpha_p ** 2))) \
        if p < 1 else 0.0
    b = -a * alpha_p * p
    kept = torch.where(keep, x, torch.full((), alpha_p, dtype=x.dtype,
                                           device=x.device))
    return (a * kept + b).to(x.dtype)


# -- convolution ----------------------------------------------------------------

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


def _pad_spatial(x_cf, pads, value: float):
    """Pad the spatial dims of a channels-first tensor with (lo, hi)
    pairs; negative entries crop."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x_cf, flat, value=value)


def _to_nchw(x, channel_last: bool):
    # a channels-last tensor viewed channels-first: channels-last memory,
    # no copy, and cuDNN / the pooling kernels then run channels-last
    return torch.movedim(x, -1, 1) if channel_last else x


def _from_nchw(y, channel_last: bool):
    return torch.movedim(y, 1, -1) if channel_last else y


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _conv(name, x, weight, bias, stride, padding, dilation, groups,
          channel_last, nsp):
    """``lax.conv_general_dilated`` of the JAX package, on cuDNN (no
    kernel of the JAX package's own): ``weight`` is ``[out, in/groups,
    *k]`` whatever the layout."""
    x, weight, bias = amp_cast(name, x, weight, bias)
    stride = _norm_tuple(stride, nsp)
    dilation = _norm_tuple(dilation, nsp)
    xin = _to_nchw(x, channel_last)
    pads = _explicit_pads(padding, tuple(xin.shape[2:]),
                          tuple(weight.shape[2:]), stride, dilation)
    conv = _CONV[nsp]
    if all(lo == hi for lo, hi in pads):
        out = conv(xin, weight, bias, stride, [lo for lo, _ in pads],
                   dilation, groups)
    else:
        out = conv(_pad_spatial(xin, pads, 0.0), weight, bias, stride, 0,
                   dilation, groups)
    return _from_nchw(out, channel_last)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    """``nn_functional.py:305``; ``weight [out, in/groups, k]``."""
    return _conv("conv1d", x, weight, bias, stride, padding, dilation,
                 groups, data_format == "NLC", 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """``nn_functional.py:287-302``. ``weight`` is ``[out, in/groups, kh,
    kw]`` whatever ``data_format`` is."""
    return _conv("conv2d", x, weight, bias, stride, padding, dilation,
                 groups, data_format in ("NHWC", "NLC", "NDHWC"), 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    """``nn_functional.py:321``; ``weight [out, in/groups, kd, kh, kw]``."""
    return _conv("conv3d", x, weight, bias, stride, padding, dilation,
                 groups, data_format == "NDHWC", 3)


def _out_padding_from_size(in_sp, output_size, stride, padding, dilation,
                           ksp, nsp):
    """The ``output_padding`` that gives ``output_size`` (``nn_functional.
    py:337-362``); each must lie in ``[0, stride)``."""
    st = _norm_tuple(stride, nsp)
    dl = _norm_tuple(dilation, nsp)
    osz = _norm_tuple(output_size, nsp)
    op = []
    for i in range(nsp):
        if isinstance(padding, str):
            if padding.upper() == "SAME":
                base = in_sp[i] * st[i]
            else:
                base = (in_sp[i] - 1) * st[i] + dl[i] * (ksp[i] - 1) + 1
        else:
            pd = _norm_tuple(padding, nsp)
            base = (in_sp[i] - 1) * st[i] - 2 * pd[i] + \
                dl[i] * (ksp[i] - 1) + 1
        op.append(int(osz[i]) - base)
    if any(o < 0 or o >= st[i] for i, o in enumerate(op)):
        raise ValueError(
            f"output_size {tuple(int(o) for o in osz)} unreachable from "
            f"input {tuple(in_sp)}: derived output_padding {op} must be "
            f"in [0, stride) per dim (stride {st})")
    return tuple(op)


def _conv_transpose(x, weight, bias, stride, pads, output_padding,
                    dilation, groups, channel_last, nsp):
    """The JAX transposed convolution (``nn_functional.py:365-404``: the
    flipped, regrouped ``[in, out/groups, *k]`` weight over the input
    dilated by ``stride``, padded ``k_eff - 1 - lo`` and ``k_eff - 1 -
    hi + output_padding``). ``F.conv_transpose*d`` computes the same
    product with no padding; the (lo, hi) pads and the output padding
    then crop or extend its ends, which takes any pads, asymmetric ones
    included, and any output padding."""
    stride = _norm_tuple(stride, nsp)
    dilation = _norm_tuple(dilation, nsp)
    out_pad = _norm_tuple(output_padding, nsp)
    xin = _to_nchw(x, channel_last)
    full = _CONV_T[nsp](xin, weight, None, stride, 0, 0, groups, dilation)
    out = _pad_spatial(full, [(-lo, -hi + op)
                              for (lo, hi), op in zip(pads, out_pad)], 0.0)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nsp)
    return _from_nchw(out, channel_last)


def _transpose_pads(padding, nsp, what):
    pads = _conv_padding(padding, nsp)
    if pads == "VALID":
        return [(0, 0)] * nsp
    if isinstance(pads, str):
        # the JAX function has no pads for 'SAME' and fails indexing them
        raise ValueError(f"{what}: padding={padding!r} is not supported by "
                         f"the transposed convolution; give explicit pads "
                         f"or 'VALID'")
    return [(int(lo), int(hi)) for lo, hi in pads]


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCHW"):
    """``nn_functional.py:365-404``; ``weight [in, out/groups, kh, kw]``.
    ``output_size`` sets ``output_padding`` (``_out_padding_from_size``).
    ``padding='SAME'`` raises (the JAX function fails on it)."""
    x, weight, bias = amp_cast("conv2d_transpose", x, weight, bias)
    if output_size is not None:
        sp = x.shape[1:3] if data_format == "NHWC" else x.shape[2:4]
        output_padding = _out_padding_from_size(
            tuple(sp), output_size, stride, padding, dilation,
            tuple(weight.shape[2:4]), 2)
    return _conv_transpose(x, weight, bias, stride,
                           _transpose_pads(padding, 2, "conv2d_transpose"),
                           output_padding, dilation, groups,
                           data_format == "NHWC", 2)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCL"):
    """``nn_functional.py:407-428``: ``conv2d_transpose`` over a unit
    trailing spatial dim, with the JAX function's reading of the
    arguments (a list ``padding`` gives its first entry)."""
    x, weight, bias = amp_cast("conv1d_transpose", x, weight, bias)
    if output_size is not None:
        sp = (x.shape[1],) if data_format == "NLC" else (x.shape[2],)
        output_padding = _out_padding_from_size(
            sp, output_size, stride, padding, dilation,
            (weight.shape[2],), 1)[0]
    x4 = x.unsqueeze(-1 if data_format == "NCL" else 2)
    w4 = weight.unsqueeze(-1)
    out = conv2d_transpose(
        x4, w4, bias, stride=(_norm_tuple(stride, 1)[0], 1),
        padding=(_norm_tuple(padding, 1)[0], 0) if isinstance(
            padding, (int, list, tuple)) else padding,
        output_padding=(_norm_tuple(output_padding, 1)[0], 0),
        dilation=(_norm_tuple(dilation, 1)[0], 1), groups=groups,
        data_format="NCHW" if data_format == "NCL" else "NHWC")
    return out.squeeze(-1 if data_format == "NCL" else 2)


# -- pooling ----------------------------------------------------------------------
# nn_functional.py:431-660; ceil_mode is ignored, as the JAX _pool ignores it

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_args(x_cf, kernel_size, stride, padding, nsp):
    ksize = _norm_tuple(kernel_size, nsp)
    stride = _norm_tuple(stride if stride is not None else ksize, nsp)
    pads = _explicit_pads(padding, tuple(x_cf.shape[2:]), ksize, stride,
                          (1,) * nsp)
    return ksize, stride, pads


def _max_pool(x, kernel_size, stride, padding, channel_last, nsp):
    """The window max over ``-inf`` padding (the dtype's minimum for
    integers)."""
    xin = _to_nchw(x, channel_last)
    ksize, stride, pads = _pool_args(xin, kernel_size, stride, padding, nsp)
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, ksize)):
        # torch pads with -inf itself when the pad is symmetric and at
        # most half the window
        out = _MAX_POOL[nsp](xin, ksize, stride, [lo for lo, _ in pads])
    else:
        low = (-math.inf if x.dtype.is_floating_point
               else torch.iinfo(x.dtype).min)
        out = _MAX_POOL[nsp](_pad_spatial(xin, pads, low), ksize, stride, 0)
    return _from_nchw(out, channel_last)


def _avg_pool(x, kernel_size, stride, padding, exclusive, divisor_override,
              channel_last, nsp):
    """The window sum over zero padding, divided by ``divisor_override``,
    else by the count of unpadded positions (``exclusive`` with numeric
    padding), else by the window size (also for ``'SAME'`` / ``'VALID'``,
    as in the JAX package)."""
    xin = _to_nchw(x, channel_last)
    ksize, stride, pads = _pool_args(xin, kernel_size, stride, padding, nsp)

    def window_sum(t):
        return _AVG_POOL[nsp](_pad_spatial(t, pads, 0.0), ksize, stride, 0,
                              divisor_override=1)

    summed = window_sum(xin)
    if divisor_override:
        out = summed / divisor_override
    elif exclusive and not isinstance(padding, str):
        ones = torch.ones((1, 1) + tuple(xin.shape[2:]), dtype=x.dtype,
                          device=x.device)
        out = summed / window_sum(ones)
    else:
        out = summed / math.prod(ksize)
    return _from_nchw(out.to(x.dtype), channel_last)


def _max_pool_indices(x, kernel_size, stride, padding, channel_last):
    """The JAX package's max-pool mask (``nn_functional.py:468-505``): for
    each window the flat index, in the input plane, of its first maximum
    in the window's row-major scan, int32. Padded positions read -inf
    and index -1; a ``'SAME'`` / ``'VALID'`` padding is taken as none,
    as there. A NaN counts as the maximum, as ``jnp.argmax`` counts it.
    The windows are walked offset by offset with a strict comparison,
    which fixes the tie order on every device (torch's
    ``return_indices`` leaves it to the backend)."""
    nsp = x.dim() - 2
    ksize = _norm_tuple(kernel_size, nsp)
    st = _norm_tuple(stride if stride is not None else kernel_size, nsp)
    xc = _to_nchw(x, channel_last)
    spatial = tuple(xc.shape[2:])
    lin = torch.arange(math.prod(spatial), device=x.device).reshape(spatial)
    pads = _conv_padding(padding, nsp)
    if isinstance(pads, str):
        pads = [(0, 0)] * nsp
    xp = _pad_spatial(xc, pads, -math.inf)
    lp = _pad_spatial(lin, pads, -1)
    out_sp = [(xp.shape[2 + i] - ksize[i]) // st[i] + 1 for i in range(nsp)]
    best = idx = None
    for offs in itertools.product(*(range(k) for k in ksize)):
        sl = tuple(slice(o, o + n * s, s)
                   for o, n, s in zip(offs, out_sp, st))
        v = xp[(slice(None), slice(None)) + sl]
        l_ = lp[sl].expand_as(v)
        if best is None:
            best, idx = v, l_
            continue
        take = (v > best) | (torch.isnan(v) & ~torch.isnan(best))
        best = torch.where(take, v, best)
        idx = torch.where(take, l_, idx)
    return _from_nchw(idx.to(torch.int32), channel_last)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    """``nn_functional.py:454-465``: the window max with -inf padding;
    ``return_mask`` adds :func:`_max_pool_indices`."""
    channel_last = data_format == "NHWC"
    out = _max_pool(x, kernel_size, stride, padding, channel_last, 2)
    if return_mask:
        return out, _max_pool_indices(x, kernel_size, stride, padding,
                                      channel_last)
    return out


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    """``nn_functional.py:512-526``."""
    return _avg_pool(x, kernel_size, stride, padding, exclusive,
                     divisor_override, data_format == "NHWC", 2)


def _pool1d_args(kernel_size, stride, padding):
    return ((_norm_tuple(kernel_size, 1)[0], 1),
            (_norm_tuple(stride, 1)[0], 1) if stride else None,
            (_norm_tuple(padding, 1)[0], 0) if isinstance(padding, int)
            else padding)


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False):
    """``nn_functional.py:529-539``: ``max_pool2d`` over a unit trailing
    dim of ``[N, C, L]``."""
    k, s, p = _pool1d_args(kernel_size, stride, padding)
    out = max_pool2d(x.unsqueeze(-1), k, s, p, ceil_mode, return_mask)
    if return_mask:
        return out[0].squeeze(-1), out[1].squeeze(-1)
    return out.squeeze(-1)


def avg_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True):
    k, s, p = _pool1d_args(kernel_size, stride, padding)
    return avg_pool2d(x.unsqueeze(-1), k, s, p, ceil_mode,
                      exclusive).squeeze(-1)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW"):
    """``nn_functional.py:553-558``; ``return_mask`` is read and
    ignored there, and here."""
    return _max_pool(x, kernel_size, stride, padding,
                     data_format == "NDHWC", 3)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW"):
    return _avg_pool(x, kernel_size, stride, padding, exclusive,
                     divisor_override, data_format == "NDHWC", 3)


def _adaptive_pool_general(x, out_size, sp_axes, mode):
    """Mean or max over the windows ``[floor(i*in/out), ceil((i+1)*in/
    out))``, one spatial axis after the other (``nn_functional.py:
    601-614``)."""
    out = x
    for ax, osz in zip(sp_axes, out_size):
        isz = out.shape[ax]
        pieces = []
        for j in range(osz):
            s, e = (j * isz) // osz, ((j + 1) * isz + osz - 1) // osz
            seg = out.narrow(ax, s, e - s)
            pieces.append(seg.mean(dim=ax, keepdim=True) if mode == "avg"
                          else seg.amax(dim=ax, keepdim=True))
        out = torch.cat(pieces, dim=ax)
    return out


def _adaptive_axes(x, output_size, channel_last, nsp):
    out_size = _norm_tuple(output_size, nsp)
    sp_axes = tuple(range(1, 1 + nsp)) if channel_last else \
        tuple(range(2, 2 + nsp))
    in_size = tuple(x.shape[a] for a in sp_axes)
    return out_size, sp_axes, in_size


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """``nn_functional.py:576-585``: a plain average pool when each input
    size divides by its output size, else the general windows."""
    out_size, sp_axes, in_size = _adaptive_axes(
        x, output_size, data_format == "NHWC", 2)
    if all(i % o == 0 for i, o in zip(in_size, out_size)):
        k = tuple(i // o for i, o in zip(in_size, out_size))
        return avg_pool2d(x, k, k, 0, data_format=data_format)
    return _adaptive_pool_general(x, out_size, sp_axes, "avg")


def adaptive_max_pool2d(x, output_size, return_mask=False,
                        data_format="NCHW"):
    """``nn_functional.py:588-598``: ``max_pool2d`` (with its mask) when
    the sizes divide; else the general windows, without a mask, as
    there."""
    out_size, sp_axes, in_size = _adaptive_axes(
        x, output_size, data_format == "NHWC", 2)
    if all(i % o == 0 for i, o in zip(in_size, out_size)):
        k = tuple(i // o for i, o in zip(in_size, out_size))
        return max_pool2d(x, k, k, 0, return_mask=return_mask,
                          data_format=data_format)
    return _adaptive_pool_general(x, out_size, sp_axes, "max")


def adaptive_avg_pool1d(x, output_size):
    return adaptive_avg_pool2d(x.unsqueeze(-1),
                               (output_size, 1)).squeeze(-1)


def _first_argmax(win):
    """The index of the first maximum along the last dim (a NaN counts as
    the maximum, as in ``jnp.argmax``), the same on every device."""
    best = win[..., 0]
    idx = torch.zeros(best.shape, dtype=torch.int64, device=win.device)
    for j in range(1, win.shape[-1]):
        v = win[..., j]
        take = (v > best) | (torch.isnan(v) & ~torch.isnan(best))
        best = torch.where(take, v, best)
        idx = torch.where(take, torch.full_like(idx, j), idx)
    return idx


def adaptive_max_pool1d(x, output_size, return_mask=False):
    """``nn_functional.py:622-636``; the mask (int64, input positions)
    needs a length divisible by ``output_size``, as there."""
    out = adaptive_max_pool2d(x.unsqueeze(-1), (output_size, 1)).squeeze(-1)
    if not return_mask:
        return out
    n, c, length = x.shape
    o = int(output_size)
    if length % o:
        raise NotImplementedError(
            "return_mask needs input length divisible by output_size")
    k = length // o
    idx = _first_argmax(x.reshape(n, c, o, k))
    idx = idx + torch.arange(o, device=x.device)[None, None] * k
    return out, idx.to(torch.int64)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    """``nn_functional.py:639-642``: always the general windows."""
    out_size, sp_axes, _ = _adaptive_axes(x, output_size,
                                          data_format == "NDHWC", 3)
    return _adaptive_pool_general(x, out_size, sp_axes, "avg")


def adaptive_max_pool3d(x, output_size, return_mask=False,
                        data_format="NCDHW"):
    out_size, sp_axes, in_size = _adaptive_axes(
        x, output_size, data_format == "NDHWC", 3)
    if all(i % o == 0 for i, o in zip(in_size, out_size)):
        k = tuple(i // o for i, o in zip(in_size, out_size))
        return max_pool3d(x, k, k, 0, data_format=data_format)
    return _adaptive_pool_general(x, out_size, sp_axes, "max")


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW"):
    """``(sum |x|^p)^(1/p)`` over each window (``nn_functional.py:
    1386-1395``)."""
    p = float(norm_type)
    pooled = avg_pool2d(torch.abs(x) ** p, kernel_size, stride, padding,
                        ceil_mode=ceil_mode, exclusive=False,
                        data_format=data_format)
    k = _norm_tuple(kernel_size, 2)
    return (pooled * (k[0] * k[1])) ** (1.0 / p)


# -- normalisation --------------------------------------------------------------

def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """``nn_functional.py:662-673``, over the trailing ``normalized_shape``
    dims. An input of another dtype than the parameters is normalised in
    the parameters' dtype and returned in its own, as in
    ``nn.LayerNorm`` (PyTorch's CUDA layer norm takes no mixed
    dtypes)."""
    x, weight, bias = amp_cast("layer_norm", x, weight, bias)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dt = weight.dtype if weight is not None else x.dtype
    return F.layer_norm(x.to(dt), tuple(normalized_shape), weight, bias,
                        epsilon).to(x.dtype)


def rms_norm(x, weight=None, epsilon=1e-6, axis=-1):
    """``nn_functional.py:676-682``: the mean square in f32, the scale
    cast to ``x``'s dtype."""
    x, weight = amp_cast("rms_norm", x, weight)
    var = torch.mean(torch.square(x.to(torch.float32)), dim=axis,
                     keepdim=True)
    out = x * torch.rsqrt(var + epsilon).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW"):
    """``nn_functional.py:685-715``; returns ``(out, new_mean,
    new_var)``. Training normalises with the batch statistics, the
    biased variance ``E[x^2] - E[x]^2`` in f32, and updates the running
    ones the JAX (and Paddle) way, ``momentum * old + (1 - momentum) *
    new`` (torch's ``F.batch_norm`` weighs the other way and keeps the
    unbiased variance, so it is not used). Dtypes follow the JAX
    promotion: a bf16 input with f32 statistics normalises in f32 (with
    bf16 or f32 affine parameters) and returns bf16; the running
    statistics stay in their own dtype."""
    x, running_mean, running_var, weight, bias = amp_cast(
        "batch_norm", x, running_mean, running_var, weight, bias)
    ch = 1 if data_format.startswith("NC") and x.dim() > 1 else x.dim() - 1
    axes = [i for i in range(x.dim()) if i != ch]
    if training:
        xf = x.to(torch.float32)
        mean = xf.mean(dim=axes)
        var = torch.clamp_min((xf * xf).mean(dim=axes) - mean * mean, 0.0)
        new_rm = (weak_scalar(momentum, running_mean) * running_mean
                  + (1.0 - momentum) * mean.detach())
        new_rv = (weak_scalar(momentum, running_var) * running_var
                  + (1.0 - momentum) * var.detach())
    else:
        mean, var = running_mean, running_var
        new_rm, new_rv = running_mean, running_var
    # x in the promoted dtype once, so that a bf16 input's gradient sums
    # its direct and its statistics terms (which nearly cancel) in f32
    # and rounds once, as XLA's fused backward does
    xc = x.to(torch.result_type(x, mean))
    shape = [1] * x.dim()
    shape[ch] = -1
    out = (xc - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                   + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out.to(x.dtype), new_rm, new_rv


def _affine_cf(out, weight, bias):
    shape = [1, -1] + [1] * (out.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def instance_norm(x, weight=None, bias=None, epsilon=1e-5):
    """``nn_functional.py:718-729``: per sample and channel over the
    spatial dims of a channels-first input."""
    x, weight, bias = amp_cast("instance_norm", x, weight, bias)
    axes = tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, unbiased=False, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    return _affine_cf(out, weight, bias).to(x.dtype)


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    """``nn_functional.py:732-750``."""
    x, weight, bias = amp_cast("group_norm", x, weight, bias)
    channel_last = data_format == "NHWC"
    xc = _to_nchw(x, channel_last)
    n, c = xc.shape[:2]
    g = xc.reshape((n, num_groups, c // num_groups) + tuple(xc.shape[2:]))
    axes = tuple(range(2, g.dim()))
    mean = g.mean(dim=axes, keepdim=True)
    var = g.var(dim=axes, unbiased=False, keepdim=True)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(xc.shape)
    out = _affine_cf(out, weight, bias)
    return _from_nchw(out, channel_last).to(x.dtype)


def normalize(x, p=2, axis=1, epsilon=1e-12):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    norm = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / torch.clamp_min(norm, epsilon)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW"):
    """``nn_functional.py:758-773``: ``x / (k + alpha * sum of squares
    over a window of `size` channels) ** beta``, the window's odd half
    after the channel."""
    (x,) = amp_cast("local_response_norm", x)
    channel_last = data_format == "NHWC"
    xc = _to_nchw(x, channel_last)
    half = size // 2
    sq = F.pad(torch.square(xc), [0, 0] * (xc.dim() - 2) +
               [half, size - 1 - half])
    c = xc.shape[1]
    window = sum(sq[:, i:i + c] for i in range(size))
    out = xc / torch.pow(k + alpha * window, beta)
    return _from_nchw(out, channel_last)


def data_norm(x, batch_size, batch_sum, batch_square_sum, epsilon=1e-4):
    """``nn_functional.py:1465-1472``: ``(x - batch_sum / batch_size) *
    sqrt(batch_size / max(batch_square_sum, epsilon))``."""
    mean = batch_sum / batch_size
    scale = torch.sqrt(batch_size / torch.clamp_min(batch_square_sum,
                                                    epsilon))
    return (x - mean) * scale


# -- losses (nn_functional.py:1030-1158, 1422-1462) --------------------------

def jmax(x, v):
    """``jnp.maximum(x, v)`` with JAX's gradient: at a tie each side takes
    half (``torch.clamp_min`` gives all of it to ``x``). It matters where
    a loss's argument is exactly at its kink, as zero logits are."""
    return torch.maximum(x, torch.as_tensor(v, dtype=x.dtype,
                                            device=x.device))


def jclip(x, lo=None, hi=None):
    """``jnp.clip``: :func:`jmax` then a minimum, half the gradient at
    either bound."""
    if lo is not None:
        x = jmax(x, lo)
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype,
                                             device=x.device))
    return x


def _sigmoid_ce(logit, target):
    """``max(z, 0) - z * t + log1p(exp(-|z|))`` (``nn_functional.py:
    980-983``), shared by the loss families."""
    return (jmax(logit, 0.0) - logit * target
            + torch.log1p(torch.exp(-torch.abs(logit))))


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False,
                               numeric_stable_mode=True):
    """``nn_functional.py:1030-1043``: the unreduced loss with ``axis``
    kept as a dim of 1, and the softmax when asked."""
    logits, label = amp_cast("softmax_with_cross_entropy", logits, label)
    sm = torch.softmax(logits, dim=axis)
    loss = _cross_entropy(logits, label, None, ignore_index, "none",
                          soft_label, axis, True, 0.0).unsqueeze(axis)
    if return_softmax:
        return loss, sm
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean"):
    """``nn_functional.py:1046-1061``: ``-input`` at the label, read along
    the last axis of a 2-D input and along axis 1 otherwise, through
    ``take_along_axis`` as JAX reads it."""
    input, label, weight = amp_cast(  # noqa: A001
        "nll_loss", input, label, weight)
    axis = -1 if input.dim() == 2 else 1
    loss = -_take_along_axis(input, label[..., None], axis).squeeze(axis)
    valid = label != ignore_index
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    if weight is not None:
        w = _take_weight(weight, label)
        loss = loss * w
        if reduction == "mean":
            return torch.where(valid, loss, zero).sum() / torch.where(
                valid, w, torch.zeros_like(w)).sum()
    loss = torch.where(valid, loss, zero)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1)
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean"):  # noqa: A002
    input, label = amp_cast("mse_loss", input, label)  # noqa: A001
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):  # noqa: A002
    diff = torch.abs(input - label)
    loss = torch.where(diff < delta, 0.5 * diff * diff / delta,
                       diff - 0.5 * delta)
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean"):
    """Probabilities clipped to ``[1e-12, 1 - 1e-12]``."""
    input, label, weight = amp_cast(  # noqa: A001
        "binary_cross_entropy", input, label, weight)
    x = jclip(input, 1e-12, 1.0 - 1e-12)
    loss = -(label * torch.log(x) + (1.0 - label) * torch.log1p(-x))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def _bce_with_logits(logit, label, weight, reduction, pos_weight):
    max_val = jclip(-logit, 0)
    soft = torch.log1p(torch.exp(-torch.abs(logit)))
    if pos_weight is not None:
        log_w = (pos_weight - 1.0) * label + 1.0
        loss = (1.0 - label) * logit + log_w * (soft + max_val)
    else:
        loss = (1.0 - label) * logit + max_val + soft
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    logit, label, weight, pos_weight = amp_cast(
        "binary_cross_entropy_with_logits", logit, label, weight,
        pos_weight)
    return _bce_with_logits(logit, label, weight, reduction, pos_weight)


def kl_div(input, label, reduction="mean"):  # noqa: A002
    """``label * (log(label) - input)``, ``label`` clipped at 1e-12 in the
    log; ``"batchmean"`` divides the sum by the batch."""
    input, label = amp_cast("kl_div", input, label)  # noqa: A001
    loss = label * (torch.log(torch.clamp_min(label, 1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean"):
    loss = jclip(-label * (input - other) + margin, 0)
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean"):
    loss = torch.where(label == 1.0, input, jclip(margin - input, 0))
    return _reduce(loss, reduction)


def _cosine_similarity(x1, x2, axis, eps):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / jmax(n1 * n2, eps)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """``dot / max(|x1| * |x2|, eps)``: the product of the norms is
    clamped, not each norm (``nn_functional.py:1123-1127``)."""
    x1, x2 = amp_cast("cosine_similarity", x1, x2)
    return _cosine_similarity(x1, x2, axis, eps)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    sim = _cosine_similarity(input1, input2, 1, 1e-8)
    loss = torch.where(label == 1, 1.0 - sim, jclip(sim - margin, 0))
    return _reduce(loss, reduction)


def triplet_margin_loss(anchor, positive, negative, margin=1.0, p=2.0,
                        eps=1e-6, swap=False, reduction="mean"):
    def dist(a, b):
        return torch.linalg.vector_norm(a - b + eps, ord=p, dim=-1)

    d_pos = dist(anchor, positive)
    d_neg = dist(anchor, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(jclip(d_pos - d_neg + margin, 0), reduction)


def square_error_cost(input, label):  # noqa: A002
    return torch.square(input - label)


def log_loss(input, label, epsilon=1e-4):  # noqa: A002
    return -label * torch.log(input + epsilon) - (1 - label) * torch.log(
        1 - input + epsilon)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                       gamma=2.0, reduction="sum"):
    p = torch.sigmoid(logit)
    ce = _bce_with_logits(logit, label, None, "none", None)
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def _softplus(x):
    # jax.nn.softplus: logaddexp(x, 0), no threshold
    return torch.logaddexp(x, torch.zeros_like(x))


def soft_margin_loss(input, label, reduction="mean"):  # noqa: A002
    """``log(1 + exp(-label * input))``, labels in {-1, 1}."""
    return _reduce(_softplus(-label.to(input.dtype) * input), reduction)


def multi_label_soft_margin_loss(input, label, weight=None,  # noqa: A002
                                 reduction="mean"):
    y = label.to(input.dtype)
    loss = -(y * F.logsigmoid(input) + (1.0 - y) * F.logsigmoid(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss.mean(dim=-1), reduction)


def poisson_nll_loss(input, label, log_input=True, full=False,  # noqa: A002
                     epsilon=1e-8, reduction="mean"):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        # the log of a safe argument, so that the branch not taken puts
        # no NaN into the gradient (label 0 is common)
        safe = torch.where(label > 1.0, label, torch.ones_like(label))
        stirling = safe * torch.log(safe) - safe + \
            0.5 * torch.log(2.0 * math.pi * safe)
        loss = loss + torch.where(label > 1.0, stirling,
                                  torch.zeros_like(stirling))
    return _reduce(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False,  # noqa: A002
                      epsilon=1e-6, reduction="mean"):
    var = jclip(variance, epsilon)
    loss = 0.5 * (torch.log(var) + (input - label) ** 2 / var)
    if full:
        loss = loss + 0.5 * torch.log(torch.tensor(
            2.0 * math.pi, dtype=input.dtype, device=input.device))
    return _reduce(loss, reduction)


# -- lookups and products of nn/common.py -------------------------------------

def linear(x, weight, bias=None):
    """``x @ weight + bias``, weight ``[in, out]`` (``nn_functional.py:
    172-177``)."""
    x, weight, bias = amp_cast("linear", x, weight, bias)
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def bilinear(x1, x2, weight, bias=None):
    """``out[b, o] = x1[b] @ weight[o] @ x2[b]``, weight ``[out, in1,
    in2]``."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def one_hot(x, num_classes):
    """float32 rows, all zero for a label outside ``[0, num_classes)``
    (``jax.nn.one_hot``)."""
    classes = torch.arange(num_classes, device=x.device)
    return (x[..., None] == classes).to(torch.float32)


def label_smooth(label, prior_dist=None, epsilon=0.1):
    if prior_dist is not None:
        return (1.0 - epsilon) * label + epsilon * prior_dist
    return (1.0 - epsilon) * label + epsilon / label.shape[-1]


# -- resampling (nn_functional.py:1174-1420) ---------------------------------

def _triangle(d):
    return np.maximum(1 - np.abs(d), np.float32(0))


def _keys_cubic(d):
    out = ((1.5 * d - 2.5) * d) * d + 1.
    out = np.where(d >= 1., ((-0.5 * d + 2.5) * d - 4.) * d + 2., out)
    return np.where(d >= 2., np.float32(0), out).astype(np.float32)


_RESIZE_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def _resize_weights(in_size: int, out_size: int, kernel):
    """``jax.image``'s ``compute_weight_mat`` at translation 0 with
    antialiasing: ``[in, out]`` numpy weights, in float32. Half-pixel
    centres; when downsampling, the kernel is widened by the inverse
    scale (a low pass), each column is normalised to sum 1, and a column
    whose sample falls outside the input is 0."""
    inv_scale = in_size / out_size
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(inv_scale) - np.float32(0.5)
    src = np.arange(in_size, dtype=np.float32)
    w = kernel(np.abs(sample[None, :] - src[:, None]) / kernel_scale)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000. * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1)),
                 np.float32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, np.float32(0)).astype(np.float32)


def resize(x, shape, method="linear"):
    """``jax.image.resize(x, shape, method)`` with its default
    ``antialias=True``: every dim whose size changes is resampled by a
    ``[in, out]`` weight matrix (``method`` ``"linear"``, the triangle
    kernel, or ``"cubic"``, Keys' kernel); an integer input comes back
    float32. PyTorch's ``F.interpolate`` is neither antialiased in 3-D /
    5-D nor half-pixel in the same way, so the port keeps JAX's
    filter."""
    kernel = _RESIZE_KERNELS[method]
    if not x.is_floating_point():
        x = x.to(torch.float32)
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = torch.from_numpy(_resize_weights(n_in, n_out, kernel)).to(
            x.device, x.dtype)
        x = torch.movedim(torch.matmul(torch.movedim(x, d, -1), w), -1, d)
    return x


def _band(w):
    """An ``[in, out]`` weight matrix as its columns' nonzero runs:
    ``idx[out, K]`` rows of the input and ``wk[out, K]`` their weights
    (0 past a run's end), K the longest run."""
    n_in, n_out = w.shape
    nz = w != 0
    hit = nz.any(axis=0)
    first = np.where(hit, nz.argmax(axis=0), 0)
    last = np.where(hit, n_in - 1 - nz[::-1].argmax(axis=0), 0)
    idx = first[:, None] + np.arange(int((last - first).max()) + 1)
    live = idx <= last[:, None]
    idx = np.minimum(idx, n_in - 1)
    wk = np.where(live, w[idx, np.arange(n_out)[:, None]], 0).astype(
        w.dtype)
    return idx, wk


def resize_host(x: np.ndarray, shape, method="linear") -> np.ndarray:
    """:func:`resize` on a numpy array, in numpy: the vision transforms'
    host-side path. It runs no torch op and no BLAS call, so a loader's
    worker threads leave torch's and BLAS's thread pools alone: each
    changed dim sums its few nonzero taps (:func:`_band`) per output."""
    kernel = _RESIZE_KERNELS[method]
    x = np.asarray(x)
    if not np.issubdtype(x.dtype, np.floating):
        x = x.astype(np.float32)
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        idx, wk = _band(_resize_weights(n_in, n_out, kernel).astype(
            x.dtype, copy=False))
        moved = np.ascontiguousarray(np.moveaxis(x, d, 0))
        tap = (n_out,) + (1,) * (x.ndim - 1)
        y = moved[idx[:, 0]] * wk[:, 0].reshape(tap)
        for k in range(1, idx.shape[1]):
            y += moved[idx[:, k]] * wk[:, k].reshape(tap)
        x = np.moveaxis(y, 0, d)
    return np.ascontiguousarray(x)


_INTERP_METHOD = {"nearest": "nearest", "bilinear": "linear",
                  "linear": "linear", "trilinear": "linear",
                  "bicubic": "cubic", "area": "linear"}


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW"):
    """``nn_functional.py:1174-1217``, JAX's semantics and not
    ``F.interpolate``'s:

    - ``"nearest"``: the floor map ``floor(i * in / out)``;
    - ``"linear"`` / ``"bilinear"`` / ``"trilinear"`` / ``"area"`` and
      ``"bicubic"``: :func:`resize` (half-pixel, antialiased when it
      downsamples, Keys cubic; ``"area"`` is linear);
      ``align_corners`` is ignored, as in JAX;
    - ``align_mode=1`` (linear, without ``align_corners``): the
      asymmetric map ``src = i * in / out``, a lerp between the two
      neighbours with the upper one clamped at the edge."""
    channel_last = data_format in ("NHWC", "NWC", "NDHWC")
    nsp = x.dim() - 2
    sp_axes = tuple(range(1, 1 + nsp)) if channel_last else \
        tuple(range(2, 2 + nsp))
    in_size = [x.shape[a] for a in sp_axes]
    if size is None:
        sf = _norm_tuple(scale_factor, nsp)
        size = [int(i * s) for i, s in zip(in_size, sf)]
    else:
        size = [int(s) for s in _norm_tuple(size, nsp)]
    method = _INTERP_METHOD[mode]
    if mode == "nearest":
        out = x
        for a, s, i in zip(sp_axes, size, in_size):
            idx = torch.floor(torch.arange(s, dtype=torch.float32,
                                           device=x.device) * (i / s))
            out = torch.index_select(out, a, idx.long())
        return out
    if align_mode == 1 and method == "linear" and not align_corners:
        out = x
        for a, osz, isz in zip(sp_axes, size, in_size):
            src = torch.arange(osz, dtype=torch.float32,
                               device=x.device) * (isz / osz)
            i0 = torch.clamp(torch.floor(src).long(), 0, isz - 1)
            i1 = torch.clamp(i0 + 1, 0, isz - 1)
            shape = [1] * out.dim()
            shape[a] = osz
            frac = (src - i0).to(out.dtype).reshape(shape)
            out = (torch.index_select(out, a, i0) * (1 - frac)
                   + torch.index_select(out, a, i1) * frac)
        return out
    new_shape = list(x.shape)
    for a, s in zip(sp_axes, size):
        new_shape[a] = s
    return resize(x, new_shape, method)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW"):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(n, h // r, w // r, c * r * r)


def _unfold_geometry(paddings, kernel_sizes, strides, dilations):
    kh, kw = _norm_tuple(kernel_sizes, 2)
    sh, sw = _norm_tuple(strides, 2)
    dh, dw = _norm_tuple(dilations, 2)
    pads = _conv_padding(paddings, 2)
    return (kh, kw), (sh, sw), (dh, dw), [tuple(p) for p in pads]


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col: ``[N, C, H, W] -> [N, C * kh * kw, L]``, the taps of each
    channel together in row-major order."""
    n, c = x.shape[:2]
    (kh, kw), (sh, sw), (dh, dw), pads = _unfold_geometry(
        paddings, kernel_sizes, strides, dilations)
    xp = _pad_spatial(x, pads, 0.0)
    oh = (xp.shape[2] - (dh * (kh - 1) + 1)) // sh + 1
    ow = (xp.shape[3] - (dw * (kw - 1) + 1)) // sw + 1
    cols = [xp[:, :, i * dh:i * dh + oh * sh:sh, j * dw:j * dw + ow * sw:sw]
            for i in range(kh) for j in range(kw)]
    return torch.stack(cols, dim=2).reshape(n, c * kh * kw, oh * ow)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0,
         dilations=1):
    """col2im, :func:`unfold`'s inverse: ``[N, C * kh * kw, L] -> [N, C,
    H, W]``; overlapping taps add."""
    n = x.shape[0]
    oh_img, ow_img = _norm_tuple(output_sizes, 2)
    (kh, kw), (sh, sw), (dh, dw), pads = _unfold_geometry(
        paddings, kernel_sizes, strides, dilations)
    (pt, pb), (pl, pr) = pads
    hp, wp = oh_img + pt + pb, ow_img + pl + pr
    oh = (hp - (dh * (kh - 1) + 1)) // sh + 1
    ow = (wp - (dw * (kw - 1) + 1)) // sw + 1
    c = x.shape[1] // (kh * kw)
    cols = x.reshape(n, c, kh * kw, oh, ow)
    out = torch.zeros((n, c, hp, wp), dtype=x.dtype, device=x.device)
    for i in range(kh):
        for j in range(kw):
            out[:, :, i * dh:i * dh + oh * sh:sh,
                j * dw:j * dw + ow * sw:sw] += cols[:, :, i * kw + j]
    return out[:, :, pt:pt + oh_img, pl:pl + ow_img]


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    """``nn_functional.py:1274-1306``: ``x [N, C, H, W]``, ``grid [N, Hg,
    Wg, 2]`` in ``[-1, 1]`` (x then y). Bilinear reads the four
    neighbours; with ``padding_mode="zeros"`` a neighbour outside the
    image gives 0, any other mode clamps it to the edge. Nearest rounds
    half to even and clamps."""
    n, c, h, w = x.shape
    if align_corners:
        gx = (grid[..., 0] + 1.0) * ((w - 1) / 2.0)
        gy = (grid[..., 1] + 1.0) * ((h - 1) / 2.0)
    else:
        gx = ((grid[..., 0] + 1.0) * w - 1.0) / 2.0
        gy = ((grid[..., 1] + 1.0) * h - 1.0) / 2.0
    flat = x.reshape(n, c, h * w)

    def read(ix, iy):
        ind = (iy.long() * w + ix.long()).reshape(n, 1, -1)
        return torch.gather(flat, 2, ind.expand(n, c, ind.shape[-1])
                            ).reshape((n, c) + tuple(ix.shape[1:]))

    if mode == "nearest":
        return read(torch.clamp(torch.round(gx), 0, w - 1),
                    torch.clamp(torch.round(gy), 0, h - 1))
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx1 = gx - x0
    wy1 = gy - y0
    out = 0.0
    for xi, wxf in ((x0, 1.0 - wx1), (x0 + 1, wx1)):
        for yi, wyf in ((y0, 1.0 - wy1), (y0 + 1, wy1)):
            v = read(torch.clamp(xi, 0, w - 1), torch.clamp(yi, 0, h - 1))
            if padding_mode == "zeros":
                valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
                v = torch.where(valid[:, None], v, torch.zeros_like(v))
            out = out + v * (wxf * wyf)[:, None]
    return out


def affine_grid(theta, out_shape, align_corners=True):
    """The ``[N, H, W, 2]`` sampling grid of ``theta [N, 2, 3]`` over an
    ``out_shape = (N, C, H, W)`` output."""
    _, _, h, w = (int(s) for s in out_shape)
    kw = dict(dtype=theta.dtype, device=theta.device)
    if align_corners:
        ys = torch.linspace(-1.0, 1.0, h, **kw)
        xs = torch.linspace(-1.0, 1.0, w, **kw)
    else:
        ys = (torch.arange(h, **kw) * 2 + 1) / h - 1
        xs = (torch.arange(w, **kw) * 2 + 1) / w - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("nij,hwj->nhwi", theta, base)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    """TSM: of each segment group of ``seg_num`` frames, the first
    ``int(C * shift_ratio)`` channels move one frame back, the next as
    many one frame forward, zeros filling in."""
    if data_format == "NHWC":
        out = temporal_shift(x.permute(0, 3, 1, 2), seg_num, shift_ratio)
        return out.permute(0, 2, 3, 1)
    n, c, h, w = x.shape
    x5 = x.reshape(n // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([x5[:, 1:, :fold],
                      torch.zeros_like(x5[:, :1, :fold])], dim=1)
    right = torch.cat([torch.zeros_like(x5[:, :1, fold:2 * fold]),
                       x5[:, :-1, fold:2 * fold]], dim=1)
    return torch.cat([left, right, x5[:, :, 2 * fold:]],
                     dim=2).reshape(n, c, h, w)


def channel_shuffle(x, groups, data_format="NCHW"):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, groups, c // groups, h, w).transpose(1, 2)
        return x.reshape(n, c, h, w)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, groups, c // groups).transpose(3, 4)
    return x.reshape(n, h, w, c)


def sequence_mask(x, maxlen=None, dtype="int64"):
    """``row < length`` over ``maxlen`` positions, in ``dtype``; as in
    JAX, ``maxlen`` is required."""
    if maxlen is None:
        raise ValueError(
            "sequence_mask requires maxlen under XLA static shapes")
    lengths = torch.as_tensor(x)
    row = torch.arange(int(maxlen), device=lengths.device)
    return (row < lengths[..., None]).to(as_dtype(dtype))


def _pad_index(n: int, lo: int, hi: int, mode: str, device):
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or (mode == "reflect" and n == 1):
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    period = 2 * (n - 1)
    i = i % period
    return torch.where(i >= n, period - i, i)


def _pad_widths(x, width, mode, value):
    if mode == "constant":
        return F.pad(x, [v for lo_hi in reversed(width) for v in lo_hi],
                     value=value)
    np_mode = {"reflect": "reflect", "replicate": "edge",
               "circular": "wrap"}[mode]
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            x = torch.index_select(x, d, _pad_index(
                x.shape[d], lo, hi, np_mode, x.device))
    return x


def pad(x, pad, mode="constant", value=0.0,  # noqa: A002
        data_format="NCHW"):
    """``paddle_tpu/ops/manipulation.py:145-168``: ``pad`` holds a (before,
    after) pair for every dim when it has ``2 * ndim`` entries, else
    pairs for the spatial dims of an NC... / N...C map, innermost first
    (left, right, top, bottom, front, back). Modes ``constant``,
    ``reflect`` (numpy's: the edge once), ``replicate`` and
    ``circular``."""
    pad = [int(p) for p in pad]
    nd = x.dim()
    if len(pad) == 2 * nd:
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        nsp = len(pad) // 2
        width = [(0, 0)] * nd
        spatial = list(range(nd - nsp, nd)) if data_format.startswith(
            "NC") else list(range(1, 1 + nsp))
        for i, dim in enumerate(reversed(spatial)):
            width[dim] = (pad[2 * i], pad[2 * i + 1])
    return _pad_widths(x, width, mode, value)


def pad3d(x, pad, mode="constant", value=0.0,  # noqa: A002
          data_format="NCDHW"):
    """``pad = [left, right, top, bottom, front, back]`` over the (D, H,
    W) dims of an NCDHW / NDHWC input."""
    l, r, t, b, f, bk = (int(p) for p in pad)
    if data_format == "NCDHW":
        width = [(0, 0), (0, 0), (f, bk), (t, b), (l, r)]
    else:
        width = [(0, 0), (f, bk), (t, b), (l, r), (0, 0)]
    return _pad_widths(x, width, mode, value)


def zeropad2d(x, padding, data_format="NCHW"):
    return pad(x, list(padding), mode="constant", value=0.0,
               data_format=data_format)
