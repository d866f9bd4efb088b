"""Sequence ops over padded tensors and lengths (port of
``paddle_tpu/ops/sequence.py``).

The reference walks LoD offsets (``paddle/fluid/operators/
sequence_ops/``); the JAX package and the port take a dense ``x [batch,
maxlen, ...]`` and an integer ``lengths [batch]`` and work through masks,
so every op is a fixed number of batched tensor ops on the device of
``x`` (no loop over rows). ``sequence_unpad`` is the one exception: it
returns the host container ``framework.ragged.RaggedTensor``, as in
JAX. Integer outputs are int32.
"""

from __future__ import annotations

import torch

from ._eager import tensor


def _lens(lengths, device):
    return tensor(lengths, device).reshape(-1).long()


def _valid_mask(lengths, maxlen, device):
    return torch.arange(maxlen, device=device)[None, :] < \
        _lens(lengths, device)[:, None]


def _expand_mask(mask, x):
    return mask.reshape(mask.shape + (1,) * (x.dim() - 2))


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def sequence_pad(x, lengths, pad_value=0.0, padded_length=-1):
    """Padding positions set to ``pad_value``; ``padded_length`` (>= 0)
    fixes the time dim: longer pads, shorter drops columns only when no
    length reaches them (the reference never truncates; a length past
    ``padded_length`` raises)."""
    m = x.shape[1]
    if padded_length >= 0 and padded_length != m:
        if padded_length < m:
            max_len = int(_lens(lengths, x.device).max()) if \
                x.shape[0] else 0
            if padded_length < max_len:
                raise ValueError(
                    f"sequence_pad: padded_length={padded_length} is "
                    f"shorter than the longest sequence ({max_len}) — "
                    "the reference op rejects this (truncation is "
                    "never implicit)")
            x = x[:, :padded_length]
        else:
            pad = torch.zeros((x.shape[0], padded_length - m)
                              + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            x = torch.cat([x, pad], dim=1)
        m = padded_length
    mask = _expand_mask(_valid_mask(lengths, m, x.device), x)
    return torch.where(mask, x, torch.full((), pad_value, dtype=x.dtype,
                                           device=x.device))


def sequence_pool(x, lengths, pool_type="sum"):
    """Pool each sequence's valid prefix: sum, mean, sqrt (sum over
    sqrt(length)), max, min, first, last. An empty row gives 0 (sum,
    mean, sqrt, first, last) or the dtype's extreme (max, min)."""
    n, m = x.shape[0], x.shape[1]
    mask = _expand_mask(_valid_mask(lengths, m, x.device), x)
    lens = _lens(lengths, x.device)
    denom_shape = (n,) + (1,) * (x.dim() - 2)
    len_b = torch.clamp_min(lens, 1).to(x.dtype).reshape(denom_shape)
    zero = _zero(x)
    if pool_type == "sum":
        return torch.where(mask, x, zero).sum(dim=1)
    if pool_type == "mean":
        return torch.where(mask, x, zero).sum(dim=1) / len_b
    if pool_type == "sqrt":
        return torch.where(mask, x, zero).sum(dim=1) / torch.sqrt(len_b)
    info = torch.finfo if x.is_floating_point() else torch.iinfo
    if pool_type == "max":
        low = torch.full((), info(x.dtype).min, dtype=x.dtype,
                         device=x.device)
        return torch.where(mask, x, low).amax(dim=1)
    if pool_type == "min":
        high = torch.full((), info(x.dtype).max, dtype=x.dtype,
                          device=x.device)
        return torch.where(mask, x, high).amin(dim=1)
    ok = (lens > 0).reshape(denom_shape)
    if pool_type == "first":
        return torch.where(ok, x[:, 0], zero)
    if pool_type == "last":
        idx = torch.clamp_min(lens - 1, 0)
        last = x[torch.arange(n, device=x.device), idx]
        return torch.where(ok, last, zero)
    raise ValueError(f"unknown pool_type {pool_type!r}")


def sequence_first_step(x, lengths):
    return sequence_pool(x, lengths, "first")


def sequence_last_step(x, lengths):
    return sequence_pool(x, lengths, "last")


def sequence_softmax(x, lengths):
    """Softmax over each sequence's valid prefix; padding gets 0."""
    mask = _expand_mask(_valid_mask(lengths, x.shape[1], x.device), x)
    neg = torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype,
                     device=x.device)
    z = torch.where(mask, x, neg)
    z = z - z.amax(dim=1, keepdim=True)
    e = torch.where(mask, torch.exp(z), _zero(x))
    return e / torch.clamp_min(e.sum(dim=1, keepdim=True), 1e-30)


def _take_time(x, idx):
    """``x[b, idx[b, t], ...]`` for ``idx [b, T]``."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


def sequence_reverse(x, lengths):
    """Reverse each row's valid prefix; padding stays in place."""
    m = x.shape[1]
    lens = _lens(lengths, x.device)[:, None]
    pos = torch.arange(m, device=x.device)[None, :]
    src = torch.where(pos < lens, lens - 1 - pos, pos)
    return _take_time(x, src)


def sequence_slice(x, lengths, offset, length):
    """Rows ``[offset, offset + length)`` of each valid prefix: ``(out
    [batch, length, ...], new lengths)``."""
    length = int(length)
    off = tensor(offset, x.device).long().reshape(-1)
    off = off.expand(x.shape[0]) if off.numel() == 1 else off
    pos = torch.arange(length, device=x.device)[None, :] + off[:, None]
    out = _take_time(x, torch.clamp(pos, 0, x.shape[1] - 1))
    new_len = torch.clamp(_lens(lengths, x.device) - off, 0, length)
    return out, new_len.to(torch.int32)


def sequence_expand(x, ref_lengths, max_ref=None):
    """Row ``x[i]`` repeated ``ref_lengths[i]`` times into ``[batch,
    max_ref, ...]`` (0 past the count), with the clipped counts."""
    ref = _lens(ref_lengths, x.device)
    if max_ref is None:
        max_ref = int(ref.max())
    reps = torch.arange(int(max_ref), device=x.device)[None, :] < \
        ref[:, None]
    out = torch.where(reps.reshape(reps.shape + (1,) * (x.dim() - 1)),
                      x[:, None], _zero(x))
    return out, torch.clamp_max(ref, int(max_ref)).to(torch.int32)


def sequence_expand_as(x, ref_lengths, max_ref=None):
    return sequence_expand(x, ref_lengths, max_ref)


def sequence_enumerate(x, lengths, win_size, pad_value=0):
    """``out[b, t] = x[b, t:t + win]``, positions past the length set to
    ``pad_value``."""
    m = x.shape[1]
    idx = torch.arange(m, device=x.device)[:, None] + \
        torch.arange(win_size, device=x.device)[None, :]
    gather = x[:, torch.clamp(idx, 0, m - 1)]
    valid = idx[None] < _lens(lengths, x.device)[:, None, None]
    return torch.where(valid, gather, torch.full((), pad_value,
                                                 dtype=x.dtype,
                                                 device=x.device))


def _compact(x, keep):
    """The kept entries of each row moved left in order (a stable
    ordering by dropped-then-position), zero-padded: ``(out, count)``."""
    m = x.shape[1]
    key = torch.where(keep, 0, 1) * m + torch.arange(m, device=x.device)
    order = torch.argsort(key, dim=1)
    gathered = torch.gather(x, 1, order)
    new_len = keep.sum(dim=1)
    valid = torch.arange(m, device=x.device)[None, :] < new_len[:, None]
    return torch.where(valid, gathered, _zero(x)), new_len.to(torch.int32)


def sequence_erase(x, lengths, tokens):
    """Every occurrence of ``tokens`` removed from each sequence, the rest
    compacted left and zero-padded: ``(out, new lengths)``."""
    tok = tensor(tokens, x.device).reshape(-1).to(x.dtype)
    valid = _valid_mask(lengths, x.shape[1], x.device)
    keep = valid & ~(x[..., None] == tok[None, None, :]).any(-1)
    return _compact(x, keep)


def sequence_concat(xs, lengths_list):
    """Row ``b`` of the output is ``xs[0][b] ++ xs[1][b] ++ ...`` (each
    valid prefix), in a buffer as wide as the inputs together:
    ``(out, lengths)``."""
    total = sum(x.shape[1] for x in xs)
    dev = xs[0].device
    batch = xs[0].shape[0]
    tail = tuple(xs[0].shape[2:])
    out = torch.zeros((batch, total + 1) + tail, dtype=xs[0].dtype,
                      device=dev)
    pos = torch.zeros((batch,), dtype=torch.long, device=dev)
    b_idx = torch.arange(batch, device=dev)[:, None]
    for x, ln in zip(xs, lengths_list):
        ln = _lens(ln, dev)
        m = x.shape[1]
        dest = pos[:, None] + torch.arange(m, device=dev)[None, :]
        valid = torch.arange(m, device=dev)[None, :] < ln[:, None]
        # invalid entries land in the spare column and are dropped
        dest = torch.where(valid, dest, total)
        out = out.index_put((b_idx.expand_as(dest), dest), x.to(out.dtype))
        pos = pos + ln
    return out[:, :total], pos.to(torch.int32)


def sequence_unpad(x, lengths):
    """The padded batch as a host ``RaggedTensor`` (a dynamic shape)."""
    from ..framework.ragged import RaggedTensor
    return RaggedTensor.from_padded(x, lengths)


def sequence_conv(x, lengths, weight, context_length, context_start=None,
                  context_stride=1, padding_trainable=False,
                  padding_data=None):
    """Context-window convolution (``sequence.py:238-303``): each step
    concatenates ``context_length`` neighbouring frames from
    ``context_start`` (default ``-(ctx - 1) // 2``) and multiplies by
    ``weight [context_length * dim, out_dim]``. Frames outside the row's
    sequence are zero, or with ``padding_trainable`` the learned rows of
    ``padding_data [up_pad + down_pad, dim]``. ``context_stride`` must be
    1, as in the reference."""
    if context_stride != 1:
        raise ValueError(
            "sequence_conv supports context_stride=1 only (the "
            "reference enforces the same, sequence_conv_op.cc)")
    if context_start is None:
        context_start = -((context_length - 1) // 2)
    up_pad = max(0, -context_start)
    if padding_trainable and padding_data is None:
        raise ValueError("padding_trainable=True requires "
                         "padding_data [up_pad + down_pad, dim]")
    b, m, d = x.shape
    dev = x.device
    valid = _valid_mask(lengths, m, dev)
    zero = _zero(x)
    xz = torch.where(valid[..., None], x, zero)
    lens = _lens(lengths, dev)[:, None]
    steps = torch.arange(m, device=dev)
    cols = []
    for k in range(context_length):
        shift = context_start + k
        idx = steps + shift
        ok = (idx[None, :] >= 0) & (idx[None, :] < lens)
        col = xz[:, torch.clamp(idx, 0, m - 1)]
        col = torch.where(ok[..., None], col, zero)
        if padding_trainable and shift != 0:
            n_rows = padding_data.shape[0]
            below = idx[None, :] < 0
            over = idx[None, :] >= lens
            in_row = steps[None, :] < lens
            pu = padding_data[torch.clamp(up_pad + idx, 0, n_rows - 1)]
            pd_row = torch.clamp(up_pad + (idx[None, :] - lens), 0,
                                 n_rows - 1)
            col = torch.where((below & in_row)[..., None], pu[None], col)
            col = torch.where((over & in_row)[..., None],
                              padding_data[pd_row], col)
        cols.append(col)
    im2col = torch.cat(cols, dim=-1)
    out = (im2col.reshape(b * m, -1) @ weight).reshape(b, m, -1)
    return torch.where(valid[..., None], out, _zero(out))


def sequence_reshape(x, lengths, new_dim):
    """Each sequence's features re-bucketed into rows of ``new_dim``:
    ``(x reshaped to [batch, maxlen * D // new_dim, new_dim], lengths *
    D // new_dim)``."""
    b, m, d = x.shape[0], x.shape[1], x.shape[2]
    if (m * d) % new_dim != 0:
        raise ValueError(
            f"maxlen*dim {m}*{d} not divisible by new_dim {new_dim}")
    out = x.reshape(b, (m * d) // new_dim, new_dim)
    new_len = (_lens(lengths, x.device) * d) // new_dim
    return out, new_len.to(torch.int32)


def sequence_scatter(x, index, updates, lengths):
    """``out[i][index[i][j]] += updates[i][j]`` for ``j < lengths[i]``
    (indices clipped into the row)."""
    mask = _valid_mask(lengths, index.shape[1], x.device)
    upd = torch.where(mask, updates.to(x.dtype), _zero(x))
    idx = torch.clamp(index.long(), 0, x.shape[1] - 1)
    return x.scatter_add(1, idx, upd)
