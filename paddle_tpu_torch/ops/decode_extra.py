"""Sequence decoding, segment and small misc ops (port of
``paddle_tpu/ops/decode_extra.py``): the linear-chain CRF pair, dense
beam search, the segment reductions, ``multiplex``, ``mv``,
``increment``, ``p_norm``, ``frobenius_norm`` and ``mul``.

The CRF pair keeps the reference's ``[K + 2, K]`` transition layout
(start row, stop row, then the ``[K, K]`` transitions). Each recursion
(the forward algorithm's log-sum-exp, Viterbi's max) is one batched
tensor step a time step over all sequences, as JAX scans it; padded
steps copy alpha forward, Viterbi's back-pointers take the first
maximum (``torch.max`` over a dim returns the first, as ``jnp.argmax``
does), and ``crf_decoding`` writes 0 past each length.

The search keeps the static ``[batch, beam]`` form of the JAX package.
Its top-k must pick what ``jax.lax.top_k`` picks, which returns the
lowest index first among equal values; ``torch.topk`` promises no order
for ties, so the candidates go through a stable descending sort and the
first ``beam_size`` are taken. Ties are real: finished beams all carry
their score on the end token, and a zero projection gives a whole row of
equal log-probs.
"""

from __future__ import annotations

import numpy as np
import torch

from ._eager import axes, tensor


def beam_search_step(log_probs, scores, beam_size, end_token=None,
                     finished=None):
    """One expansion: ``log_probs`` ``[B, beam_in, V]`` for this step,
    ``scores`` ``[B, beam_in]`` accumulated (``beam_in`` may be 1 on the
    first step). A finished beam (``finished`` ``[B, beam_in]`` bool)
    continues only through ``end_token``, at no cost. Returns
    ``(next_scores [B, beam_size], parent, token)``, the indices int32."""
    b, beam_in, v = log_probs.shape
    cand = scores[:, :, None] + log_probs
    if finished is not None:
        if end_token is None:
            raise ValueError(
                "beam_search_step: end_token is required with finished")
        keep = torch.full((v,), float("-inf"), dtype=cand.dtype,
                          device=cand.device)
        keep[int(end_token)] = 0.0
        cand = torch.where(finished[:, :, None], scores[:, :, None] + keep,
                           cand)
    top, idx = torch.sort(cand.reshape(b, beam_in * v), dim=1,
                          descending=True, stable=True)
    top, idx = top[:, :beam_size], idx[:, :beam_size]
    return top, (idx // v).to(torch.int32), (idx % v).to(torch.int32)


def gather_tree(ids, parents):
    """Back-trace ``ids`` / ``parents`` ``[T, B, beam]`` into the full
    sequence of every final beam, ``[T, B, beam]``."""
    beam_idx = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1], -1)
    toks = [None] * ids.shape[0]
    for t in range(ids.shape[0] - 1, -1, -1):
        toks[t] = torch.gather(ids[t], 1, beam_idx)
        beam_idx = torch.gather(parents[t], 1, beam_idx).long()
    return torch.stack(toks)


def best_beams(full, scores):
    """The best final beam of each row of ``full`` ``[T, B, beam]`` by
    ``scores`` ``[B, beam]`` (the first among equals): ``(sequences [B,
    T], best scores [B])``."""
    best = torch.argmax(scores, dim=1)
    seq = full[:, torch.arange(full.shape[1], device=full.device), best]
    return seq.transpose(0, 1), scores.max(dim=1).values


def beam_search_decode(ids, parents, scores=None):
    """Back-trace and pick the best beam: ``(sequences [B, T], best
    scores [B])``; without ``scores``, beam 0 and None."""
    full = gather_tree(ids, parents)
    if scores is None:
        return full[:, :, 0].transpose(0, 1), None
    return best_beams(full, scores)


# -- linear-chain CRF ---------------------------------------------------------

def _crf_split_transition(transition):
    """Row 0 the start weights, row 1 the stop weights, rows 2: the
    ``[K, K]`` transitions (``linear_chain_crf_op.cc``)."""
    return transition[0], transition[1], transition[2:]


def _crf_valid(length, n, t, device):
    if length is None:
        length = torch.full((n,), t, dtype=torch.long, device=device)
    length = tensor(length, device).reshape(-1).long()
    return torch.arange(t, device=device)[None, :] < length[:, None], \
        length


def linear_chain_crf(emission, transition, label, length=None):
    """The negative log-likelihood ``log Z - score(gold)``, ``[N, 1]``:
    ``emission [N, T, K]``, ``transition [K + 2, K]``, ``label [N, T]``,
    ``length [N]`` (default T)."""
    start_w, stop_w, trans = _crf_split_transition(transition)
    n, t, k = emission.shape
    dev = emission.device
    label = tensor(label, dev).long()
    valid, length = _crf_valid(length, n, t, dev)
    alpha = start_w[None, :] + emission[:, 0]
    for step in range(1, t):
        new = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) + \
            emission[:, step]
        alpha = torch.where(valid[:, step, None], new, alpha)
    logz = torch.logsumexp(alpha + stop_w[None, :], dim=1)

    gold = start_w[label[:, 0]] + torch.gather(
        emission[:, 0], 1, label[:, :1])[:, 0]
    prev_lab, next_lab = label[:, :-1], label[:, 1:]
    step_trans = trans[prev_lab, next_lab]
    step_emit = torch.gather(emission[:, 1:], 2, next_lab[..., None])[..., 0]
    zero = torch.zeros((), dtype=emission.dtype, device=dev)
    gold = gold + torch.where(valid[:, 1:], step_trans + step_emit,
                              zero).sum(1)
    last = torch.gather(label, 1, torch.clamp_min(length - 1, 0)[:, None])
    gold = gold + stop_w[last[:, 0]]
    return (logz - gold)[:, None]


def crf_decoding(emission, transition, length=None):
    """The Viterbi path ``[N, T]`` int32 under the ``linear_chain_crf``
    layout, 0 past each length. Back-pointers take the first maximum;
    padded steps point each tag to itself, so the stop weights added
    after the last step land on each sequence's true last step."""
    start_w, stop_w, trans = _crf_split_transition(transition)
    n, t, k = emission.shape
    dev = emission.device
    valid, _ = _crf_valid(length, n, t, dev)
    alpha = start_w[None, :] + emission[:, 0]
    ident = torch.arange(k, device=dev)[None, :]
    ptrs = []
    for step in range(1, t):
        best, best_prev = torch.max(alpha[:, :, None] + trans[None], dim=1)
        ok = valid[:, step, None]
        alpha = torch.where(ok, best + emission[:, step], alpha)
        ptrs.append(torch.where(ok, best_prev, ident))
    tag = torch.argmax(alpha + stop_w[None, :], dim=1)
    path = [tag]
    for ptr in reversed(ptrs):
        tag = torch.gather(ptr, 1, tag[:, None])[:, 0]
        path.append(tag)
    full = torch.stack(path[::-1], dim=1)
    return torch.where(valid, full, torch.zeros_like(full)).to(torch.int32)


# -- segment ops (incubate segment_pool) ---------------------------------------

def _num_segments(num_segments, op_name):
    if num_segments is None:
        raise ValueError(f"{op_name} requires static num_segments")
    return int(num_segments)


def _segment_reduce(x, segment_ids, n, reduce, fill):
    """``jax.ops.segment_*``: ids outside ``[0, n)`` are dropped (they
    land in a spare row), empty segments hold ``fill``."""
    ids = tensor(segment_ids, x.device).reshape(-1).long()
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    out = torch.full((n + 1,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    idx = ids.reshape((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    out = out.scatter_reduce(0, idx, x, reduce=reduce, include_self=True)
    return out[:n]


def segment_sum(x, segment_ids, num_segments=None):
    n = _num_segments(num_segments, "segment_sum")
    return _segment_reduce(x, segment_ids, n, "sum", 0)


def segment_mean(x, segment_ids, num_segments=None):
    n = _num_segments(num_segments, "segment_mean")
    s = _segment_reduce(x, segment_ids, n, "sum", 0)
    cnt = _segment_reduce(torch.ones((x.shape[0],), dtype=x.dtype,
                                     device=x.device), segment_ids, n,
                          "sum", 0)
    return s / torch.clamp_min(cnt, 1.0).reshape((-1,) + (1,) * (x.dim()
                                                                - 1))


def _extreme(dtype, high: bool):
    if dtype.is_floating_point:
        return float("inf") if high else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if high else info.min


def segment_max(x, segment_ids, num_segments=None):
    n = _num_segments(num_segments, "segment_max")
    return _segment_reduce(x, segment_ids, n, "amax",
                           _extreme(x.dtype, False))


def segment_min(x, segment_ids, num_segments=None):
    n = _num_segments(num_segments, "segment_min")
    return _segment_reduce(x, segment_ids, n, "amin",
                           _extreme(x.dtype, True))


def segment_pool(x, segment_ids, pool_type="SUM", num_segments=None):
    fn = {"SUM": segment_sum, "MEAN": segment_mean, "MAX": segment_max,
          "MIN": segment_min}[pool_type.upper()]
    return fn(x, segment_ids, num_segments)


# -- misc -----------------------------------------------------------------------

def multiplex(inputs, index):
    """``out[i] = inputs[index[i]][i]``."""
    stacked = torch.stack(list(inputs), dim=0)
    idx = tensor(index, stacked.device).reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1],
                                     device=stacked.device)]


def mv(x, vec):
    return x @ vec


def increment(x, value=1.0):
    return x + torch.full((), value, dtype=x.dtype, device=x.device)


def _dims(x, axis):
    ax = axes(axis)
    if ax is None:
        return tuple(range(x.dim()))
    return ax


def p_norm(x, p=2.0, axis=None, epsilon=1e-12, keepdim=False):
    """The p-norm along ``axis`` (``(sum |x|^p + epsilon)^(1/p)``); inf,
    -inf and 0 as the max, min and count of nonzeros."""
    dims = _dims(x, axis)
    if p == float("inf"):
        return torch.amax(torch.abs(x), dim=dims, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), dim=dims, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=dims, keepdim=keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=dims,
                               keepdim=keepdim) + epsilon, 1.0 / p)


def frobenius_norm(x, axis=None, keepdim=False):
    return torch.sqrt(torch.sum(torch.square(x), dim=_dims(x, axis),
                                keepdim=keepdim))


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1):
    """Fluid's ``mul``: ``x`` flattened to 2-D after ``x_num_col_dims``
    dims, ``y`` after ``y_num_col_dims``, multiplied, the leading dims
    restored."""
    x2 = x.reshape(int(np.prod(x.shape[:x_num_col_dims])), -1)
    y2 = y.reshape(int(np.prod(y.shape[:y_num_col_dims])), -1)
    return (x2 @ y2).reshape(tuple(x.shape[:x_num_col_dims])
                             + tuple(y.shape[y_num_col_dims:]))
