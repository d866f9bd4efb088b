"""Dense beam search (port of ``beam_search_step``, ``gather_tree`` and
``beam_search_decode`` of ``paddle_tpu/ops/decode_extra.py:123-177``).

The search keeps the static ``[batch, beam]`` form of the JAX package.
Its top-k must pick what ``jax.lax.top_k`` picks, which returns the
lowest index first among equal values; ``torch.topk`` promises no order
for ties, so the candidates go through a stable descending sort and the
first ``beam_size`` are taken. Ties are real: finished beams all carry
their score on the end token, and a zero projection gives a whole row of
equal log-probs.

The CRF, segment and other ops of that module are not ported yet
(ROADMAP.md, Queue 1 item 3(e)).
"""

from __future__ import annotations

import torch


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
