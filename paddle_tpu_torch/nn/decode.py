"""The shared autoregressive sampler (port of ``sample_token``,
``_head_logits`` and ``fused_sample_token`` of
``paddle_tpu/nn/decode.py:39-61, 203-262``).

Greedy at ``temperature == 0``; temperature / top-k sampling draws from
an explicit ``torch.Generator`` (JAX's keys and torch's generators give
different numbers from one seed, so only greedy streams compare across
the two packages).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.nn_functional import fused_sample


def sample_token(last, temperature: float = 0.0, top_k=None,
                 generator: Optional[torch.Generator] = None):
    """``last`` [B, V] logits -> tokens [B] int32: first-index argmax at
    ``temperature == 0``, else a categorical draw over the temperature-
    scaled logits (top-k-masked when ``top_k`` is given)."""
    if temperature == 0.0:
        return torch.argmax(last, dim=-1).to(torch.int32)
    scaled = last.to(torch.float32) / temperature
    if top_k is not None:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth,
                             torch.tensor(-1e10, device=scaled.device),
                             scaled)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def _head_logits(hidden, weight, bias, transpose_y: bool):
    """The unfused lm-head matmul: ``hidden @ W.T`` for the tied [V, D]
    layout, ``hidden @ W`` for an untied [D, V] head."""
    logits = torch.matmul(hidden, weight.t() if transpose_y else weight)
    if bias is not None:
        logits = logits + bias
    return logits


def fused_sample_token(hidden, weight, temperature: float = 0.0,
                       top_k=None, generator=None,
                       transpose_y: bool = False, bias=None,
                       tile: int = 2048):
    """:func:`sample_token` over FINAL HIDDEN STATES [B, D] and the lm-head
    weight: greedy streams the argmax over vocab tiles (the
    ``fused_argmax`` kernel on the card), top-k draws from the streamed
    top-k reservoir, plain temperature sampling takes the full logits."""
    if temperature == 0.0:
        return fused_sample(hidden, weight, bias=bias,
                            transpose_y=transpose_y, tile=tile)
    if top_k is not None:
        vals, idxs = fused_sample(hidden, weight, bias=bias,
                                  transpose_y=transpose_y, top_k=top_k,
                                  tile=tile)
        probs = torch.softmax(vals.to(torch.float32) / temperature, dim=-1)
        pick = torch.multinomial(probs, 1, generator=generator)
        return torch.gather(idxs, 1, pick)[:, 0].to(torch.int32)
    return sample_token(_head_logits(hidden, weight, bias, transpose_y),
                        temperature, top_k, generator)
