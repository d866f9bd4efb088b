"""The shared autoregressive sampler, the speculative verify math and
the carry-form stop rules of multi-step decode (port of
``sample_token``, ``masked_carry_advance``, ``masked_run_advance``,
``ngram_draft_tokens``, ``_head_logits``, ``fused_sample_token``,
``fused_verify_tokens`` and ``speculative_verify_tokens`` of
``paddle_tpu/nn/decode.py:39-348``), and beam search over a recurrent
cell, ``BeamSearchDecoder`` and ``dynamic_decode`` (``:351-477``).

Greedy at ``temperature == 0``; temperature / top-k sampling draws from
an explicit ``torch.Generator`` (JAX's keys and torch's generators give
different numbers from one seed, so only greedy streams compare across
the two packages).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..device import resolve_device
from ..ops.decode_extra import beam_search_step, best_beams, gather_tree
from ..ops.nn_functional import fused_sample
from .rnn import flatten_structure, map_structure


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
        # a scalar fill, not a host tensor: no copy, so a CUDA graph can
        # capture the draw
        scaled = scaled.masked_fill(scaled < kth, -1e10)
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


def masked_carry_advance(nxt, cur, active, emitted, rem, eos):
    """Fold one sampled token batch into the ``(cur, active, emitted)``
    carry of multi-step decode (``nn/decode.py:64-91``): ``nxt`` [B]
    this iteration's tokens, ``active`` [B] bool, ``emitted`` [B] int32
    tokens emitted this launch, ``rem`` [B] each slot's remaining
    budget at the launch, ``eos`` [B] EOS ids (-1 for none). A slot
    stops after emitting EOS or its budget's last token (the host's
    ``_finish_due``); a stopped slot keeps its last token in ``cur``.
    Returns ``(cur', active', emitted')``: pure tensor math, no host
    read."""
    emitted = emitted + active.to(torch.int32)
    stop = (nxt == eos) | (emitted >= rem)
    new_active = active & ~stop
    return torch.where(active, nxt, cur), new_active, emitted


def masked_run_advance(run, run_len, cur, active, emitted, rem, eos):
    """The accept-and-rewind twin of :func:`masked_carry_advance` for
    in-program speculation (``nn/decode.py:93-142``): fold a ``[B, W]``
    run (each slot's accepted drafts plus its correction or bonus token,
    ``run_len`` [B] of them) into the carry, truncated as the host would
    emit it token by token: an EOS inside the run ends the emission at
    that token, and the budget caps the total. Returns ``(run_masked
    [B, W] int32 with -1 past each slot's emitted share, emit_len [B],
    cur', active', emitted')``; ``run_masked`` is the token ring's row
    for the iteration."""
    b, w = run.shape
    dev = run.device
    run = run.to(torch.int32)
    jpos = torch.arange(w, device=dev, dtype=torch.int32)[None, :]
    in_run = jpos < run_len[:, None]
    budget = torch.clamp_min(rem - emitted, 0)
    # first EOS position within the run (w when none): emitting stops
    # after that token, like the host's append-then-check loop
    is_eos = (run == eos[:, None]) & in_run
    ends = torch.cat([is_eos, torch.ones((b, 1), dtype=torch.bool,
                                         device=dev)], dim=1)
    eos_idx = torch.argmax(ends.to(torch.int32), dim=1).to(torch.int32)
    emit_len = torch.minimum(run_len, torch.minimum(eos_idx + 1, budget))
    emit_len = torch.where(active, torch.clamp_min(emit_len, 0),
                           torch.zeros_like(emit_len)).to(torch.int32)
    last = torch.gather(run, 1, torch.clamp_min(emit_len - 1, 0)
                        .long()[:, None])[:, 0]
    hit_eos = (eos_idx + 1) <= emit_len
    new_emitted = emitted + emit_len
    stop = hit_eos | (new_emitted >= rem)
    new_active = active & ~stop
    run_masked = torch.where((jpos < emit_len[:, None]) & active[:, None],
                             run, torch.full_like(run, -1))
    new_cur = torch.where(active & (emit_len > 0), last, cur)
    return run_masked, emit_len, new_cur, new_active, new_emitted


def ngram_draft_tokens(hist, hist_len, k: int, max_ngram: int = 3,
                       min_ngram: int = 1):
    """Device twin of ``inference/speculative.py`` ``NGramDraft._lookup``
    as gathers over the slots' stored histories: ``hist`` [B, H] int32
    (right padded; entries past ``hist_len`` are ignored), ``hist_len``
    [B]. Returns [B, k] int32 proposals with the host source's rule: the
    longest ``max_ngram..min_ngram`` suffix that occurs earlier (the
    most recent occurrence wins) proposes what followed it, a short
    continuation pads with its last token, and no match repeats the last
    token."""
    b, hcap = hist.shape
    dev = hist.device
    n = hist_len.to(torch.int64)
    pos = torch.arange(hcap, device=dev)
    last = torch.gather(hist, 1, torch.clamp_min(n - 1, 0)[:, None])
    out = last.expand(b, k).to(torch.int32)
    found = torch.zeros((b,), dtype=torch.bool, device=dev)
    kr = torch.arange(k, device=dev)
    for g in range(max_ngram, min_ngram - 1, -1):
        # orders above n-1 are skipped: the suffix must leave at least
        # one earlier token to match against
        g_ok = g <= (n - 1)
        gr = torch.arange(g, device=dev)
        pat_idx = torch.clamp_min(n[:, None] - g + gr[None, :], 0)
        pat = torch.gather(hist, 1, pat_idx)                     # [B, g]
        win_idx = torch.clamp_max(pos[:, None] + gr[None, :], hcap - 1)
        win = hist[:, win_idx]                                   # [B,H,g]
        match = (win == pat[:, None, :]).all(-1)                 # [B, H]
        # windows end at s+g <= n-1: the suffix itself is excluded
        valid_s = (pos[None, :] + g) <= (n[:, None] - 1)
        hit = match & valid_s & g_ok[:, None]
        any_hit = hit.any(-1)
        s_best = torch.argmax(torch.where(hit, pos[None, :], -1), dim=-1)
        e = s_best + g
        cont_idx = torch.clamp_max(e[:, None] + kr[None, :], hcap - 1)
        cont = torch.gather(hist, 1, cont_idx)                   # [B, k]
        clen = torch.clamp(n[:, None] - e[:, None], 1, k)
        cont_last = torch.gather(cont, 1, clen - 1)
        cont = torch.where(kr[None, :] < clen, cont, cont_last)
        take = any_hit & ~found
        out = torch.where(take[:, None], cont, out).to(torch.int32)
        found = found | any_hit
    return out


def fused_verify_tokens(hidden, drafts, weight, temperature: float = 0.0,
                        top_k=None, generator=None,
                        transpose_y: bool = False, bias=None,
                        tile: int = 2048):
    """:func:`speculative_verify_tokens` over the verify chunk's final
    hidden states [B, s, D]: greedy takes each position's target token
    from the streaming argmax over B*s rows (the ``fused_argmax``
    kernel on the card), so no [B, s, V] logits exist; temperature and
    top-k verification need whole distributions and take the unfused
    logits. Same return contract."""
    b, s, d = hidden.shape
    if temperature == 0.0:
        full = fused_sample(hidden.reshape(b * s, d).contiguous(), weight,
                            bias=bias, transpose_y=transpose_y, tile=tile)
        full = full.reshape(b, s).to(torch.int32)
        accept = drafts.to(torch.int32) == full[:, :-1]
        return accept, full[:, :-1], full
    return speculative_verify_tokens(
        _head_logits(hidden, weight, bias, transpose_y), drafts,
        temperature, top_k, generator)


def speculative_verify_tokens(logits, drafts, temperature: float = 0.0,
                              top_k=None,
                              generator: Optional[torch.Generator] = None):
    """Per-position accept/replace decisions for speculative decoding.

    ``logits``: [B, s, V] over the verify chunk ``[cur, d_0, ..,
    d_{s-2}]`` (position j scores the token after ``cur, d_0..d_{j-1}``);
    ``drafts``: [B, s-1]. Returns ``(accept [B, s-1] bool, resampled
    [B, s-1] int32, full [B, s] int32)``:

    - ``full[:, j]``: the target's own token at position j
      (:func:`sample_token` semantics: argmax when greedy);
    - ``accept[:, j]``: greedy, ``d_j == full[:, j]``; with temperature,
      a uniform draw under the target probability of ``d_j``;
    - ``resampled[:, j]``: the replacement if j is the first rejection:
      greedy, ``full[:, j]``; with temperature, a draw from the target
      distribution with ``d_j``'s mass removed, which keeps the emitted
      stream distributed as the target's.

    The caller emits ``drafts[:n]`` plus ``resampled[n]`` (n < valid) or
    ``full[valid]``, n the accepted prefix's length."""
    b, s, _ = logits.shape
    if temperature == 0.0:
        full = torch.argmax(logits, dim=-1).to(torch.int32)
        accept = drafts.to(torch.int32) == full[:, :-1]
        return accept, full[:, :-1], full
    scaled = logits.to(torch.float32) / temperature
    if top_k is not None:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth,
                             torch.tensor(-1e10, device=scaled.device),
                             scaled)
    probs = torch.softmax(scaled, dim=-1)
    full = torch.multinomial(probs.reshape(b * s, -1), 1,
                             generator=generator).reshape(b, s).to(
        torch.int32)
    d64 = drafts.to(torch.int64)
    p_draft = torch.gather(probs[:, :-1], -1, d64[..., None])[..., 0]
    u = torch.rand((b, s - 1), generator=generator, device=logits.device)
    accept = u < p_draft
    # residual: the rejected draft's mass removed, renormalized
    masked = scaled[:, :-1].scatter(-1, d64[..., None], -1e10)
    resampled = torch.multinomial(
        torch.softmax(masked, dim=-1).reshape(b * (s - 1), -1), 1,
        generator=generator).reshape(b, s - 1).to(torch.int32)
    return accept, resampled, full


class BeamSearchDecoder:
    """Beam search over a recurrent cell (reference: fluid/layers/rnn.py
    ``BeamSearchDecoder``).

    ``cell`` maps ``(inputs, states) -> (output, new_states)``; its
    states may be a tensor or tuples, lists and dicts of tensors with
    the batch first, and are tiled to ``batch * beam_size`` rows and
    reordered along each step's parents with their container types
    kept. ``output_fn`` maps the cell's output to logits over the
    vocabulary (identity by default), ``embedding_fn`` token ids to the
    cell's inputs (the ids themselves by default).
    """

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn: Optional[Callable] = None,
                 output_fn: Optional[Callable] = None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def decode(self, initial_states, max_step_num: int):
        """The whole search: ``(ids [B, T], scores [B])`` of each row's
        best beam, T at most ``max_step_num``. Log-softmax runs in fp32;
        the loop stops once every beam has emitted ``end_token``."""
        leaves = flatten_structure(initial_states)
        batch = leaves[0].shape[0] if leaves else 1
        dev = leaves[0].device if leaves else resolve_device(None)
        beam = self.beam_size
        states = map_structure(
            lambda t: t.repeat_interleave(beam, dim=0), initial_states)
        tokens = torch.full((batch, beam), self.start_token,
                            dtype=torch.int32, device=dev)
        # the first expansion starts from one live beam a row
        scores = torch.full((batch, beam), float("-inf"), device=dev)
        scores[:, 0] = 0.0
        finished = torch.zeros((batch, beam), dtype=torch.bool, device=dev)
        row_base = torch.arange(batch, device=dev)[:, None] * beam
        ids_steps, parent_steps = [], []
        for _ in range(max_step_num):
            flat_tok = tokens.reshape(-1)
            inp = self.embedding_fn(flat_tok) if self.embedding_fn \
                else flat_tok
            cell_out, states = self.cell(inp, states)
            logits = self.output_fn(cell_out) if self.output_fn \
                else cell_out
            logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            scores, parent, tok = beam_search_step(
                logp.reshape(batch, beam, -1), scores, beam,
                end_token=self.end_token, finished=finished)
            flat_parent = (parent + row_base).reshape(-1)
            states = map_structure(
                lambda t: t.index_select(0, flat_parent), states)
            finished = torch.gather(finished, 1, parent.long()) | (
                tok == self.end_token)
            tokens = tok
            ids_steps.append(tok)
            parent_steps.append(parent)
            if bool(finished.all()):
                break
        full = gather_tree(torch.stack(ids_steps), torch.stack(parent_steps))
        return best_beams(full, scores)

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """Each batch row repeated ``beam_size`` times: ``[B * beam,
        ...]``."""
        return x.repeat_interleave(beam_size, dim=0)


def dynamic_decode(decoder, inits=None, max_step_num: int = 100,
                   output_time_major: bool = False, impute_finished=False,
                   is_test: bool = False, return_length: bool = False,
                   **kwargs):
    """Run ``decoder`` to its end (reference: fluid/layers/rnn.py
    ``dynamic_decode``): ``(ids, scores)``, and with ``return_length``
    each row's length, the position of its first ``end_token`` (T when
    it has none), int32. ``output_time_major`` gives ids ``[T, B]``."""
    ids, scores = decoder.decode(inits, max_step_num)
    out = ids.transpose(0, 1) if output_time_major else ids
    if not return_length:
        return out, scores
    ended = torch.cat([ids == decoder.end_token,
                       torch.ones_like(ids[:, :1], dtype=torch.bool)], dim=1)
    # torch.argmax takes no bool tensor: the first 1 of the cast
    lengths = torch.argmax(ended.to(torch.uint8), dim=1).to(torch.int32)
    return out, scores, lengths
