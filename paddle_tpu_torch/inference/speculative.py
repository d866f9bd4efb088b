"""Speculative decoding's host half: draft sources and the engine's config
(port of ``paddle_tpu/inference/speculative.py``).

A cheap DRAFT proposes ``k`` tokens per slot; the target scores all
``k+1`` positions in ONE forward (``models/gpt.py`` ``verify_step``, the
chained-prefill paged path) and the engine emits the longest accepted
prefix plus one correction or bonus token. Greedy acceptance is an exact
match against the target's own argmax, so greedy outputs equal the
vanilla engine's: a wrong draft costs speed, never tokens. The device
half (the verify forward and the accept/resample math) lives in
``models/gpt.py`` and ``nn/decode.py``.

Draft sources are duck-typed::

    propose(histories, k) -> np.ndarray [len(histories), k] int32

where ``histories[i]`` is slot i's full token history (prompt +
generated; None for a slot with nothing to verify).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["SpeculativeConfig", "NGramDraft", "ModelDraft",
           "CallableDraft", "SelfDraft", "as_spec_config",
           "device_draft_params"]


class NGramDraft:
    """Prompt-lookup drafting, with no second model and no device work:
    the longest suffix of ``max_ngram .. min_ngram`` tokens that occurs
    EARLIER in the history (the most recent occurrence wins) proposes
    the ``k`` tokens that followed it there; a continuation shorter than
    ``k`` pads with its last token, and no match repeats the last
    token."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def _lookup(self, h: np.ndarray, k: int) -> np.ndarray:
        n = len(h)
        out = np.full((k,), h[-1], np.int32)
        for g in range(min(self.max_ngram, n - 1), self.min_ngram - 1,
                       -1):
            pat = h[n - g:]
            # windows over h[:n-1] end at e <= n-1: the suffix itself is
            # excluded. Vectorized, as it runs per slot per engine step.
            wins = np.lib.stride_tricks.sliding_window_view(h[:n - 1], g)
            hits = np.nonzero((wins == pat).all(axis=1))[0]
            if len(hits):
                e = int(hits[-1]) + g  # end (exclusive) of the match
                cont = h[e:e + k]
                out[:len(cont)] = cont
                out[len(cont):] = cont[-1]
                return out
        return out

    def propose(self, histories: Sequence[Optional[np.ndarray]],
                k: int) -> np.ndarray:
        out = np.zeros((len(histories), k), np.int32)
        for i, h in enumerate(histories):
            if h is None or len(h) == 0:
                continue
            out[i] = self._lookup(np.asarray(h, np.int32), k)
        return out


class ModelDraft:
    """A small causal LM drafting greedily for the target.

    Stateless over a fixed window of the last ``window`` tokens, RIGHT
    padded (real tokens at positions 0..len-1, so causal attention never
    sees padding before a real token and drafting is exact while the
    history fits): ``k`` greedy forwards under ``torch.no_grad()`` on
    the draft model's device, each a full forward with no cache. The
    window grows in place until it fills, then slides
    (``speculative.py:132-158``); a truncated context can only lower the
    acceptance rate, never change the output. The engine clips a draft
    vocabulary larger than the target's."""

    def __init__(self, model, window: int = 64):
        model.eval()
        self.model = model
        self.window = int(window)

    def _draft(self, ctx: torch.Tensor, lens: torch.Tensor,
               k: int) -> torch.Tensor:
        b, w = ctx.shape
        rows = torch.arange(b, device=ctx.device)
        toks = []
        with torch.no_grad():
            for _ in range(k):
                logits = self.model(ctx)
                last = logits[rows, torch.clamp_min(lens - 1, 0)]
                nxt = torch.argmax(last, dim=-1).to(ctx.dtype)
                # grow in place until the window fills, then slide
                slid = torch.cat([ctx[:, 1:], torch.zeros_like(ctx[:, :1])],
                                 dim=1)
                ctx = torch.where((lens >= w)[:, None], slid, ctx)
                ctx = ctx.clone()
                ctx[rows, torch.clamp_max(lens, w - 1)] = nxt
                lens = torch.clamp_max(lens + 1, w)
                toks.append(nxt)
        return torch.stack(toks, dim=1)

    def propose(self, histories: Sequence[Optional[np.ndarray]],
                k: int) -> np.ndarray:
        from ..device import module_device
        w = self.window
        ctx = np.zeros((len(histories), w), np.int32)
        lens = np.zeros((len(histories),), np.int64)
        for i, h in enumerate(histories):
            if h is None or len(h) == 0:
                continue
            tail = np.asarray(h, np.int32)[-w:]
            ctx[i, :len(tail)] = tail
            lens[i] = len(tail)
        dev = module_device(self.model)
        out = self._draft(torch.from_numpy(ctx).to(dev),
                          torch.from_numpy(lens).to(dev), k)
        return out.cpu().numpy().astype(np.int32)


class SelfDraft:
    """Repeat the last token ``k`` times: NGramDraft's no-match fallback
    as the whole policy."""

    def propose(self, histories: Sequence[Optional[np.ndarray]],
                k: int) -> np.ndarray:
        out = np.zeros((len(histories), k), np.int32)
        for i, h in enumerate(histories):
            if h is None or len(h) == 0:
                continue
            out[i, :] = int(np.asarray(h)[-1])
        return out


class CallableDraft:
    """Adapter for a plain function ``fn(history, k) -> k tokens`` (an
    always-wrong draft that forces rejection storms, an oracle draft)."""

    def __init__(self, fn: Callable[[np.ndarray, int], Sequence[int]]):
        self.fn = fn

    def propose(self, histories: Sequence[Optional[np.ndarray]],
                k: int) -> np.ndarray:
        out = np.zeros((len(histories), k), np.int32)
        for i, h in enumerate(histories):
            if h is None or len(h) == 0:
                continue
            toks = np.asarray(self.fn(np.asarray(h, np.int32), k),
                              np.int32).reshape(-1)[:k]
            out[i, :len(toks)] = toks
            if len(toks) < k:
                out[i, len(toks):] = toks[-1] if len(toks) else 0
        return out


@dataclasses.dataclass
class SpeculativeConfig:
    """The engine's speculative-decoding settings.

    ``draft``: "ngram" (prompt lookup), "self", a model (wrapped in
    :class:`ModelDraft` with ``draft_window``) or any object with
    ``propose``. ``k``: draft tokens a verify step, so a step emits 1 to
    k+1 tokens. ``temperature`` / ``top_k``: the verify's sampling mode
    (0.0 is greedy, equal to the vanilla engine; above 0 the residual
    resampling draws from a ``torch.Generator`` seeded with ``seed``)."""

    k: int = 4
    draft: Any = "ngram"
    temperature: float = 0.0
    top_k: Optional[int] = None
    max_ngram: int = 3
    min_ngram: int = 1
    draft_window: int = 64
    seed: int = 0

    def __post_init__(self):
        if self.k < 1:
            raise ValueError("speculative k must be >= 1")

    def build_draft(self):
        d = self.draft
        if isinstance(d, str):
            if d == "self":
                return SelfDraft()
            if d != "ngram":
                raise ValueError(f"unknown draft source {d!r} "
                                 f"(expected 'ngram', 'self', a model "
                                 f"or a propose()-object)")
            return NGramDraft(self.max_ngram, self.min_ngram)
        if hasattr(d, "propose"):
            return d
        if callable(getattr(d, "forward", None)):
            return ModelDraft(d, window=self.draft_window)
        raise ValueError(f"cannot build a draft source from {d!r}")


def device_draft_params(draft) -> Optional[dict]:
    """A draft source as a device program (``nn/decode.py``
    ``ngram_draft_tokens`` for NGramDraft, a broadcast for SelfDraft),
    or None when it runs host code (ModelDraft, CallableDraft). The
    in-program speculation of multi-step decode reads it."""
    if isinstance(draft, NGramDraft):
        return {"kind": "ngram", "max_ngram": draft.max_ngram,
                "min_ngram": draft.min_ngram}
    if isinstance(draft, SelfDraft):
        return {"kind": "self"}
    return None


def as_spec_config(spec) -> "SpeculativeConfig":
    """The engine's ``speculative=`` argument: a SpeculativeConfig
    passes through, an int is k with the n-gram draft, anything
    draft-shaped becomes the draft at the default k."""
    if isinstance(spec, SpeculativeConfig):
        return spec
    if isinstance(spec, bool):
        raise ValueError("speculative must be a SpeculativeConfig, an "
                         "int k, or a draft source — not a bool")
    if isinstance(spec, int):
        return SpeculativeConfig(k=spec)
    return SpeculativeConfig(draft=spec)
