"""GPT decoder-only transformer for serving and training (port of
``paddle_tpu/models/gpt.py``).

Same architecture and conventions as the JAX model, so a JAX checkpoint
loads without renaming or transposing (:func:`load_jax_state`):
pre-norm blocks, a fused QKV projection split as ``reshape(b, s, 3, H,
D)``, tanh GELU, learned positions, and an LM head tied to ``wte``
(``logits = hidden @ wte.T``). Linear weights are ``[in, out]``.

The paged KV cache (``PagedKVCache``) is the JAX layout: per-layer pools
``[num_pages + 1, page, H, D]`` whose last page is a scratch page that
masked and padded writes land on, a page table ``[B, max_pages]`` and
lengths ``[B]``. Where the JAX cache is immutable and the JAX engine
donates the pools to its jitted step, :func:`paged_kv_append` here
writes into the pools in place (``index_put_``) and returns a cache
that shares them.

Training (``forward(ids, labels=ids)``) computes the shifted next-token
cross entropy and its plain mean over every position, ignored ones
included, as the JAX model does; ``loss_chunk_size`` computes it over
sequence chunks whose logits are recomputed in backward, and ``remat``
recomputes blocks in backward (``torch.utils.checkpoint``), with
``remat_save_attention`` all but the attention kernel's forward; the
choice and activation offload (the block inputs kept in pinned host
memory) are ``core/offload.py``'s.

Generation (``generate``) runs the eager loop over a growing ``(k, v)``
cache, or the one-launch mode over a ``StaticKVCache`` (dense buffers
written at a device-side position) or paged pools, whose decode step is
one CUDA graph replayed a token on the card, or the per-block chunked
mode. A layer converted by ``quantization.quant.
convert_to_weight_only_int8`` has no floating ``weight``: the fused
lm head and the fused out-projection decline it.

Not ported yet (see ROADMAP.md): MoE, sequence parallelism.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..amp.auto_cast import amp_cast, auto_cast, current_args
from ..core import offload, rng
from ..device import resolve_device
from ..nn.layer import checkpoint_state, load_jax_state  # noqa: F401
from ..nn.layers import (ColumnParallelLinear, Dropout, Embedding,
                         ParallelCrossEntropy, RowParallelLinear,
                         VocabParallelEmbedding, gelu)
from ..nn.norm import LayerNorm
from ..ops import nn_functional as NF
from ..ops.kernels.attention import SavedAttention
from ..nn.layer import Layer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    ffn_hidden_mult: int = 4
    dropout: float = 0.1
    attn_dropout: float = 0.1
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    use_flash_attention: bool = True
    seq_parallel_mode: Optional[str] = None
    dtype: str = "float32"
    moe_experts: int = 0
    # next-token loss over sequence chunks of this many positions, each
    # chunk's logits recomputed in backward; 0 = the full logits
    loss_chunk_size: int = 0
    # recompute blocks with layer_idx % remat_every == 0 in backward
    remat: bool = False
    remat_every: int = 1
    # with remat: keep each attention kernel's forward outputs (flash:
    # out and lse; folded: out), so the recompute skips the kernel
    remat_save_attention: bool = False

    def __post_init__(self):
        if self.remat and self.remat_every < 1:
            raise ValueError(
                "remat_every must be >= 1 (1 = remat every block); to "
                "disable rematerialization set remat=False")
        for flag, what in ((self.moe_experts > 0, "MoE (moe_experts > 0)"),
                           (self.seq_parallel_mode is not None,
                            "seq_parallel_mode")):
            if flag:
                raise NotImplementedError(
                    f"{what} is not yet ported, see ROADMAP.md")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def gpt_tiny(**kw) -> GPTConfig:
    return GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                     num_heads=4, max_seq_len=128, dropout=0.0,
                     attn_dropout=0.0, **kw)


def gpt_125m(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt_350m(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16,
                     max_seq_len=2048, **kw)


def gpt_1p3b(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                     max_seq_len=2048, **kw)


CONFIGS = {"gpt_tiny": gpt_tiny, "gpt_125m": gpt_125m,
           "gpt_350m": gpt_350m, "gpt_1p3b": gpt_1p3b}


class PagedKVCache(NamedTuple):
    """Block-paged per-layer KV cache (``gpt.py:188-216``). int8 mode
    stores pages as int8 with per-(position, head) scales
    ``[num_pages + 1, page, H]`` (``quantization/quant.py``)."""

    k_pages: Any
    v_pages: Any
    k_scale: Any  # None when pages are float
    v_scale: Any
    page_table: Any
    seq_lens: Any

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[1]


class StaticKVCache(NamedTuple):
    """Preallocated per-layer KV buffer for fixed-shape decode
    (``gpt.py:174-185``): ``k`` / ``v`` ``[B, max_len, H, D]`` and
    ``pos``, the positions already written, a 0-d int32 tensor on the
    buffers' device. A step writes its keys and values at ``pos`` and
    advances ``pos`` IN PLACE, so a CUDA graph of the step reads and
    writes all three at fixed addresses."""

    k: Any
    v: Any
    pos: Any


def static_cache_create(batch: int, max_len: int, num_heads: int,
                        head_dim: int, dtype, device=None) -> StaticKVCache:
    """Zero-filled buffers at position 0."""
    shape = (batch, max_len, num_heads, head_dim)
    return StaticKVCache(torch.zeros(shape, dtype=dtype, device=device),
                         torch.zeros(shape, dtype=dtype, device=device),
                         torch.zeros((), dtype=torch.int32, device=device))


def paged_cache_create(batch: int, num_pages: int, page_size: int,
                       num_heads: int, head_dim: int, dtype,
                       max_pages_per_seq: int, quantized: bool = False,
                       page_table=None, seq_lens=None,
                       device=None) -> PagedKVCache:
    """Zero-filled pool (+1 scratch page); the default table hands
    sequence ``i`` pages ``[i*mp, (i+1)*mp)``."""
    kv_dtype = torch.int8 if quantized else dtype
    shape = (num_pages + 1, page_size, num_heads, head_dim)
    k_pages = torch.zeros(shape, dtype=kv_dtype, device=device)
    v_pages = torch.zeros(shape, dtype=kv_dtype, device=device)
    if quantized:
        k_scale = torch.zeros(shape[:3], dtype=torch.float32, device=device)
        v_scale = torch.zeros(shape[:3], dtype=torch.float32, device=device)
    else:
        k_scale = v_scale = None
    if page_table is None:
        page_table = torch.arange(
            batch * max_pages_per_seq, dtype=torch.int32,
            device=device).reshape(batch, max_pages_per_seq)
    if seq_lens is None:
        seq_lens = torch.zeros((batch,), dtype=torch.int32, device=device)
    return PagedKVCache(k_pages, v_pages, k_scale, v_scale, page_table,
                        seq_lens)


def paged_kv_append(cache: PagedKVCache, k, v,
                    valid_len=None) -> PagedKVCache:
    """Write ``s`` new tokens per sequence at positions seq_lens ..
    seq_lens+s-1 through the page table and advance the lengths
    (``gpt.py:279-328``). The pools are updated IN PLACE.

    ``valid_len`` ([B] int32): ragged prefill — only the first
    valid_len[i] tokens are real; the padding goes to the scratch page
    and the length advances by valid_len. Positions past the table's
    capacity also go to the scratch page, and lengths clamp there."""
    b, s = k.shape[:2]
    page = cache.page_size
    mp = cache.page_table.shape[1]
    scratch = cache.k_pages.shape[0] - 1
    ar = torch.arange(s, dtype=torch.int32, device=k.device)
    pos = cache.seq_lens[:, None] + ar[None]
    if valid_len is None:
        valid = None
        new_lens = cache.seq_lens + s
    else:
        valid = ar[None] < valid_len[:, None]
        new_lens = cache.seq_lens + valid_len.to(torch.int32)
    pidx = torch.clamp(torch.div(pos, page, rounding_mode="floor"), 0,
                       mp - 1)
    off = torch.remainder(pos, page)
    pages = torch.gather(cache.page_table, 1, pidx.long())
    overflow = pos >= mp * page
    pages = torch.where(overflow, scratch, pages)
    off = torch.where(overflow, 0, off)
    if valid is not None:
        pages = torch.where(valid, pages, scratch)
        off = torch.where(valid, off, 0)
    new_lens = torch.clamp_max(new_lens, mp * page).to(torch.int32)
    index = (pages.long(), off.long())

    def put(pool, scales, val):
        if scales is None:
            pool.index_put_(index, val.to(pool.dtype))
            return
        from ..quantization.quant import quantize_kv
        qv, sc = quantize_kv(val)
        pool.index_put_(index, qv)
        scales.index_put_(index, sc)

    put(cache.k_pages, cache.k_scale, k)
    put(cache.v_pages, cache.v_scale, v)
    return cache._replace(seq_lens=new_lens)


def paged_page_splice(pools, page, k_blocks, v_blocks,
                      ks_blocks=None, vs_blocks=None):
    """Restore spilled prefix pages into the engine's per-layer pools
    (``gpt.py:331-366``): layer i's blocks ``k_blocks[i]`` /
    ``v_blocks[i]`` ([nl, n, page, H, D], plus [nl, n, page, H] scales
    for int8 pools) go into every pool at the n page indices ``page``.
    ``pools`` is the engine's ``{"k": [...], "v": [...], "ks": [...],
    "vs": [...]}`` dict; each pool is updated in place (one
    ``index_copy_`` a pool, :func:`NF.paged_page_splice`) and the same
    dict is returned. The blocks arrive in the pool's layout: the blob
    codecs decode on the host first."""
    for kind, blocks in (("k", k_blocks), ("v", v_blocks),
                         ("ks", ks_blocks), ("vs", vs_blocks)):
        if blocks is None:
            continue
        for i, pool in enumerate(pools[kind]):
            NF.paged_page_splice(pool, blocks[i], page)
    return pools



class MacroCarry:
    """The loop carry of :func:`multi_step_decode`, preallocated so that
    every iteration updates it in place: a CUDA graph of one iteration
    reads and writes these tensors at fixed addresses, and the plain
    loop on the CPU runs the same iteration on them.

    ``j`` (the iteration index) and ``steps`` (iterations that had a
    live slot or a scheduled chunk) are device int32 scalars; per slot
    ``cur``, ``lens``, ``act`` and ``emitted`` (tokens emitted this
    launch); the token ring ``[B, N]`` (``[B, N, k+1]`` under in-program
    speculation, one accepted run an iteration), -1 where nothing was
    emitted; and under speculation the draft history ``hist`` [B, H]
    with its lengths ``hist_len``."""

    def __init__(self, batch: int, num_steps: int, device, k: int = 0,
                 hist_cap: int = 0):
        i32 = dict(dtype=torch.int32, device=device)
        self.k = int(k)
        self.j = torch.zeros((), **i32)
        self.steps = torch.zeros((), **i32)
        self.cur = torch.zeros((batch,), **i32)
        self.lens = torch.zeros((batch,), **i32)
        self.act = torch.zeros((batch,), dtype=torch.bool, device=device)
        self.emitted = torch.zeros((batch,), **i32)
        shape = (batch, int(num_steps)) + ((self.k + 1,) if self.k else ())
        self.ring = torch.full(shape, -1, **i32)
        self.hist = (torch.zeros((batch, int(hist_cap)), **i32)
                     if self.k else None)
        self.hist_len = torch.zeros((batch,), **i32) if self.k else None

    def clear(self) -> None:
        """Begin a launch: the index, the counts, the emissions and the
        ring cleared (the slots' inputs are the caller's to load)."""
        self.j.zero_()
        self.steps.zero_()
        self.emitted.zero_()
        self.ring.fill_(-1)

    def start(self, tokens, lens, active, hist=None, hist_len=None
              ) -> None:
        """:meth:`clear`, then the slots' tokens, lengths and active mask
        (and histories) copied in from tensors on any device, in the
        caller's stream order (a page-locked source copies
        asynchronously)."""
        nb = tokens.device.type == "cpu" and tokens.is_pinned()
        self.clear()
        self.cur.copy_(tokens, non_blocking=nb)
        self.lens.copy_(lens, non_blocking=nb)
        self.act.copy_(active, non_blocking=nb)
        if self.k:
            self.hist.copy_(hist, non_blocking=nb)
            self.hist_len.copy_(hist_len, non_blocking=nb)


def macro_iteration(carry: MacroCarry, step_fn, table, rem, eos,
                    scratch: int, spec=None, chunk=None) -> None:
    """ONE iteration of :func:`multi_step_decode`'s loop, in place on
    ``carry``, in the JAX body's order (``gpt.py:470-656``):

    - the masked table and lengths: an inactive slot (stopped, half
      prefilled or empty) rides the step on the scratch page at length
      0, so its KV write lands on scratch;
    - ``step_fn(table, lens, cur) -> nxt`` [B] int32, the engine's
      single-token decode body (the pools are its own and are written
      in place);
    - the ring write at column ``j``, read from the device index;
    - the length advance under the mask from before the update, then
      :func:`~..nn.decode.masked_carry_advance`.

    ``spec`` (in-program speculation: ``k``, ``vocab``,
    ``draft_fn(hist, hist_len, cur) -> [B, k]`` and
    ``verify_fn(table, lens, toks, valid) -> (accept, resid, full)``)
    replaces the decode by draft, verify of k+1 positions,
    :func:`~..nn.decode.masked_run_advance`, the rewind of ``lens`` past
    the rejected drafts and the history append. ``chunk`` (this
    iteration advances a half-prefilled slot: ``prefill_fn(trow, slens,
    plen, ids) -> nxt`` [1] and the schedule rows ``ids`` [N, bucket],
    ``valid`` / ``start`` / ``final`` [N] and ``slot`` []) runs that
    slot's chained chunk ``j`` after the decode; the final chunk's token
    is the slot's first, written into the ring, and the slot joins the
    decode from the next iteration.

    Once every slot has stopped and no chunk is scheduled, an iteration
    changes nothing the caller reads: writes land on the scratch page,
    the ring column stays -1, the carry keeps its values and ``steps``
    does not count it. A graph that replays all N iterations therefore
    ends where the early-exit loop ends."""
    from ..nn.decode import masked_carry_advance, masked_run_advance
    b = carry.cur.shape[0]
    dev = carry.cur.device
    jl = carry.j.long().view(1)
    act = carry.act
    live = act.any() if chunk is None else torch.ones(
        (), dtype=torch.bool, device=dev)
    table_eff = torch.where(act[:, None], table, scratch).to(torch.int32)
    lens_eff = torch.where(act, carry.lens, 0).to(torch.int32)
    hist_len = carry.hist_len
    if spec is None:
        nxt = step_fn(table_eff, lens_eff, carry.cur).to(torch.int32)
        col = torch.where(act, nxt, -1).to(torch.int32)
        carry.ring.index_copy_(1, jl, col[:, None])
        lens = torch.where(act, carry.lens + 1, carry.lens)
        cur, new_act, emitted = masked_carry_advance(
            nxt, carry.cur, act, carry.emitted, rem, eos)
    else:
        k = int(spec["k"])
        width = k + 1
        # draft clip: emit at most the remaining budget (the host's
        # k_eff = min(k, rem - 1), rem counted from this launch's
        # emissions)
        k_eff = torch.clamp(rem - carry.emitted - 1, 0, k)
        valid = torch.where(act, 1 + k_eff, 0).to(torch.int32)
        drafts = spec["draft_fn"](carry.hist, hist_len, carry.cur)
        drafts = torch.clamp(drafts.to(torch.int32), 0,
                             int(spec["vocab"]) - 1)
        toks = torch.cat([carry.cur[:, None], drafts], dim=1)
        accept, _resid, full = spec["verify_fn"](table_eff, lens_eff,
                                                 toks, valid)
        kr = torch.arange(k, device=dev, dtype=torch.int32)
        acc = accept & (kr[None, :] < k_eff[:, None])
        nacc = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1).to(
            torch.int32)
        # greedy verify: the correction or bonus token is full[:, nacc],
        # the target's own token after the accepted prefix
        nxt = torch.gather(full.to(torch.int32), 1,
                           nacc.long()[:, None])[:, 0]
        wr = torch.arange(width, device=dev, dtype=torch.int32)
        padded = torch.cat([drafts, torch.zeros_like(drafts[:, :1])],
                           dim=1)
        run = torch.where(wr[None, :] < nacc[:, None], padded,
                          nxt[:, None])
        run_masked, emit_len, cur, new_act, emitted = masked_run_advance(
            run, nacc + 1, carry.cur, act, carry.emitted, rem, eos)
        carry.ring.index_copy_(1, jl, run_masked[:, None, :])
        # the in-program rewind: the lengths advance past cur and the
        # accepted drafts only; the next verify appends over the
        # rejected positions
        lens = torch.where(act, carry.lens + nacc + 1, carry.lens)
        hist = carry.hist
        hcap = hist.shape[1]
        for r in range(width):
            idx = torch.clamp_max(hist_len + r, hcap - 1).long()[:, None]
            put = act & (r < emit_len)
            old = torch.gather(hist, 1, idx)[:, 0]
            hist.scatter_(1, idx, torch.where(put, run[:, r], old)[:, None])
        hist_len = torch.where(
            act, torch.clamp_max(hist_len + emit_len, hcap), hist_len)
    if chunk is not None:
        ids_j = chunk["ids"].index_select(0, jl)
        valid_j = chunk["valid"].index_select(0, jl)
        start_j = chunk["start"].index_select(0, jl)
        final_j = chunk["final"].index_select(0, jl)
        slot = chunk["slot"].long().view(1)
        trow = table.index_select(0, slot).to(torch.int32)
        nxt_c = chunk["prefill_fn"](trow, start_j, valid_j, ids_j).to(
            torch.int32)
        plen = start_j + valid_j
        upd = final_j & (torch.arange(b, device=dev) == slot)
        # the first-token stop rule (the host's _maybe_finish after a
        # final chunk's emission)
        stop = (nxt_c == eos.index_select(0, slot)) | \
            (rem.index_select(0, slot) <= 1)
        cur = torch.where(upd, nxt_c, cur)
        lens = torch.where(upd, plen, lens)
        emitted = torch.where(upd, 1, emitted)
        # the promoted slot joins the decode from the NEXT iteration
        new_act = torch.where(upd, ~stop, new_act)
        col = carry.ring.index_select(1, jl)
        if spec is not None:
            col[:, 0, 0] = torch.where(upd, nxt_c, col[:, 0, 0])
            hidx = torch.clamp_max(plen, carry.hist.shape[1] - 1).long()
            idx = hidx.expand(b)[:, None]
            old = torch.gather(carry.hist, 1, idx)[:, 0]
            carry.hist.scatter_(1, idx,
                                torch.where(upd, nxt_c, old)[:, None])
            hist_len = torch.where(upd, plen + 1, hist_len)
        else:
            col[:, 0] = torch.where(upd, nxt_c, col[:, 0])
        carry.ring.index_copy_(1, jl, col)
    carry.cur.copy_(cur)
    carry.lens.copy_(lens)
    carry.act.copy_(new_act)
    carry.emitted.copy_(emitted)
    if spec is not None:
        carry.hist_len.copy_(hist_len)
    carry.steps.add_(live.to(torch.int32))
    carry.j.add_(1)


def run_macro_loop(carry: MacroCarry, iterate, num_steps: int,
                   chunk_count: int = 0, full: bool = False) -> None:
    """The plain loop around :func:`macro_iteration`: ``iterate(with_chunk)``
    for iterations ``j < num_steps`` (``with_chunk`` for ``j <
    chunk_count``), stopping once no slot is active and no chunk is
    left, as JAX's ``while_loop`` condition does; ``full`` runs all N,
    as a CUDA graph replayed N times does."""
    for j in range(int(num_steps)):
        with_chunk = j < chunk_count
        if not (full or with_chunk or bool(carry.act.any())):
            break
        iterate(with_chunk)


def multi_step_decode(step_fn, pools, table, lens, tokens, active, rem,
                      eos, num_steps: int, scratch: int, spec=None,
                      chunk=None, full: bool = False):
    """Up to ``num_steps`` single-token decode iterations over every slot
    in one call (port of ``gpt.py:368-660``): the engine's macro step.
    ``step_fn(table, lens, cur) -> nxt`` is the engine's single-token
    decode body, exactly what a ``multi_step=1`` step runs, so each
    iteration equals one host-driven step; the loop carries the host's
    bookkeeping between steps (masking, the stop rules, the token ring).
    The page table is a constant of the call: the engine binds each
    slot's growth pages before it.

    ``spec`` adds ``hist`` / ``hist_len`` to :func:`macro_iteration`'s
    spec keys; ``chunk`` adds ``count`` (host int: iterations ``j <
    count`` each run chunk ``j``) to its chunk keys. ``full`` runs all
    iterations instead of stopping early; the results are the same.

    Returns ``(ring, steps_done, cur, lens, active, pools)``: the ring
    ``[B, N]`` int32 (``[B, N, k+1]`` with ``spec``), ``steps_done`` a
    device int32 count of the iterations that had a live slot or a
    scheduled chunk, and the final carry. The pools are updated in place
    and returned as given."""
    i32 = torch.int32
    k = int(spec["k"]) if spec is not None else 0
    carry = MacroCarry(tokens.shape[0], num_steps, tokens.device, k=k,
                       hist_cap=(spec["hist"].shape[1] if k else 0))
    carry.start(tokens.to(i32), lens.to(i32), active.to(torch.bool),
                spec["hist"].to(i32) if k else None,
                spec["hist_len"].to(i32) if k else None)
    rem = rem.to(i32)
    eos = eos.to(i32)
    plan = count = None
    if chunk is not None:
        count = int(chunk["count"])
        plan = {"prefill_fn": chunk["prefill_fn"],
                "ids": chunk["ids"].to(i32), "valid": chunk["valid"].to(i32),
                "start": chunk["start"].to(i32),
                "final": chunk["final"].to(torch.bool),
                "slot": torch.as_tensor(chunk["slot"], dtype=i32,
                                        device=tokens.device)}

    def iterate(with_chunk: bool) -> None:
        macro_iteration(carry, step_fn, table, rem, eos, scratch,
                        spec=spec, chunk=plan if with_chunk else None)

    run_macro_loop(carry, iterate, num_steps, count or 0, full)
    return carry.ring, carry.steps, carry.cur, carry.lens, carry.act, pools


def _remat_block(block: nn.Module, x):
    """Run ``block`` under ``torch.utils.checkpoint`` (``gpt.py:663-686``):
    its activations are recomputed in backward instead of kept. The
    policy is ``core.offload``'s (``remat_policy``), read here as the
    JAX package reads it at trace time: with ``ATTN_OUT_NAME`` among the
    saved names (``remat_save_attention``, ``gpt.py:953-971``) the
    attention kernel's forward outputs are kept aside
    (``SavedAttention``) and the recompute takes them instead of running
    the kernel again; with activation offload on, the block input, the
    one tensor the checkpoint saves, is kept in pinned host memory until
    the recompute.

    The recompute runs on autograd's thread, so it re-opens what the
    forward saw in this thread: the ``key_scope`` generator, rewound to
    its state before the forward so dropout draws the same masks, and
    the kernel selection (:func:`NF.plain_kernels`) and the ``auto_cast``
    state, so the recompute casts where the forward did."""
    gen = rng.next_generator()
    plain = NF.plain_mode()
    amp = current_args()
    before = gen.get_state() if gen is not None else None
    ran = []
    policy = offload.remat_policy()
    saved = SavedAttention() if policy is not None and \
        offload.ATTN_OUT_NAME in policy.saved else None

    def run(h):
        after = None
        if ran and gen is not None:
            after = gen.get_state()
            gen.set_state(before)
        if saved is not None:
            saved.replay = bool(ran)
        ran.append(True)
        try:
            with rng.key_scope(gen), NF.plain_kernels(plain), \
                    NF.saved_attention(saved), auto_cast(**amp):
                return block(h)
        finally:
            if after is not None:
                gen.set_state(after)

    stage = offload.offload_block_inputs() if policy is not None and \
        policy.offloaded else contextlib.nullcontext()
    with stage:
        return checkpoint(run, x, use_reentrant=False)


class GPTAttention(Layer):
    def __init__(self, config: GPTConfig, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        c = config
        self.num_heads = c.num_heads
        self.head_dim = c.head_dim
        kw = dict(device=device, dtype=dtype, std=c.initializer_range,
                  generator=generator)
        self.qkv_proj = ColumnParallelLinear(c.hidden_size,
                                             3 * c.hidden_size, **kw)
        self.out_proj = RowParallelLinear(c.hidden_size, c.hidden_size,
                                          **kw)
        self.attn_dropout_p = c.attn_dropout
        self.use_flash = c.use_flash_attention

    def forward(self, x, cache=None, use_cache: bool = False,
                prefill_len=None, prefill_chained: bool = False, *,
                fused: bool = False):
        """``cache``: a ``PagedKVCache`` (ragged paged decode), a
        ``StaticKVCache`` (fixed-shape decode), or with ``use_cache`` a
        ``(k, v)`` pair or None (the eager cache: the new keys and
        values are concatenated to it). A cached call returns ``(out,
        new cache)``. The positional order is the JAX layer's
        (``gpt.py:704``)."""
        b, s, _ = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if isinstance(cache, PagedKVCache):
            return self._decode_paged(q, k, v, cache, b, s, prefill_len,
                                      prefill_chained, fused)
        if isinstance(cache, StaticKVCache):
            return self._decode_static(q, k, v, cache, b, s)
        if use_cache and cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        out = NF.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.attn_dropout_p,
            training=self.training, use_flash=bool(self.use_flash))
        out = self.out_proj(out.reshape(b, s, -1))
        return (out, (k, v)) if use_cache else out

    def _decode_static(self, q, k, v, cache: StaticKVCache, b, s):
        """Decode against a preallocated buffer (``gpt.py:752-782``): the
        new keys and values go in at ``pos`` by a device-side index (the
        start clamped so the chunk fits, as ``dynamic_update_slice``
        does), attention runs over the whole buffer under ``kpos <= pos +
        i`` (the plain math, ``use_flash=False``, as in JAX), and ``pos``
        advances in place."""
        total = cache.k.shape[1]
        dev = q.device
        ar = torch.arange(s, device=dev)
        pos = cache.pos.long()
        idx = torch.clamp(pos, 0, total - s) + ar
        cache.k.index_copy_(1, idx, k.to(cache.k.dtype))
        cache.v.index_copy_(1, idx, v.to(cache.v.dtype))
        kpos = torch.arange(total, device=dev)
        mask = (kpos[None, :] <= (pos + ar)[:, None])[None, None]
        out = NF.scaled_dot_product_attention(q, cache.k, cache.v,
                                              attn_mask=mask,
                                              use_flash=False)
        cache.pos.add_(s)
        return self.out_proj(out.reshape(b, s, -1)), cache

    def _decode_paged(self, q, k, v, cache, b, s, prefill_len,
                      prefill_chained, fused):
        """Paged decode/prefill (``gpt.py:784-873``): append through the
        page table, then

        - s == 1 (decode): the ragged paged-attention op — with
          ``fused``, attention and out-projection in one op;
        - s > 1 with ``prefill_len`` (a FRESH slot, seq_lens == 0):
          causal attention over this chunk's own k/v;
        - otherwise (chained prefill or a continuation): the paged
          reference with ``q_offsets`` = the old lengths, attending the
          stored prefix plus the chunk."""
        old_lens = cache.seq_lens
        new_cache = paged_kv_append(cache, k, v, valid_len=prefill_len)
        fw = self._fused_epilogue_params() if fused else None
        ops = dict(k_scale=new_cache.k_scale, v_scale=new_cache.v_scale)
        pools = (new_cache.k_pages, new_cache.v_pages,
                 new_cache.page_table, new_cache.seq_lens)
        if s == 1:
            if fw is not None:
                return NF.paged_attention_fused(q, *pools, fw[0], fw[1],
                                                **ops), new_cache
            out = NF.paged_attention(q, *pools, **ops)
        elif prefill_len is not None and not prefill_chained:
            out = NF.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=0.0, training=False,
                use_flash=bool(self.use_flash))
        else:
            if fw is not None:
                return NF.paged_attention_fused(
                    q, *pools, fw[0], fw[1], q_offsets=old_lens,
                    **ops), new_cache
            out = NF.paged_attention(q, *pools, q_offsets=old_lens, **ops)
        out = out.reshape(b, s, self.num_heads * self.head_dim)
        return self.out_proj(out), new_cache

    def _fused_epilogue_params(self):
        """(weight, bias) of the out-projection when the fused epilogue
        can fold it (``gpt.py:875-892``): a floating ``[H*D, E]``
        weight. A converted projection (``WeightOnlyInt8Linear``, whose
        weight lives in int8 buffers) has no ``weight`` and keeps the
        unfused composition."""
        w = getattr(self.out_proj, "weight", None)
        if w is None or not torch.is_floating_point(w) or \
                w.shape[0] != self.num_heads * self.head_dim:
            return None
        return w, getattr(self.out_proj, "bias", None)


class GPTMLP(Layer):
    def __init__(self, config: GPTConfig, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        c = config
        kw = dict(device=device, dtype=dtype, std=c.initializer_range,
                  generator=generator)
        inner = c.ffn_hidden_mult * c.hidden_size
        self.fc_in = ColumnParallelLinear(c.hidden_size, inner, **kw)
        self.fc_out = RowParallelLinear(inner, c.hidden_size, **kw)

    def forward(self, x):
        return self.fc_out(gelu(self.fc_in(x)))


class GPTBlock(Layer):
    """Pre-norm transformer block."""

    def __init__(self, config: GPTConfig, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        eps = config.layer_norm_epsilon
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.ln_1 = LayerNorm(config.hidden_size, eps, device=device,
                              dtype=dtype)
        self.attn = GPTAttention(config, **kw)
        self.ln_2 = LayerNorm(config.hidden_size, eps, device=device,
                              dtype=dtype)
        self.mlp = GPTMLP(config, **kw)
        self.dropout = Dropout(config.dropout)

    def forward(self, x, cache=None, use_cache=False, prefill_len=None,
                prefill_chained=False, *, fused=False):
        if cache is not None or use_cache:
            a, new_cache = self.attn(self.ln_1(x), cache, True,
                                     prefill_len=prefill_len,
                                     prefill_chained=prefill_chained,
                                     fused=fused)
            x = x + self.dropout(a)
            x = x + self.dropout(self.mlp(self.ln_2(x)))
            return x, new_cache
        x = x + self.dropout(self.attn(self.ln_1(x)))
        x = x + self.dropout(self.mlp(self.ln_2(x)))
        return x


class GPTModel(Layer):
    def __init__(self, config: GPTConfig, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.config = config
        c = config
        kw = dict(device=device, dtype=dtype, std=c.initializer_range,
                  generator=generator)
        self.wte = VocabParallelEmbedding(c.vocab_size, c.hidden_size, **kw)
        self.wpe = Embedding(c.max_seq_len, c.hidden_size, **kw)
        self.drop = Dropout(c.dropout)
        self.h = nn.ModuleList([
            GPTBlock(c, device=device, dtype=dtype, generator=generator)
            for _ in range(c.num_layers)])
        self.ln_f = LayerNorm(c.hidden_size, c.layer_norm_epsilon,
                              device=device, dtype=dtype)
        # selective remat is scoped to THIS model's forward
        # (``gpt.py:950-959``): building a model never touches the
        # process-wide selection of ``core.offload``
        self._remat_names = ((offload.ATTN_OUT_NAME,)
                             if c.remat_save_attention else None)

    def forward(self, input_ids, position_ids=None,
                caches: Optional[List[Any]] = None, use_cache: bool = False,
                prefill_lens=None, prefill_chained: bool = False, *,
                fused: bool = False):
        """The JAX positional order (``gpt.py:966-968``). ``caches``: one
        cache a layer, all of one kind: a ``PagedKVCache``, a
        ``StaticKVCache`` or an eager ``(k, v)`` pair (None before the
        first call). With caches, or ``use_cache`` (the eager pairs
        start empty), returns ``(hidden, new caches)``. Positions
        continue from the cache: each sequence's length, ``pos``, or the
        pair's length (``gpt.py:985-1000``)."""
        if self._remat_names is not None:
            with offload.override_remat_saved_names(self._remat_names):
                return self._forward(input_ids, position_ids, caches,
                                     use_cache, prefill_lens,
                                     prefill_chained, fused)
        return self._forward(input_ids, position_ids, caches, use_cache,
                             prefill_lens, prefill_chained, fused)

    def _forward(self, input_ids, position_ids, caches, use_cache,
                 prefill_lens, prefill_chained, fused):
        use_cache = use_cache or caches is not None
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
            c0 = caches[0] if caches is not None else None
            if isinstance(c0, PagedKVCache):
                # ragged: each sequence continues from ITS length
                position_ids = position_ids + c0.seq_lens[:, None].long()
            elif isinstance(c0, StaticKVCache):
                position_ids = position_ids + c0.pos.long()
            elif c0 is not None:
                position_ids = position_ids + c0[0].shape[1]
            position_ids = position_ids.expand(b, s)
        x = self.wte(input_ids) + self.wpe(position_ids)
        x = self.drop(x)
        if not use_cache:
            remat = self.config.remat and torch.is_grad_enabled()
            for i, block in enumerate(self.h):
                if remat and i % self.config.remat_every == 0:
                    x = _remat_block(block, x)
                else:
                    x = block(x)
            return self.ln_f(x)
        if caches is None:
            caches = [None] * len(self.h)
        new_caches = []
        for block, cache in zip(self.h, caches):
            x, nc = block(x, cache, True, prefill_lens, prefill_chained,
                          fused=fused)
            new_caches.append(nc)
        return self.ln_f(x), new_caches


class GPTForCausalLM(Layer):
    """GPT with the LM head tied to ``wte`` (or an untied ``[E, V]``
    head). Built on ``device`` (CUDA unless the caller names another;
    raises without a GPU) from ``generator`` (a fresh generator seeded
    with 0 when None)."""

    def __init__(self, config: GPTConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        dtype = _DTYPES[config.dtype]
        self.config = config
        self.gpt = GPTModel(config, device=dev, dtype=dtype,
                            generator=generator)
        self.loss_fn = ParallelCrossEntropy()
        if config.tie_word_embeddings:
            self.lm_head = None
        else:
            self.lm_head = ColumnParallelLinear(
                config.hidden_size, config.vocab_size, has_bias=False,
                device=dev, dtype=dtype, std=config.initializer_range,
                generator=generator)

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    def logits(self, hidden):
        """The head: the untied ``lm_head``, or the JAX op ``matmul``
        with ``wte`` transposed."""
        if self.lm_head is not None:
            return self.lm_head(hidden)
        hidden, w = amp_cast("matmul", hidden, self.gpt.wte.weight)
        return torch.matmul(hidden, w.t())

    def head_params(self):
        """``(weight, transpose_y, bias)`` of the lm head for the fused
        streaming sampler (``gpt.py:1073-1089``): the tied ``[V, E]`` wte
        with ``transpose_y=True``, or the untied ``[E, V]`` head; None
        when the head is not a floating matmul (an int8-converted head),
        and callers then take :meth:`logits`."""
        if self.lm_head is None:
            return self.gpt.wte.weight, True, None
        w = getattr(self.lm_head, "weight", None)
        if w is None or not torch.is_floating_point(w):
            return None
        return w, False, getattr(self.lm_head, "bias", None)

    def decode_hidden(self, input_ids, caches, prefill_lens=None,
                      prefill_chained: bool = False, fused: bool = False):
        """Cached forward returning final hidden states ``[B, S, E]`` and
        the new caches: the fused hot path samples straight from the
        hidden row, so the [B, S, vocab] logits never exist."""
        return self.gpt(input_ids, None, caches, True, prefill_lens,
                        prefill_chained, fused=fused)

    def verify_step(self, input_ids, caches, valid_len):
        """Speculative verify forward over paged slots
        (``gpt.py:1192-1218``): ``input_ids`` [B, s] is ``[cur, d_0, ..,
        d_{s-2}]`` a sequence, ``caches`` hold the PRE-verify lengths and
        ``valid_len`` [B] counts the real tokens of each row (0 parks a
        row: its writes land on the scratch page). The chunk is appended
        and attends the stored prefix plus itself through the chained
        path (``q_offsets`` = the old lengths), so position j's logits
        are the vanilla decode logits after ``cur, d_0..d_{j-1}``.
        Returns ``(logits [B, s, V], new caches)``; the caller keeps the
        lengths and rolls back past the accepted prefix."""
        return self.forward(input_ids, caches=caches,
                            prefill_lens=valid_len, prefill_chained=True)

    def _prompt_ids(self, input_ids) -> torch.Tensor:
        """The prompt [B, S] as int64 on the model's device."""
        return torch.as_tensor(input_ids, device=self.device).to(
            torch.int64)

    def generate(self, input_ids, max_new_tokens: int = 20,
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 use_jit: bool = False, kv_cache: str = "static",
                 page_size: int = 64, compile_mode: str = "whole"):
        """Greedy (``temperature=0``) or temperature / top-k sampling of
        ``max_new_tokens`` tokens after the prompt ``input_ids`` [B, S]
        (``gpt.py:1220-1292``); returns ``[B, S + N]`` int64, prompt
        first, on the model's device. Draws come from ``generator`` (a
        ``torch.Generator`` on that device; None: its default
        generator), the port's counterpart of JAX's ``key``.

        - The default is the eager loop over a ``(k, v)`` cache that
          grows a token a step, the debuggable reference.
        - ``use_jit=True`` is the one-launch mode: prefill into fresh
          preallocated caches (``kv_cache``: "static" dense buffers,
          "paged" pools with ``page_size`` pages, or "paged_int8" int8
          pools), then one decode step replayed as a CUDA graph N - 1
          times into a device token ring (:class:`_GenerateProgram`).
        - ``compile_mode="chunked"`` (with ``use_jit``, static cache
          only) runs the embedding, one block function over every
          layer's own parameters and buffers, and the head as separate
          calls, each through a ``RetryPolicy``. Its greedy tokens are
          bitwise the whole mode's."""
        if kv_cache not in ("static", "paged", "paged_int8"):
            raise ValueError(f"unknown kv_cache mode {kv_cache!r}")
        if compile_mode not in ("whole", "chunked"):
            raise ValueError(f"unknown compile_mode {compile_mode!r}")
        if kv_cache != "static" and not use_jit:
            raise ValueError("paged kv_cache requires use_jit=True")
        if compile_mode == "chunked" and not use_jit:
            raise ValueError("compile_mode='chunked' requires "
                             "use_jit=True (it IS a compile strategy)")
        if kv_cache != "static" and compile_mode == "chunked":
            raise ValueError(
                "compile_mode='chunked' decodes over the dense "
                "StaticKVCache only (its per-block programs exist to "
                "shrink compiles, not to change the cache layout)")
        if use_jit and compile_mode == "chunked" and max_new_tokens > 0:
            return self._generate_chunked(input_ids, max_new_tokens,
                                          temperature, top_k, generator)
        if use_jit and max_new_tokens > 0:
            return self._generate_jit(input_ids, max_new_tokens,
                                      temperature, top_k, generator,
                                      kv_cache=kv_cache,
                                      page_size=page_size)
        if max_new_tokens <= 0:
            return input_ids
        from ..nn.decode import sample_token
        self.eval()
        ids = self._prompt_ids(input_ids)
        temp = float(temperature)
        out = [ids]
        with torch.no_grad():
            logits, caches = self.forward(
                ids, caches=[None] * self.config.num_layers)
            for i in range(max_new_tokens):
                tok = sample_token(logits[:, -1], temp, top_k, generator)
                out.append(tok[:, None].to(torch.int64))
                if i + 1 < max_new_tokens:  # the last token feeds nothing
                    logits, caches = self.forward(out[-1], caches=caches)
        return torch.cat(out, dim=1)

    def _generate_jit(self, input_ids, max_new_tokens, temperature, top_k,
                      generator, kv_cache: str = "static",
                      page_size: int = 64):
        """The one-launch mode (``gpt.py:1294-1417``) through a
        :class:`_GenerateProgram`, cached on the model by JAX's signature
        ``(b, s, N, temperature, top_k, kv_cache, page_size)``, the
        kernel selection and whether the head is fused. A program whose
        weights were replaced or moved since it was built
        (``WeightWatch``: an in-place conversion) is dropped and built
        again, so no graph replays stale weights.

        The cache keeps the most recent program of each ``kv_cache``
        kind: building one closes the kind's older program, whose caches
        and graph then free their memory. JAX keeps a compiled program
        per signature, but a call's caches die with the call
        (``gpt.py:1331-1340``); a program here owns its caches, so a
        sweep over signatures holds one program's memory a kind."""
        from ..ops.nn_functional import plain_mode
        self.eval()
        ids = self._prompt_ids(input_ids)
        b, s = ids.shape
        sig = (b, s, int(max_new_tokens), float(temperature), top_k,
               kv_cache, int(page_size), plain_mode(),
               self.head_params() is not None)
        progs = self.__dict__.setdefault("_gen_programs", {})
        prog = progs.get(sig)
        if prog is not None and prog.watch.moved():
            prog.close()
            prog = None
        if prog is None:
            for old in [k for k, p in progs.items()
                        if p.watch.moved() or p.kv_cache == kv_cache]:
                progs.pop(old).close()
            prog = progs[sig] = _GenerateProgram(
                self, b, s, int(max_new_tokens), float(temperature), top_k,
                kv_cache, int(page_size))
        return prog.run(ids, generator)

    def clear_generate_cache(self) -> None:
        """Drop the one-launch mode's cached programs: their caches and
        CUDA graphs free their device memory."""
        for prog in self.__dict__.pop("_gen_programs", {}).values():
            prog.close()

    def _generate_chunked(self, input_ids, max_new_tokens, temperature,
                          top_k, generator):
        """The per-block mode (``gpt.py:1419-1559``): the embedding, ONE
        block function applied to every layer's own parameters AND
        buffers (a converted layer keeps its int8 weights in buffers;
        binding the parameters alone would run every layer on block 0's),
        and the head, each call through a ``RetryPolicy`` at the sites
        ``jit.compile.embed`` / ``jit.compile.block`` /
        ``jit.compile.head``; then :func:`~..nn.decode.sample_token`. The
        callables are cached on the model (``_chunked_jit_cache``) by
        ``(temperature, top_k, parameter names, buffer names)``, so a
        conversion, which renames the state, adds an entry."""
        from ..distributed.resilience import RetryPolicy
        from ..nn.decode import sample_token
        self.eval()
        cfg = self.config
        if cfg.moe_experts > 0:
            raise ValueError("chunked compile supports dense blocks only")
        ids = self._prompt_ids(input_ids)
        b, s = ids.shape
        total = s + max_new_tokens
        dt = self.gpt.wte.weight.dtype
        temp, tk = float(temperature), top_k
        # transport errors only, as in JAX: a deterministic failure
        # propagates at once
        retry = RetryPolicy(max_attempts=3, base_delay_s=0.5,
                            retry_on=(ConnectionError, OSError))
        blk0 = self.gpt.h[0]
        pnames = [n for n, _ in blk0.named_parameters()]
        bnames = [n for n, _ in blk0.named_buffers()]

        def layer_state(blk):
            ps, bs = dict(blk.named_parameters()), dict(blk.named_buffers())
            return {**{n: ps[n] for n in pnames},
                    **{n: bs[n] for n in bnames}}

        states = [layer_state(blk) for blk in self.gpt.h]
        cache = self.__dict__.setdefault("_chunked_jit_cache", {})
        sig = (temp, tk, tuple(pnames), tuple(bnames))
        if sig not in cache:
            def embed_fn(ids_, pos0):
                pos = pos0.long() + torch.arange(ids_.shape[1],
                                                 device=ids_.device)
                return self.gpt.wte(ids_) + self.gpt.wpe(
                    pos[None].expand(ids_.shape))

            def block_fn(x, kv, state):
                return torch.func.functional_call(blk0, state, (x, kv))

            def head_fn(x):
                return self.logits(self.gpt.ln_f(x))[:, -1]

            def sample_fn(last, gen):
                return sample_token(last, temp, tk, gen)

            cache[sig] = (embed_fn, block_fn, head_fn, sample_fn)
        embed_fn, block_fn, head_fn, sample_fn = cache[sig]
        kvs = [static_cache_create(b, total, cfg.num_heads, cfg.head_dim,
                                   dt, device=ids.device)
               for _ in range(cfg.num_layers)]

        def run_stack(tokens):
            x = retry.call(embed_fn, tokens, kvs[0].pos,
                           site="jit.compile.embed")
            for i in range(cfg.num_layers):
                x, kvs[i] = retry.call(block_fn, x, kvs[i], states[i],
                                       site="jit.compile.block")
            return retry.call(head_fn, x, site="jit.compile.head")

        out = [ids]
        with torch.no_grad():
            nxt = sample_fn(run_stack(ids), generator)
            out.append(nxt[:, None].to(torch.int64))
            for _ in range(max_new_tokens - 1):
                nxt = sample_fn(run_stack(out[-1]), generator)
                out.append(nxt[:, None].to(torch.int64))
        return torch.cat(out, dim=1)

    def _chunked_lm_loss(self, hidden, labels, chunk: int):
        """Mean next-token CE over sequence chunks (``gpt.py:1103-1162``):
        each chunk's logits and CE run under ``torch.utils.checkpoint``,
        so the [B, S, vocab] logits never exist and backward recomputes
        one chunk's at a time. The mean divides by every position, as
        the full-logits loss does."""
        hid = hidden[:, :-1]
        lab = labels[:, 1:].long()
        b, s = lab.shape
        # the JAX chunk applies a tied head as a raw product, which no op
        # dispatches and so no auto_cast casts (gpt.py:1136-1138)
        head = self.lm_head if self.lm_head is not None else (
            lambda h: torch.matmul(h, self.gpt.wte.weight.t()))
        amp = current_args()  # the recompute re-enters it

        def chunk_loss(h, lab_c):
            with auto_cast(**amp):
                per = self.loss_fn(head(h), lab_c)
            return torch.where(lab_c != self.loss_fn.ignore_index, per,
                               torch.zeros_like(per)).sum()

        total = hidden.new_zeros((), dtype=torch.float32)
        for c0 in range(0, s, chunk):
            total = total + checkpoint(chunk_loss, hid[:, c0:c0 + chunk],
                                       lab[:, c0:c0 + chunk],
                                       use_reentrant=False)
        return total / (b * s)

    def forward(self, input_ids, labels=None, position_ids=None,
                caches=None, prefill_lens=None,
                prefill_chained: bool = False, fused: bool = False):
        """Logits, or with ``labels`` the mean next-token loss
        (``gpt.py:1164-1190``): the CE of ``logits[:, :-1]`` against
        ``labels[:, 1:]`` (``ignore_index`` -100 gives 0) averaged over
        all B * (S - 1) positions."""
        if caches is not None:
            hidden, new_caches = self.gpt(
                input_ids, position_ids, caches, True, prefill_lens,
                prefill_chained, fused=fused)
            return self.logits(hidden), new_caches
        hidden = self.gpt(input_ids, position_ids)
        if labels is None:
            return self.logits(hidden)
        if self.config.loss_chunk_size:
            return self._chunked_lm_loss(hidden, labels,
                                         self.config.loss_chunk_size)
        logits = self.logits(hidden)
        (per,) = amp_cast("mean", self.loss_fn(logits[:, :-1], labels[:, 1:]))
        return per.mean()


class _GenerateProgram:
    """One signature of :meth:`GPTForCausalLM.generate`'s one-launch mode:
    the port's counterpart of JAX's ``jax.jit`` over prefill plus a
    ``lax.scan`` of decode steps (``gpt.py:1294-1417``).

    It owns fresh caches of its kind (static buffers ``[B, S + N, H,
    D]``, or paged pools of ``B * ceil((S + N) / page)`` pages with one
    shared page table and lengths), the fed token ``cur`` [B], the token
    ring ``[N, B]`` and its device index, all at fixed addresses. A run
    clears the caches, prefills the prompt eagerly, then runs the decode
    step N - 1 times: each samples from the last hidden row, writes the
    ring at the index and feeds the token back. The step samples through
    ``fused_sample_token`` when ``head_params()`` is not None, else
    through the logits and ``sample_token``; the paged modes fold the
    attention epilogue (``fused=True``, JAX's ``fused_decode()``).

    On the card the step is ONE CUDA graph (``inference/graphs.py``
    ``IterationGraphs``: warmed up and captured on cleared caches, which
    the next run clears again; the wrappers' launches added once a
    replay) and the ring is read back once. Sampling draws from a
    private generator registered with the graph; each run seeds it
    from one draw of the caller's generator, which that draw advances,
    so a seed gives one stream whatever the program. On the CPU the same
    step runs as a plain loop. A failed capture or replay raises."""

    def __init__(self, model: "GPTForCausalLM", b: int, s: int, n: int,
                 temperature: float, top_k, kv_cache: str,
                 page_size: int):
        from ..inference.graphs import WeightWatch
        cfg = model.config
        dev = model.device
        self.model = model
        self.n = n
        self.temperature = temperature
        self.top_k = top_k
        self.kv_cache = kv_cache
        self.watch = WeightWatch(model)
        total = s + n
        dt = model.gpt.wte.weight.dtype
        nh, hd, nl = cfg.num_heads, cfg.head_dim, cfg.num_layers
        i32 = dict(dtype=torch.int32, device=dev)
        if kv_cache == "static":
            self.caches = [static_cache_create(b, total, nh, hd, dt,
                                               device=dev)
                           for _ in range(nl)]
            self.lens = None
        else:
            mp = -(-total // page_size)
            self.lens = torch.zeros((b,), **i32)
            table = torch.arange(b * mp, **i32).reshape(b, mp)
            self.caches = [paged_cache_create(
                b, b * mp, page_size, nh, hd, dt, mp,
                quantized=(kv_cache == "paged_int8"), page_table=table,
                seq_lens=self.lens, device=dev) for _ in range(nl)]
        self.plens = torch.full((b,), s, **i32)
        self.cur = torch.zeros((b,), **i32)
        self.ring = torch.zeros((n, b), **i32)
        self.j = torch.zeros((), **i32)
        self.gen = (torch.Generator(device=dev) if temperature != 0.0
                    else None)
        self.graphs = None
        if dev.type == "cuda" and n > 1:
            from ..inference.graphs import IterationGraphs
            if self.gen is not None and not hasattr(
                    torch.cuda.CUDAGraph, "register_generator_state"):
                raise NotImplementedError(
                    "sampled generate(use_jit=True) on CUDA needs "
                    "CUDAGraph.register_generator_state, which this torch "
                    "lacks: not yet ported, see ROADMAP.md")
            self.graphs = IterationGraphs(dev, ())
            self.graphs.capture("decode", self._iterate, self._clear,
                                generators=(self.gen,) if self.gen else ())

    def _clear(self) -> None:
        """Empty caches at position 0, the ring's index at 1."""
        for c in self.caches:
            for t in c[:2] if self.lens is None else c[:4]:
                if t is not None:
                    t.zero_()
            if self.lens is None:
                c.pos.zero_()
        if self.lens is not None:
            self.lens.zero_()
        self.j.fill_(1)

    def _step(self, ids, prefill: bool) -> torch.Tensor:
        """One forward of ``ids`` [B, s] into the caches and the next
        token [B] int32."""
        from ..nn.decode import fused_sample_token, sample_token
        m = self.model
        paged = self.lens is not None
        plens = self.plens if paged and prefill else None
        hp = m.head_params()
        if hp is not None:
            hidden, nc = m.decode_hidden(ids, self.caches,
                                         prefill_lens=plens, fused=paged)
            w, ty, bias = hp
            nxt = fused_sample_token(hidden[:, -1].contiguous(), w,
                                     self.temperature, self.top_k,
                                     self.gen, transpose_y=ty, bias=bias)
        else:
            logits, nc = m.forward(ids, caches=self.caches,
                                   prefill_lens=plens)
            nxt = sample_token(logits[:, -1], self.temperature, self.top_k,
                               self.gen)
        if paged:
            self.lens.copy_(nc[0].seq_lens)
        return nxt.to(torch.int32)

    def _iterate(self) -> None:
        """One decode step: feed ``cur``, write the ring at ``j``."""
        nxt = self._step(self.cur[:, None].long(), prefill=False)
        self.ring.index_copy_(0, self.j.long().view(1), nxt[None])
        self.cur.copy_(nxt)
        self.j.add_(1)

    def run(self, ids: torch.Tensor, generator) -> torch.Tensor:
        if self.gen is not None:
            # one draw of the caller's generator seeds this run's stream
            dev = (generator.device if generator is not None
                   else self.cur.device)
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                     device=dev).item())
            self.gen.manual_seed(seed)
        with torch.no_grad():
            self._clear()
            first = self._step(ids, prefill=True)
            self.ring[0].copy_(first)
            self.cur.copy_(first)
            for _ in range(self.n - 1):
                if self.graphs is not None:
                    self.graphs.replay("decode", ())
                else:
                    self._iterate()
            toks = self.ring.t().to(torch.int64)
        return torch.cat([ids, toks], dim=1)

    def close(self) -> None:
        """Drop the graph and the caches."""
        if self.graphs is not None:
            self.graphs.close()
            self.graphs = None
        self.caches = []


# -- checkpoint-state helpers ------------------------------------------------

def perturbed_state(state: dict, scale: float = 1e-3,
                    seed: int = 0) -> dict:
    """A deterministic variant of ``state`` (name -> numpy array, the
    form ``checkpoint_state`` returns) with every float leaf nudged by
    ``scale`` times a standard normal draw of ``default_rng(seed)``: a
    "new checkpoint" that is structurally identical but gives other
    logits, so a hot-swap's generation isolation is observable without
    training anything. Integer leaves and bf16 bit patterns pass through
    untouched. numpy throughout, so the result is bitwise the JAX
    package's ``perturbed_state`` on the same state and seed."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, arr in state.items():
        arr = np.asarray(arr)
        if np.issubdtype(arr.dtype, np.floating):
            out[name] = (arr + scale * rng.standard_normal(
                arr.shape).astype(arr.dtype)).astype(arr.dtype)
        else:
            out[name] = arr
    return out
