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
``remat_save_attention`` all but the attention kernel's forward.

Not ported yet (see ROADMAP.md): MoE, sequence parallelism, the static
KV cache and ``generate``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional

import torch
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..core import rng
from ..device import resolve_device
from ..nn.layer import checkpoint_state, load_jax_state  # noqa: F401
from ..nn.layers import (ColumnParallelLinear, Dropout, Embedding,
                         LayerNorm, ParallelCrossEntropy, RowParallelLinear,
                         VocabParallelEmbedding, gelu)
from ..ops import nn_functional as NF
from ..ops.kernels.attention import SavedAttention

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


def _remat_block(block: nn.Module, x, save_attention: bool = False):
    """Run ``block`` under ``torch.utils.checkpoint`` (``gpt.py:663-686``):
    its activations are recomputed in backward instead of kept. With
    ``save_attention`` (``remat_save_attention``, ``gpt.py:953-971``) the
    attention kernel's forward outputs are kept aside
    (``SavedAttention``) and the recompute takes them instead of running
    the kernel again; everything else is recomputed.

    The recompute runs on autograd's thread, so it re-opens what the
    forward saw in this thread: the ``key_scope`` generator, rewound to
    its state before the forward so dropout draws the same masks, and
    the kernel selection (:func:`NF.plain_kernels`)."""
    gen = rng.next_generator()
    plain = NF.plain_mode()
    before = gen.get_state() if gen is not None else None
    ran = []
    saved = SavedAttention() if save_attention else None

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
                    NF.saved_attention(saved):
                return block(h)
        finally:
            if after is not None:
                gen.set_state(after)

    return checkpoint(run, x, use_reentrant=False)


class GPTAttention(nn.Module):
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

    def forward(self, x, cache: Optional[PagedKVCache] = None,
                prefill_len=None, prefill_chained: bool = False,
                fused: bool = False):
        b, s, _ = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cache is not None:
            return self._decode_paged(q, k, v, cache, b, s, prefill_len,
                                      prefill_chained, fused)
        out = NF.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.attn_dropout_p,
            training=self.training, use_flash=bool(self.use_flash))
        return self.out_proj(out.reshape(b, s, -1))

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
        can fold it: a floating ``[H*D, E]`` weight."""
        w = self.out_proj.weight
        if not torch.is_floating_point(w) or \
                w.shape[0] != self.num_heads * self.head_dim:
            return None
        return w, self.out_proj.bias


class GPTMLP(nn.Module):
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


class GPTBlock(nn.Module):
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

    def forward(self, x, cache=None, prefill_len=None,
                prefill_chained=False, fused=False):
        if cache is not None:
            a, new_cache = self.attn(self.ln_1(x), cache,
                                     prefill_len=prefill_len,
                                     prefill_chained=prefill_chained,
                                     fused=fused)
            x = x + self.dropout(a)
            x = x + self.dropout(self.mlp(self.ln_2(x)))
            return x, new_cache
        x = x + self.dropout(self.attn(self.ln_1(x)))
        x = x + self.dropout(self.mlp(self.ln_2(x)))
        return x


class GPTModel(nn.Module):
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

    def forward(self, input_ids, position_ids=None,
                caches: Optional[List[PagedKVCache]] = None,
                prefill_lens=None, prefill_chained: bool = False,
                fused: bool = False):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
            if caches is not None:
                # ragged: each sequence continues from ITS length
                position_ids = (position_ids
                                + caches[0].seq_lens[:, None].long())
            position_ids = position_ids.expand(b, s)
        x = self.wte(input_ids) + self.wpe(position_ids)
        x = self.drop(x)
        if caches is None:
            remat = self.config.remat and torch.is_grad_enabled()
            for i, block in enumerate(self.h):
                if remat and i % self.config.remat_every == 0:
                    x = _remat_block(block, x,
                                     self.config.remat_save_attention)
                else:
                    x = block(x)
            return self.ln_f(x)
        new_caches = []
        for block, cache in zip(self.h, caches):
            x, nc = block(x, cache, prefill_len=prefill_lens,
                          prefill_chained=prefill_chained, fused=fused)
            new_caches.append(nc)
        return self.ln_f(x), new_caches


class GPTForCausalLM(nn.Module):
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
        if self.lm_head is not None:
            return self.lm_head(hidden)
        return torch.matmul(hidden, self.gpt.wte.weight.t())

    def head_params(self):
        """``(weight, transpose_y, bias)`` of the lm head for the fused
        streaming sampler: the tied ``[V, E]`` wte with
        ``transpose_y=True``, or the untied ``[E, V]`` head."""
        if self.lm_head is None:
            return self.gpt.wte.weight, True, None
        return self.lm_head.weight, False, self.lm_head.bias

    def decode_hidden(self, input_ids, caches, prefill_lens=None,
                      prefill_chained: bool = False, fused: bool = False):
        """Cached forward returning final hidden states ``[B, S, E]`` and
        the new caches: the fused hot path samples straight from the
        hidden row, so the [B, S, vocab] logits never exist."""
        return self.gpt(input_ids, None, caches, prefill_lens=prefill_lens,
                        prefill_chained=prefill_chained, fused=fused)

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

    def _chunked_lm_loss(self, hidden, labels, chunk: int):
        """Mean next-token CE over sequence chunks (``gpt.py:1103-1162``):
        each chunk's logits and CE run under ``torch.utils.checkpoint``,
        so the [B, S, vocab] logits never exist and backward recomputes
        one chunk's at a time. The mean divides by every position, as
        the full-logits loss does."""
        hid = hidden[:, :-1]
        lab = labels[:, 1:].long()
        b, s = lab.shape

        def chunk_loss(h, lab_c):
            per = self.loss_fn(self.logits(h), lab_c)
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
                input_ids, position_ids, caches, prefill_lens=prefill_lens,
                prefill_chained=prefill_chained, fused=fused)
            return self.logits(hidden), new_caches
        hidden = self.gpt(input_ids, position_ids)
        if labels is None:
            return self.logits(hidden)
        if self.config.loss_chunk_size:
            return self._chunked_lm_loss(hidden, labels,
                                         self.config.loss_chunk_size)
        logits = self.logits(hidden)
        return self.loss_fn(logits[:, :-1], labels[:, 1:]).mean()
