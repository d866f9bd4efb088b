"""Continuous-batching decode engine over the paged KV cache (port of
``paddle_tpu/inference/continuous_batching.py``).

A fixed-slot decode batch that admits and evicts sequences mid-flight,
recycling finished sequences' KV pages to newly admitted ones:

- DEVICE state: per-layer page pools, and per step a page table
  ``[num_slots, max_pages]``, lengths ``[num_slots]`` and the current
  token of each slot, copied from the host.
- HOST state: the free-list :class:`PageAllocator`, the wait queue and
  per-slot request bookkeeping. Admission allocates
  ``ceil((prompt + max_new) / page)`` pages and runs a bucket-padded
  prefill whose padding is redirected to the scratch page; eviction
  returns the pages and parks the slot on the scratch page at length 0
  (an empty slot attends nothing and yields zeros).

Where the JAX engine jits each step and donates the pools
(``donate_argnums=(1,)``), this engine runs the model eagerly and the
appends update the pool tensors in place (``index_put_`` in
``models/gpt.py paged_kv_append``).

``fused_step`` (the default) routes decode through
``paged_attention_fused`` (attention + out-projection) and samples
through the streaming lm-head argmax; ``fused_step=False`` runs the
unfused ops. Greedy tokens are identical either way on the CPU.

Serving hooks (each off by default):

- ``speculative``: draft-and-verify decoding
  (``inference/speculative.py``): a draft proposes k tokens a slot, ONE
  verify forward scores all k+1 positions (``models/gpt.py``
  ``verify_step``, the chained paged path) and each slot emits its
  longest accepted prefix plus one token. Admission reserves the whole
  capacity and binds only the prefill pages; each step grows the page
  set out of the reservation (``_ensure_pages``) and a rejection hands
  wholly unused pages back to it (``_rollback_pages``). Greedy tokens
  equal the vanilla engine's.
- ``prefill_chunk_tokens``: chunked prefill. Admission binds the pages
  without prefilling; each step advances at most one half-prefilled
  (``prefill_partial``) slot by one page-aligned chunk, padded to the
  one chunk bucket, before the decode step, which masks half-prefilled
  rows to the scratch page at length 0. A fresh first chunk keeps the
  dense prefill (``chained=False``); later chunks and cache hits are
  the chained prefill. Greedy tokens equal whole prefill's.

- ``prefix_cache``: refcounted full-page sharing across requests
  (``serving/prefix_cache.py``). Admission reuses the cached prefix
  pages and prefills only the suffix (the chained prefill: the slot
  starts at the cached length and attends the stored prefix through the
  paged reference); a finished prefill's full prompt pages move into the
  cache. With spill tiers the cache restores evicted pages through
  ``_read_page`` / ``_splice_page``.
- ``prefill_retry``: a ``distributed/resilience.py`` RetryPolicy
  retrying transient prefill failures at the ``serving.prefill`` site.
- fault sites (``distributed/fault_inject.py``): ``engine.step`` first
  thing in ``step()``, ``serving.prefill`` inside the prefill call,
  ``alloc.page`` in the allocator; ``dump_inflight`` and
  ``set_on_complete`` serve the server's resurrection replay.

- ``multi_step``: N > 1 replaces the per-token launch and readback by
  one macro launch per N tokens (``models/gpt.py`` ``multi_step_decode``):
  on the card a CUDA graph of one decode iteration
  (``inference/graphs.py``), captured once per engine and program kind
  and replayed N times with no host synchronisation between replays;
  on the CPU the same iteration as a plain loop. Admission and the
  boundary work run between launches; token delivery runs while the
  next launch computes (dispatch, then drain at the next boundary).
  With ``inprogram`` (the default) greedy speculation with an n-gram or
  self draft and chained prefill chunks run inside the launch. Greedy
  tokens equal ``multi_step=1``'s, which is the per-token engine.

Observability (``continuous_batching.py:1227-1431``):
``step_timeline()`` records each step's program launches and the pool's
occupancy by owner class; ``ledger_tail(n)`` and
``capacity_snapshot()`` read the page ledger and the pool;
``capture_costs`` records each program kind's flops and bytes at its
first launch (``inference/costs.py``, counted from shapes: PyTorch has
no ``cost_analysis``), read by ``program_costs()``;
``forecast_admission`` also charges the pool's forecast page burn
(``page_ledger.forecast_exhaustion``) over a request's expected
lifetime before admitting it.

Weight hot-swap: ``swap_weights(state, generation=)`` validates the
whole state against the model (key set, shapes, dtypes) before any
tensor is touched, copies it into the model's tensors in place (so the
CUDA graphs captured before replay the new weights), bumps
``weight_generation`` and moves the prefix cache to the new generation.
A mismatch, a busy engine or the serving generation is a typed
:class:`SwapFailed` with the old weights serving.

Not ported yet (the constructor raises ``NotImplementedError``, see
ROADMAP.md): tensor-parallel meshes.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import (Any, Callable, Dict, Hashable, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ..core.compile_cache import enable_compile_cache
from ..device import module_device, resolve_device
from ..distributed.fault_inject import InjectedFault, fault_point

__all__ = ["PageAllocator", "DecodeRequest", "RequestStats",
           "ContinuousBatchingEngine", "create_decode_engine",
           "SwapFailed"]


class SwapFailed(RuntimeError):
    """A weight hot-swap was refused or could not be applied
    (``continuous_batching.py:94``). Raised before any live tensor is
    touched: a mismatched state or an engine that is not at a swappable
    boundary leaves the old weights serving and the old generation
    pinned."""


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to paddle_tpu_torch, see ROADMAP.md")


class PageAllocator:
    """Host-side free-list allocator over the shared page pool
    (``continuous_batching.py:103-305``). Pages are ints in
    [0, num_pages); the scratch page (index num_pages) is never handed
    out. ``alloc`` is all-or-nothing. Reservations claim capacity
    without binding pages. ``ledger``: an optional
    :class:`~.page_ledger.PageLedger` every mutation is recorded in."""

    def __init__(self, num_pages: int, ledger=None):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages))
        self._owned: Dict[Hashable, List[int]] = {}
        self._reserved: Dict[Hashable, int] = {}
        self.ledger = ledger

    @property
    def free_count(self) -> int:
        return len(self._free) - self.reserved_total

    @property
    def reserved_total(self) -> int:
        return sum(self._reserved.values())

    def alloc(self, owner: Hashable, n: int) -> Optional[List[int]]:
        # chaos site: a transient allocation failure, raised before any
        # mutation; admission treats it as a non-fit and requeues
        fault_point("alloc.page")
        if n > self.free_count:
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(owner, []).extend(pages)
        if self.ledger is not None:
            self.ledger.record("alloc", owner, pages)
        return pages

    def reserve(self, owner: Hashable, n: int) -> bool:
        """All-or-nothing capacity claim (no physical pages bound)."""
        fault_point("alloc.page")
        if n > self.free_count:
            return False
        if n:
            self._reserved[owner] = self._reserved.get(owner, 0) + n
            if self.ledger is not None:
                self.ledger.record("reserve", owner, n=n)
        return True

    def reserved(self, owner: Hashable) -> int:
        return self._reserved.get(owner, 0)

    def alloc_reserved(self, owner: Hashable, n: int) -> List[int]:
        """Convert ``n`` pages of ``owner``'s reservation into pages."""
        held = self._reserved.get(owner, 0)
        if n > held:
            raise RuntimeError(
                f"{owner!r} asked for {n} reserved pages but holds a "
                f"reservation of {held}")
        pages = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(owner, []).extend(pages)
        if held == n:
            self._reserved.pop(owner, None)
        else:
            self._reserved[owner] = held - n
        if self.ledger is not None and pages:
            self.ledger.record("alloc_reserved", owner, pages)
        return pages

    def release_pages(self, owner: Hashable, pages: Sequence[int],
                      rereserve: bool = False) -> None:
        """Return specific pages to the free list (``rereserve`` turns
        them back into reservation)."""
        held = self._owned.get(owner, [])
        for p in pages:
            if p not in held:
                raise RuntimeError(
                    f"release of page {p} not owned by {owner!r}")
            held.remove(p)
            self._free.append(p)
        if not held:
            self._owned.pop(owner, None)
        if rereserve and pages:
            self._reserved[owner] = (self._reserved.get(owner, 0) +
                                     len(pages))
        if self.ledger is not None and pages:
            self.ledger.record("release", owner, pages,
                               rereserve=rereserve)

    def free(self, owner: Hashable) -> int:
        pages = self._owned.pop(owner, [])
        for p in pages:
            if p in self._free:  # double free = scheduler bug
                raise RuntimeError(f"page {p} double-freed")
        self._free.extend(pages)
        res_held = self._reserved.pop(owner, None) or 0
        if self.ledger is not None and (pages or res_held):
            self.ledger.record("free", owner, pages,
                               reserved_freed=res_held)
        return len(pages)

    def transfer(self, owner: Hashable, new_owner: Hashable,
                 pages: Sequence[int]) -> None:
        """Move specific pages between owners without freeing them."""
        held = self._owned.get(owner, [])
        for p in pages:
            if p not in held:
                raise RuntimeError(
                    f"transfer of page {p} not owned by {owner!r}")
            held.remove(p)
        if not held:
            self._owned.pop(owner, None)
        self._owned.setdefault(new_owner, []).extend(pages)
        if self.ledger is not None and pages:
            self.ledger.record("transfer", owner, pages,
                               new_owner=new_owner)

    def owners(self) -> Dict[Hashable, Tuple[int, ...]]:
        return {k: tuple(v) for k, v in self._owned.items()}

    def occupancy(self) -> Dict[str, int]:
        """Pool breakdown by owner class: ``inflight`` (request-owned),
        ``prefix_device`` (prefix-cache chains), ``dedup`` (cache pages
        a second request's identical prompt folded onto), ``reserved``
        (speculative capacity) and ``free``, summing to ``num_pages``;
        retries the benign dict-iteration race with the engine
        thread."""
        infl = pfx = dedup = reserved = 0
        for _ in range(3):
            infl = pfx = dedup = reserved = 0
            try:
                for owner, pages in list(self._owned.items()):
                    kind = owner[0] if isinstance(owner, tuple) and \
                        owner else None
                    if kind == "prefix":
                        pfx += len(pages)
                    elif kind == "dedup":
                        dedup += len(pages)
                    else:
                        infl += len(pages)
                reserved = self.reserved_total
                break
            except RuntimeError:
                continue
        free = max(0, self.num_pages - infl - pfx - dedup - reserved)
        return {"inflight": infl, "prefix_device": pfx, "dedup": dedup,
                "reserved": reserved, "free": free}

    def check_no_leak(self) -> None:
        if self._owned or self._reserved or \
                len(self._free) != self.num_pages:
            msg = (
                f"page leak: {sum(map(len, self._owned.values()))} owned "
                f"by {sorted(self._owned, key=str)}, "
                f"{self.reserved_total} reserved by "
                f"{sorted(self._reserved, key=str)} with "
                f"{len(self._free)}/{self.num_pages} free")
            if self.ledger is not None:
                msg += "\nledger forensics:\n" + self.ledger.forensics(
                    self._owned, self._reserved)
            raise RuntimeError(msg)


@dataclasses.dataclass
class RequestStats:
    """Per-request serving telemetry (time.monotonic timestamps), the
    record ``serving/metrics.py`` aggregates. The handoff fields (a
    feature not yet ported) stay at their defaults."""

    submit_t: float = 0.0
    admit_t: float = 0.0
    prefill_ms: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0
    tokens_out: int = 0
    prompt_len: int = 0
    cached_pages: int = 0
    cached_tokens: int = 0
    restored_pages: int = 0
    restored_host_pages: int = 0
    restored_disk_pages: int = 0
    restore_corrupt: int = 0
    restore_ms: float = 0.0
    handoff_pages: int = 0
    handoff_ms: float = 0.0
    prompt_pages: int = 0
    cache_enabled: bool = False
    prefill_attempts: int = 0
    prefill_chunks: int = 0
    spec_steps: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    peak_pages: int = 0
    page_seconds: float = 0.0

    @property
    def acceptance_rate(self) -> Optional[float]:
        if self.spec_drafted:
            return self.spec_accepted / self.spec_drafted
        return None

    @property
    def tokens_per_step(self) -> Optional[float]:
        if self.spec_steps and self.tokens_out > 1:
            return (self.tokens_out - 1) / self.spec_steps
        return None

    @property
    def queue_delay_s(self) -> Optional[float]:
        if self.admit_t and self.submit_t:
            return self.admit_t - self.submit_t
        return None

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit -> first generated token (includes queueing)."""
        if self.first_token_t and self.submit_t:
            return self.first_token_t - self.submit_t
        return None

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean per-output-token time after the first token."""
        if self.finish_t and self.first_token_t and self.tokens_out > 1:
            return ((self.finish_t - self.first_token_t)
                    / (self.tokens_out - 1))
        return None

    def to_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out["queue_delay_s"] = self.queue_delay_s
        out["ttft_s"] = self.ttft_s
        out["tpot_s"] = self.tpot_s
        out["acceptance_rate"] = self.acceptance_rate
        out["tokens_per_step"] = self.tokens_per_step
        return out


@dataclasses.dataclass
class DecodeRequest:
    """One generation request in the engine."""
    req_id: int
    prompt: np.ndarray                # [len] int32
    max_new_tokens: int
    eos_token: Optional[int] = None
    priority: int = 1                 # serving/scheduler.py Priority
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    # queued|prefill|prefill_partial|decoding|done|evicted|shed|failed
    # |deadline|stalled; prefill_partial is chunked prefill's stage: the
    # slot holds pages and prefill_done_len tokens of prompt KV, and
    # rides decode steps masked to the scratch page
    state: str = "queued"
    # chunked prefill: prompt tokens whose KV is stored (cache hits and
    # earlier chunks alike)
    prefill_done_len: int = 0
    # consecutive steps this request's next chunk was deferred by
    # higher-class decode work (the scheduler's starvation bound)
    chunk_deferrals: int = 0
    stats: RequestStats = dataclasses.field(default_factory=RequestStats)
    on_token: Optional[Callable[[int, int, bool], None]] = None
    cache_keys: Tuple[Hashable, ...] = ()   # prefix-cache chain refs held
    bypass_count: int = 0             # times a later request jumped us
    # absolute time.monotonic() deadline (None = no deadline)
    deadline_t: Optional[float] = None
    last_emit_t: float = 0.0
    # serving/tracing.py RequestTrace (None = unsampled) and the open
    # lifecycle-stage span (queue -> prefill -> decode)
    trace: Any = None
    span: Any = None
    # a handoff-blocking prefill job (a prefill_only request: the router
    # is mid-handoff and a decode replica waits on it); the scheduler
    # boosts it by cfg.handoff_boost priority levels
    handoff: bool = False

    @property
    def tokens(self) -> np.ndarray:
        return np.concatenate([self.prompt,
                               np.asarray(self.generated, np.int32)])


class ContinuousBatchingEngine:
    """Fixed-slot continuous batching over one paged decode step (greedy
    decoding, the deterministic serving mode).

    ``num_pages`` sizes the shared pool; with fewer pages than
    ``num_slots * max_pages`` admission blocks on the free list and
    pages are recycled between requests. ``prefix_cache``: a
    :class:`~..serving.prefix_cache.PrefixCache` of the same page size;
    ``prefill_retry``: a RetryPolicy for the ``serving.prefill`` site;
    ``speculative``: a :class:`~.speculative.SpeculativeConfig`, an int
    k or a draft source; ``verify_retry``: the ``serving.verify``
    site's policy ("site" resolves it, None turns retries off);
    ``prefill_chunk_tokens``: the chunk of chunked prefill, a positive
    multiple of ``page_size``. The arguments follow the JAX engine's
    order."""

    def __init__(self, model, num_slots: int = 4, page_size: int = 64,
                 max_seq_len: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 kv_int8: bool = False,
                 prompt_buckets: Sequence[int] = (),
                 scheduler=None, prefix_cache=None,
                 prefill_retry=None,
                 on_complete: Optional[Callable[["DecodeRequest"],
                                                None]] = None,
                 max_prefill_attempts: int = 3,
                 speculative=None, verify_retry="site",
                 stall_timeout_s: Optional[float] = None,
                 mesh=None,
                 prefill_chunk_tokens: Optional[int] = None,
                 fused_step: bool = True,
                 multi_step: int = 1,
                 inprogram: bool = True,
                 tracer=None, timeline_steps: int = 256,
                 capture_costs: bool = False,
                 page_ledger: bool = True,
                 ledger_events: int = 1024,
                 forecast_admission: bool = False,
                 weight_generation: int = 0):
        if int(multi_step) < 1:
            raise ValueError(f"multi_step must be >= 1 (1 = per-token "
                             f"decode); got {multi_step}")
        if mesh is not None:
            raise _not_ported("mesh")
        # the kernel cache (PADDLE_TPU_COMPILE_CACHE): a restarted server
        # loads the kernel library its last run built instead of
        # compiling it again (``continuous_batching.py:489-496``)
        enable_compile_cache()
        self.model = model
        model.eval()
        # the generation of the weights this engine serves: swap_weights
        # bumps it, and the prefix cache salts its chain roots with it
        self.weight_generation = int(weight_generation)
        self.weight_swaps = 0
        # the swap drain gate, owned by the server: while True _admit
        # admits nothing, so the active slots drain and a pending swap
        # reaches num_active == 0 under continuous traffic
        self.pause_admission = False
        # byte-planning admission: _fits also charges the forecast page
        # burn of the admitted load over the request's lifetime
        self.forecast_admission = bool(forecast_admission)
        self.forecast_denials = 0
        # per program kind, its flops and bytes at its first launch
        self._capture_costs = bool(capture_costs)
        self._program_costs: Dict[str, Dict] = {}
        # the weights' addresses when the iteration graphs were
        # captured: a graph reads each weight there
        self._graph_weight_ptrs: Optional[Dict[str, int]] = None
        cfg = model.config
        self.cfg = cfg
        self.device = module_device(model)
        self.page_size = int(page_size)
        self.num_slots = int(num_slots)
        self.max_seq_len = int(max_seq_len or cfg.max_seq_len)
        if self.max_seq_len > int(cfg.max_seq_len):
            # the position table (wpe) has cfg.max_seq_len rows: a
            # position past it is an out-of-range lookup
            raise ValueError(
                f"max_seq_len={self.max_seq_len} exceeds the model's "
                f"position-embedding capacity "
                f"(cfg.max_seq_len={cfg.max_seq_len}); positions past "
                f"it would read garbage embeddings. Use a config with "
                f"a larger max_seq_len")
        self.max_pages = -(-self.max_seq_len // self.page_size)
        self.num_pages = int(num_pages if num_pages is not None
                             else num_slots * self.max_pages)
        self.kv_int8 = bool(kv_int8)
        if not prompt_buckets:
            bucket, prompt_buckets = self.page_size, []
            while bucket < self.max_seq_len:
                prompt_buckets.append(bucket)
                bucket *= 2
            prompt_buckets.append(self.max_seq_len)
        self.prompt_buckets = sorted(set(int(x) for x in prompt_buckets))
        if page_ledger:
            from .page_ledger import PageLedger
            self.ledger = PageLedger(capacity=int(ledger_events))
        else:
            self.ledger = None
        self.allocator = PageAllocator(self.num_pages, ledger=self.ledger)
        self._scratch = self.num_pages  # reserved page index
        from ..models.gpt import paged_cache_create
        dt = model.gpt.wte.weight.dtype
        nh, hd, nl = cfg.num_heads, cfg.head_dim, cfg.num_layers
        self._nl = nl
        protos = [paged_cache_create(
            1, self.num_pages, self.page_size, nh, hd, dt, self.max_pages,
            quantized=self.kv_int8, device=self.device) for _ in range(nl)]
        self._pools = {
            "k": [p.k_pages for p in protos],
            "v": [p.v_pages for p in protos],
            "ks": [p.k_scale for p in protos],
            "vs": [p.v_scale for p in protos],
        }
        # host-owned scheduler state
        self._table = np.full((self.num_slots, self.max_pages),
                              self._scratch, np.int32)
        self._lens = np.zeros((self.num_slots,), np.int32)
        self._cur = np.zeros((self.num_slots,), np.int32)
        self._slots: List[Optional[DecodeRequest]] = \
            [None] * self.num_slots
        self._queue: List[DecodeRequest] = []
        self._finished: Dict[int, DecodeRequest] = {}
        self._next_id = 0
        self.steps = 0
        self._scheduler = scheduler
        cache_ps = getattr(prefix_cache, "page_size", None)
        if cache_ps is not None and int(cache_ps) != self.page_size:
            # fail at construction, not as a page leak after the first
            # prefill's insert()
            raise ValueError(
                f"prefix_cache.page_size {cache_ps} != engine "
                f"page_size {self.page_size}")
        self._prefix_cache = prefix_cache
        if getattr(prefix_cache, "tiers", None):
            prefix_cache.attach_device_io(self._read_page,
                                          self._splice_page)
        self._prefill_retry = prefill_retry
        self._on_complete = on_complete
        self.max_prefill_attempts = int(max_prefill_attempts)
        self.stall_timeout_s = (None if stall_timeout_s is None
                                else float(stall_timeout_s))
        # chunked prefill: None admits with one whole prefill; a chunk
        # size makes admission bind pages without prefilling and each
        # step advance one half-prefilled slot by one chunk
        self.prefill_chunk_tokens: Optional[int] = None
        if prefill_chunk_tokens is not None:
            c = int(prefill_chunk_tokens)
            if c < self.page_size or c % self.page_size:
                raise ValueError(
                    f"prefill_chunk_tokens {c} must be a positive "
                    f"multiple of page_size {self.page_size} (chunks "
                    f"are page-aligned so every chunk boundary lands "
                    f"on a page boundary)")
            self.prefill_chunk_tokens = c
        # the deadline gate's estimates: decode_ema_s times only the
        # decode or verify call, prefill_chunk_ema_s one chunk (the
        # fixed bucket makes its cost a constant), so a prefill-heavy
        # step does not poison the per-token estimate
        self.decode_ema_s: Optional[float] = None
        self.prefill_chunk_ema_s: Optional[float] = None
        # the first chunk of each kind (fresh / chained) runs cold and
        # is left out of the chunk EMA, as the first decode step is
        self._chunk_warm = {False: False, True: False}
        # engine-wide time of the last chunk: the stall watchdog's
        # liveness signal for half-prefilled slots waiting their turn
        self._last_chunk_t = 0.0
        # multi-step decode: N iterations a macro launch, dispatched at
        # one boundary and drained at the next (``_macro_multi_step``)
        self.multi_step = int(multi_step)
        self.inprogram = bool(inprogram)
        # the launch's device state (carry, staged inputs, graphs),
        # built at the first launch
        self._macro: Optional[Dict[str, Any]] = None
        # the launch in flight: the output handles and the slot ->
        # request snapshot the drain folds back (None = nothing
        # dispatched)
        self._pending_macro: Optional[Dict[str, Any]] = None
        # drained but undelivered (req, token, done) emissions in the
        # per-token engine's (step, slot) order: delivered after the
        # next dispatch, flushed per request by _notify_complete
        self._pending_emit: List[Tuple] = []
        self.macro_launches = 0
        # the first launch (graph capture, cold caches) stays out of
        # the decode EMA, as the first decode step does
        self._macro_warm = False
        # engine-wide time of the last drain: the stall watchdog's
        # liveness signal for decoding slots between boundaries
        self._last_macro_t = 0.0
        # speculation and multi-step admission reserve the whole
        # capacity and bind the prefill pages (reserve-then-grow):
        # a verify step or a macro launch grows the page set out of
        # the reservation, so it cannot fail to allocate
        self._reserve_growth = (speculative is not None
                                or self.multi_step > 1)
        # per step program kind: the kernel launches of one graph
        # replay ("decode_multi", "decode_multi_chunk"; on the CPU the
        # operators one iteration dispatches)
        self.step_programs: Dict[str, int] = {}
        self._spec_cfg = None
        self._spec_draft = None
        self._spec_gen: Optional[torch.Generator] = None
        self._verify_retry = None
        if speculative is not None:
            from .speculative import as_spec_config
            self._spec_cfg = as_spec_config(speculative)
            self._spec_draft = self._spec_cfg.build_draft()
            if verify_retry == "site":
                from ..distributed.resilience import get_retry_policy
                verify_retry = get_retry_policy("serving.verify")
            self._verify_retry = verify_retry
        # in-program eligibility (``continuous_batching.py:836-857``):
        # speculation moves inside the macro launch when it is greedy
        # and its draft has a device twin (n-gram, self); chunks move
        # inside when speculation is off or inside too
        self._spec_inprogram = False
        self._spec_device_draft = None
        if (self.inprogram and self.multi_step > 1
                and self._spec_cfg is not None
                and float(self._spec_cfg.temperature) == 0.0):
            from .speculative import device_draft_params
            p = device_draft_params(self._spec_draft)
            if p is not None:
                self._spec_inprogram = True
                self._spec_device_draft = p
        self._chunk_inprogram = (
            self.inprogram and self.multi_step > 1
            and self.prefill_chunk_tokens is not None
            and (self._spec_cfg is None or self._spec_inprogram))
        # the steps that run as macro launches
        self._macro_mode = self.multi_step > 1 and (
            self._spec_cfg is None or self._spec_inprogram)
        self.fused_step = bool(fused_step)
        self._tracer = tracer
        self.timeline: "collections.deque" = collections.deque(
            maxlen=max(1, int(timeline_steps)))
        # the drained launch's record for the next _tl_commit
        self._tl_macro: Optional[Dict[str, Any]] = None
        # launches of each step program by kind ("prefill", "decode"),
        # in the engine's life and in the current step
        self.programs_launched: Dict[str, int] = {}
        self._tl_programs: Dict[str, int] = {}
        self._tl_ms: Dict[str, float] = {}
        self._weight_bytes = sum(t.numel() * t.element_size()
                                 for t in model.state_dict().values())

    # -- weight hot-swap ---------------------------------------------------

    def swap_weights(self, state_dict,
                     generation: Optional[int] = None) -> Dict[str, Any]:
        """Replace the model's weights between steps with a validated
        state (``continuous_batching.py:1051-1131``), bump the weight
        generation and move the prefix cache to it, so KV computed by
        the old weights misses by construction.

        The state (name -> host array, ``nn/layer.py``
        ``checkpoint_state``'s form; bf16 as ``BF16`` bit patterns) is
        checked against the model's own state dict (exact key set,
        shapes and dtypes, through ``nn.layer.numpy_dtype``) before any
        tensor is touched. It is then copied into the model's tensors in
        place, so the CUDA graphs captured before replay the new
        weights; a weight that moved since the capture (a reassigned
        ``Parameter``) is refused, since the graphs would read the old
        storage. Any refusal, and any in-flight work, is a typed
        :class:`SwapFailed` with the old weights serving and the old
        generation pinned. Queued requests survive: their memoized chain
        keys are dropped so they hash under the new generation.

        Returns ``{"generation", "leaves", "swap_ms"}``."""
        from ..nn.layer import load_jax_state, numpy_dtype
        t0 = time.monotonic()
        gen = int(generation) if generation is not None \
            else self.weight_generation + 1
        if gen == self.weight_generation:
            raise SwapFailed(
                f"generation {gen} is already serving; a swap must "
                f"move to a new weight generation")
        # a launch in flight still reads the old weights: drain it so
        # the swap lands between launches, never under one
        self._flush_macro()
        if self.num_active:
            raise SwapFailed(
                f"engine busy: {self.num_active} active slot(s) — "
                f"drain in-flight requests before swapping (old "
                f"requests finish on old weights)")
        own = self.model.state_dict()
        got = dict(state_dict)
        missing = [k for k in own if k not in got]
        extra = [k for k in got if k not in own]
        if missing or extra:
            raise SwapFailed(
                f"state-dict structure mismatch: missing "
                f"{sorted(missing)[:8]}, unexpected "
                f"{sorted(extra)[:8]} — a partial apply would serve "
                f"mixed tensors")
        bad = []
        for name, target in own.items():
            arr = np.asarray(got[name])
            if tuple(arr.shape) != tuple(target.shape):
                bad.append(f"{name}: shape {tuple(arr.shape)} vs "
                           f"{tuple(target.shape)}")
            elif arr.dtype != numpy_dtype(target.dtype):
                bad.append(f"{name}: dtype {arr.dtype} vs "
                           f"{target.dtype}")
        if bad:
            raise SwapFailed(
                f"state-dict tree mismatch ({len(bad)} leaves): "
                f"{bad[:4]}")
        if self._graph_weight_ptrs is not None:
            moved = [n for n, t in own.items()
                     if self._graph_weight_ptrs.get(n) != t.data_ptr()]
            if moved:
                raise SwapFailed(
                    f"{len(moved)} weight(s) moved since the iteration "
                    f"graphs were captured (e.g. {moved[0]!r}); the "
                    f"graphs would read the old storage")
        # fires after validation and before the first tensor write: an
        # abort here proves the all-or-nothing contract
        fault_point("swap.apply")
        load_jax_state(self.model, got)
        self.weight_generation = gen
        self.weight_swaps += 1
        if self._prefix_cache is not None:
            with self._led("swap"):
                self._prefix_cache.set_generation(gen, self.allocator)
        # queued requests memoized their chain keys under the old salt
        for req in self._queue:
            if hasattr(req, "_pfx_chain"):
                del req._pfx_chain
        return {"generation": gen,
                "leaves": len(own),
                "swap_ms": round((time.monotonic() - t0) * 1e3, 3)}

    # -- request lifecycle -------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               eos_token: Optional[int] = None, priority: int = 1,
               on_token: Optional[Callable[[int, int, bool], None]] = None,
               deadline_t: Optional[float] = None,
               trace=None, trace_ctx: Optional[Dict] = None,
               handoff: bool = False,
               handoff_info: Optional[Dict] = None) -> int:
        """Queue a request; returns its id. ``trace``: an existing
        RequestTrace to continue (the server's resurrection replay
        resubmits an in-flight request onto its tree); ``trace_ctx``: an
        upstream trace context that forces sampling. ``handoff=True``
        marks a handoff-blocking prefill job (the scheduler's boost);
        ``handoff_info={"ms": ..., "bytes": ...}`` records the wire fetch
        the server already made for this request (the fetched blobs sit
        in the prefix cache's tiers, and admission splices them through
        ``restore_from_spill``)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} exceeds "
                f"max_seq_len {self.max_seq_len}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the prefill "
                             "itself produces the first token)")
        if len(prompt) == 0:
            raise ValueError("prompt must hold at least one token")
        if len(prompt) > self.prompt_buckets[-1]:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the largest "
                f"prompt bucket {self.prompt_buckets[-1]}")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise ValueError(f"prompt token ids must lie in [0, "
                             f"{self.cfg.vocab_size})")
        need = -(-(len(prompt) + max_new_tokens) // self.page_size)
        if need > self.num_pages:
            raise ValueError(
                f"request needs {need} pages but the pool has only "
                f"{self.num_pages}; raise num_pages or shrink the "
                f"request")
        req = DecodeRequest(self._next_id, prompt, int(max_new_tokens),
                            eos_token, priority=int(priority),
                            on_token=on_token,
                            deadline_t=(None if deadline_t is None
                                        else float(deadline_t)),
                            handoff=bool(handoff))
        req.stats.submit_t = time.monotonic()
        req.stats.prompt_len = len(prompt)
        if handoff_info:
            req.stats.handoff_ms = float(handoff_info.get("ms", 0.0))
        self._next_id += 1
        tr = trace
        if tr is None and self._tracer is not None:
            if trace_ctx is not None:
                tr = self._tracer.start(
                    "request", ctx=trace_ctx, req_id=req.req_id,
                    prompt_len=len(prompt), max_new=int(max_new_tokens))
            elif self._tracer.sample():
                tr = self._tracer.start(
                    "request", sampled=True, req_id=req.req_id,
                    prompt_len=len(prompt), max_new=int(max_new_tokens))
        if tr is not None:
            req.trace = tr
            req.span = tr.begin("queue", parent=tr.anchor,
                                req_id=req.req_id, priority=int(priority),
                                prompt_len=len(prompt))
        self._queue.append(req)
        return req.req_id

    def result(self, req_id: int, pop: bool = False
               ) -> Optional[np.ndarray]:
        req = (self._finished.pop(req_id, None) if pop
               else self._finished.get(req_id))
        return None if req is None else req.tokens

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def num_queued(self) -> int:
        return len(self._queue)

    @property
    def free_pages(self) -> int:
        return self.allocator.free_count

    def check_no_leak(self) -> None:
        self.allocator.check_no_leak()

    @property
    def step_ema_s(self) -> Optional[float]:
        """The decode EMA under its older name (before the split into
        ``decode_ema_s`` and ``prefill_chunk_ema_s``)."""
        return self.decode_ema_s

    @step_ema_s.setter
    def step_ema_s(self, value: Optional[float]) -> None:
        self.decode_ema_s = value

    @property
    def prefill_debt_tokens(self) -> int:
        """Outstanding prefill work in tokens: the unstored prompt of
        every half-prefilled slot plus every queued prompt (an upper
        bound: later cache hits may shrink it). The server exports it
        as the ``serving_prefill_debt_tokens`` gauge."""
        debt = sum(len(r.prompt) - r.prefill_done_len
                   for r in self._slots
                   if r is not None and r.state == "prefill_partial")
        debt += sum(len(r.prompt) for r in self._queue)
        return debt

    def flight_summary(self) -> Dict[str, Any]:
        """JSON-safe state card for the crash flight recorder: occupancy,
        page pressure, EMAs, launch totals and the feature flags that
        shaped the programs. Host-side numbers only; safe to call on a
        dying engine."""
        return {
            "steps": int(self.steps),
            "num_slots": int(self.num_slots),
            "num_active": int(self.num_active),
            "num_queued": int(self.num_queued),
            "num_pages": int(self.num_pages),
            "free_pages": int(self.free_pages),
            "reserved_pages": int(self.allocator.reserved_total),
            "page_size": int(self.page_size),
            "max_seq_len": int(self.max_seq_len),
            "decode_ema_ms": (None if self.decode_ema_s is None
                              else round(self.decode_ema_s * 1e3, 3)),
            "prefill_chunk_ema_ms": (
                None if self.prefill_chunk_ema_s is None
                else round(self.prefill_chunk_ema_s * 1e3, 3)),
            "prefill_debt_tokens": int(self.prefill_debt_tokens),
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            "fused_step": bool(self.fused_step),
            "multi_step": int(self.multi_step),
            "macro_launches": int(self.macro_launches),
            "speculative": self._spec_cfg is not None,
            "mesh": None,  # single device (the mesh is not yet ported)
            "programs_launched": dict(self.programs_launched),
            "step_programs": dict(self.step_programs),
            "ledger_events": (None if self.ledger is None
                              else int(self.ledger.seq)),
        }

    def step_timeline(self) -> List[Dict[str, Any]]:
        """Per-step records, oldest first (bounded ring)."""
        return list(self.timeline)

    # -- device programs ---------------------------------------------------

    def _caches(self, table: torch.Tensor, lens: torch.Tensor):
        from ..models.gpt import PagedKVCache
        p = self._pools
        return [PagedKVCache(p["k"][i], p["v"][i], p["ks"][i], p["vs"][i],
                             table, lens) for i in range(self._nl)]

    def _fused_head(self):
        """``(weight, transpose_y, bias)`` of the streamed lm head, or
        None when fusion is off or the head is no floating matmul (an
        int8-converted head: the model's ``head_params`` gate)."""
        return self.model.head_params() if self.fused_step else None

    def _sample(self, hidden_or_logits, hp) -> torch.Tensor:
        from ..nn.decode import fused_sample_token, sample_token
        if hp is None:
            return sample_token(hidden_or_logits, 0.0)
        w, ty, bias = hp
        return fused_sample_token(hidden_or_logits.contiguous(), w, 0.0,
                                  transpose_y=ty, bias=bias)

    def _prefill_body(self, trow: torch.Tensor, lens: torch.Tensor,
                      plen: torch.Tensor, ids: torch.Tensor,
                      chained: bool) -> torch.Tensor:
        """The prefill on device tensors (``continuous_batching.py:
        1750``): ``ids`` [1, bucket] holding ``plen`` [1] real tokens
        after the ``lens`` [1] stored in the table row ``trow`` [1,
        max_pages]; writes their KV and returns the first generated
        token [1]. ``chained`` is the chained prefill (``gpt.py:
        798-874``): the suffix's positions start at ``lens`` and it
        attends the stored prefix through the paged reference. The
        boundary prefill and the macro launch's in-program chunk share
        it."""
        hp = self._fused_head()
        last = torch.clamp_min(plen.long() - 1, 0)
        caches = self._caches(trow, lens)
        if hp is not None:
            hidden, _ = self.model.decode_hidden(
                ids, caches, prefill_lens=plen, prefill_chained=chained,
                fused=True)
            return self._sample(hidden[0].index_select(0, last), hp)
        logits, _ = self.model.forward(
            ids, caches=caches, prefill_lens=plen,
            prefill_chained=chained)
        return self._sample(logits[0].index_select(0, last), None)

    def _run_prefill(self, row: np.ndarray, ids: np.ndarray, plen: int,
                     cached_len: int = 0) -> int:
        """One slot prefill of the bucket-padded ``ids`` [1, bucket]
        holding ``plen`` real tokens; writes their KV into the slot's
        pages and returns the first generated token. ``cached_len`` > 0
        is the chained prefill: the slot already holds that many tokens
        (shared prefix pages or earlier chunks) and only past them is
        written."""
        dev = self.device
        table = torch.from_numpy(row[None]).to(dev)
        lens = torch.tensor([cached_len], dtype=torch.int32, device=dev)
        plen_t = torch.tensor([plen], dtype=torch.int32, device=dev)
        ids_t = torch.from_numpy(ids).to(dev)
        with torch.no_grad():
            nxt = self._prefill_body(table, lens, plen_t, ids_t,
                                     cached_len > 0)
        return int(nxt[0].item())

    def _run_verify(self, tokens: np.ndarray, valid: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The speculative verify (``continuous_batching.py:1820-1876``):
        append each slot's pending token and drafts ``tokens`` [slots,
        k+1] (``valid`` real ones a row; 0 parks the row on the scratch
        page), score all k+1 positions in one chained forward and return
        (accept, resampled, full) on the host. With the fused head the
        greedy targets stream from the hidden states through
        ``fused_argmax`` over slots*(k+1) rows: no [slots, k+1, V]
        logits."""
        cfg = self._spec_cfg
        if float(cfg.temperature) and self._spec_gen is None:
            self._spec_gen = torch.Generator(
                device=self.device).manual_seed(int(cfg.seed))
        dev = self.device
        table_t = torch.from_numpy(self._table).to(dev)
        lens_t = torch.from_numpy(self._lens).to(dev)
        toks_t = torch.from_numpy(tokens).to(dev)
        valid_t = torch.from_numpy(valid).to(dev)
        with torch.no_grad():
            out = self._verify_body(table_t, lens_t, toks_t, valid_t)
        accept, resid, full = (t.cpu().numpy() for t in out)
        return accept, resid, full

    def _verify_body(self, table: torch.Tensor, lens: torch.Tensor,
                     toks: torch.Tensor, valid: torch.Tensor):
        """The verify on device tensors (``continuous_batching.py:
        1820``), shared by the boundary verify and the macro launch's
        in-program verify: appends ``toks`` [slots, k+1] (``valid``
        real ones a row), scores every position in one chained forward
        and returns (accept, resampled, full) device tensors."""
        from ..nn.decode import fused_verify_tokens, \
            speculative_verify_tokens
        cfg = self._spec_cfg
        temp = float(cfg.temperature)
        hp = self._fused_head()
        caches = self._caches(table, lens)
        if hp is not None:
            hidden, _ = self.model.decode_hidden(
                toks, caches, prefill_lens=valid, prefill_chained=True,
                fused=True)
            w, ty, bias = hp
            return fused_verify_tokens(
                hidden, toks[:, 1:], w, temp, cfg.top_k, self._spec_gen,
                transpose_y=ty, bias=bias)
        logits, _ = self.model.verify_step(toks, caches, valid)
        return speculative_verify_tokens(logits, toks[:, 1:], temp,
                                         cfg.top_k, self._spec_gen)

    def _check_pools_live(self, what: str) -> None:
        """Guard of every retrying launch site (prefill, chunk, verify):
        an engine whose pools were released (``release_device``) cannot
        launch, and a retry would only repeat the failure; raise a
        terminal, non-transient error instead."""
        if self._pools is None:
            raise RuntimeError(
                f"KV pools were released before this {what}; the engine "
                f"cannot step. Rebuild the engine")

    def _host(self, shape, dtype) -> torch.Tensor:
        """A host staging buffer: page-locked when the pools are on the
        card, so a copy to or from it is one DMA at the link's rate
        (PyTorch's host allocator caches these blocks)."""
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    @staticmethod
    def _as_numpy(host: torch.Tensor) -> np.ndarray:
        """A numpy view of a host buffer; bf16 as the prefix cache's
        ``BF16`` bit patterns (numpy has no bfloat16)."""
        if host.dtype == torch.bfloat16:
            from ..serving.prefix_cache import BF16
            return host.view(torch.int16).numpy().view(BF16)
        return host.numpy()

    def _read_page(self, page: int) -> List[Tuple]:
        """Copy one pool page to the host for the prefix cache's spill
        tier: per layer (k, v, k_scale, v_scale) numpy blocks. All
        layers are gathered into one device buffer (the scales' bytes
        after the pages' for int8 pools) and copied in ONE transfer with
        one synchronize, not one copy a layer. bf16 pages come back as
        their bytes, in the prefix cache's ``BF16`` dtype."""
        if self.ledger is not None:
            self.ledger.record("spill", None, pages=[int(page)])
        p, nl = self._pools, self._nl
        with torch.no_grad():
            kv = torch.stack([t[page] for t in p["k"] + p["v"]])
            if not self.kv_int8:
                host = self._host(kv.shape, kv.dtype)
                host.copy_(kv)
                host = self._as_numpy(host)
                return [(host[i], host[nl + i], None, None)
                        for i in range(nl)]
            sc = torch.stack([t[page] for t in p["ks"] + p["vs"]])
            flat = torch.cat([kv.reshape(-1).view(torch.uint8),
                              sc.reshape(-1).view(torch.uint8)])
            host = self._host(flat.shape, torch.uint8)
            host.copy_(flat)
            raw = host.numpy()
        nkv = kv.numel() * kv.element_size()
        kvh = raw[:nkv].view(np.int8).reshape(tuple(kv.shape))
        sch = raw[nkv:].view(np.float32).reshape(tuple(sc.shape))
        return [(kvh[i], kvh[nl + i], sch[i], sch[nl + i])
                for i in range(nl)]

    def _splice_page(self, pages: Sequence[int],
                     layers_list: Sequence[Sequence[Tuple]]) -> None:
        """Restore a run of spilled pages in one call: gather the
        per-page, per-layer host blocks into one staging buffer a kind
        ([nl, n, page, ...], one host copy), copy each to the device
        once and write every pool in place (``models/gpt.py``
        ``paged_page_splice``)."""
        from ..models.gpt import paged_page_splice
        from ..serving.prefix_cache import BF16
        from .costs import restore_cost

        def stack(idx):
            first = layers_list[0][0][idx]
            host = self._host(
                (self._nl, len(layers_list)) + first.shape,
                torch.bfloat16 if first.dtype == BF16 else
                torch.from_numpy(np.empty(0, first.dtype)).dtype)
            out = self._as_numpy(host)
            for j, layers in enumerate(layers_list):
                for i in range(self._nl):
                    out[i, j] = layers[i][idx]
            return host.to(self.device, non_blocking=True)

        if self.ledger is not None:
            self.ledger.record("splice", None,
                               pages=[int(p) for p in pages])
        t0 = time.monotonic()
        k, v = stack(0), stack(1)
        ks = vs = None
        if self.kv_int8:
            ks, vs = stack(2), stack(3)
        idx = torch.as_tensor(np.asarray(pages, np.int64),
                              device=self.device)
        with torch.no_grad():
            paged_page_splice(self._pools, idx, k, v, ks, vs)
        self._launched("restore")
        self._capture_cost("restore", lambda: restore_cost(
            self.cfg, len(pages), self.page_size, self._kv_pos_bytes()))
        self._tl_ms["splice_ms"] = (self._tl_ms.get("splice_ms", 0.0)
                                    + (time.monotonic() - t0) * 1e3)

    def _decode_body(self, table: torch.Tensor, lens: torch.Tensor,
                     cur: torch.Tensor):
        """The ONE single-token decode step body on device tensors
        (``continuous_batching.py:1588``): the per-token step and every
        iteration of a macro launch run it, so the two give the same
        tokens by construction. ``cur`` [slots] int32; returns (next
        tokens, new lengths)."""
        hp = self._fused_head()
        caches = self._caches(table, lens)
        if hp is not None:
            hidden, nc = self.model.decode_hidden(cur[:, None], caches,
                                                  fused=True)
            return self._sample(hidden[:, -1], hp), nc[0].seq_lens
        logits, nc = self.model.forward(cur[:, None], caches=caches)
        return self._sample(logits[:, -1], None), nc[0].seq_lens

    def _run_decode(self, table: np.ndarray, lens: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """One single-token decode step for every slot: returns (next
        tokens, new lengths) on the host."""
        dev = self.device
        table_t = torch.from_numpy(table).to(dev)
        lens_t = torch.from_numpy(lens).to(dev)
        cur = torch.from_numpy(self._cur).to(dev)
        with torch.no_grad():
            nxt, new_lens = self._decode_body(table_t, lens_t, cur)
        return nxt.cpu().numpy(), new_lens.cpu().numpy()

    def _launched(self, kind: str) -> None:
        self.programs_launched[kind] = \
            self.programs_launched.get(kind, 0) + 1
        self._tl_programs[kind] = self._tl_programs.get(kind, 0) + 1

    # -- program costs -----------------------------------------------------

    def _kv_pos_bytes(self) -> int:
        from .costs import kv_position_bytes
        item = self._pools["k"][0].element_size()
        return kv_position_bytes(self.cfg, item, self.kv_int8)

    def _capture_cost(self, kind: str, fn: Callable[[], Dict]) -> None:
        """Record ``kind``'s flops and bytes (``fn()``, counted from the
        launch's shapes by ``inference/costs.py``) at its first launch,
        on the engine thread (``continuous_batching.py:1376``). A
        failed count is recorded as its error and never fails a
        step."""
        if not self._capture_costs or kind in self._program_costs:
            return
        try:
            self._program_costs[kind] = fn()
        except Exception as e:  # cost capture must never break a step
            self._program_costs[kind] = {
                "error": f"{type(e).__name__}: {e}"}

    def _prefill_cost(self, bucket: int, cached: int) -> Dict:
        from .costs import prefill_cost
        head_rows = 1 if self.fused_step else bucket
        return prefill_cost(self.cfg, bucket, cached, head_rows,
                            self._weight_bytes, self._kv_pos_bytes())

    def _decode_cost(self, lens, emits=None, per_iter: int = 1) -> Dict:
        """A decode launch at the live slots' stored ``lens``: one
        iteration, or ``multi_step`` iterations in which slot ``i``
        emits ``emits[i]`` tokens. An in-program speculative iteration
        verifies ``per_iter`` = k+1 positions a slot, counted at the
        launch's lengths (how many it accepts is the data's)."""
        from .costs import decode_cost
        n = self.multi_step if emits is not None else 1
        if per_iter > 1:
            return self._verify_cost(lens, np.full(len(lens), per_iter),
                                     iterations=n)
        stops = () if emits is None else [int(e) for e in emits]
        return decode_cost(self.cfg, self.num_slots, lens,
                           self._weight_bytes, self._kv_pos_bytes(),
                           iterations=n, stops=stops)

    def _verify_cost(self, lens, valid, iterations: int = 1) -> Dict:
        """A verify forward: every slot's k+1 rows run the GEMMs and the
        head; a live slot at stored length ``lens[i]`` appends
        ``valid[i]`` positions, row ``j`` attending ``lens[i] + j + 1``."""
        from .costs import step_cost
        k1 = int(self._spec_cfg.k) + 1
        pairs = sum(int(v) * int(n) + int(v) * (int(v) + 1) // 2
                    for n, v in zip(lens, valid))
        rows = self.num_slots * k1 * iterations
        return step_cost(self.cfg, rows, pairs * iterations, rows,
                         int(np.sum(lens)) * iterations,
                         int(np.sum(valid)) * iterations,
                         self._weight_bytes * iterations,
                         self._kv_pos_bytes())

    def program_costs(self) -> Dict[str, Dict]:
        """Per program kind, the flops and bytes counted at its first
        launch (empty with capture off or before any launch)."""
        return dict(self._program_costs)

    def _tl_add_ms(self, key: str, seconds: float) -> None:
        self._tl_ms[key] = self._tl_ms.get(key, 0.0) + seconds * 1e3

    # -- tracing / ledger hooks -------------------------------------------

    def _tr_end(self, req: DecodeRequest, **args) -> None:
        tr = req.trace
        if tr is not None and req.span is not None:
            tr.end(req.span, **args)
            req.span = None

    def _led(self, reason: str, req_id: Optional[int] = None):
        if self.ledger is None:
            return contextlib.nullcontext()
        return self.ledger.why(reason, req_id)

    def ledger_tail(self, n: int = 256) -> List[Dict[str, Any]]:
        """The ledger ring's most recent events (the server's
        ``capacity`` op); [] with the ledger off."""
        return [] if self.ledger is None else self.ledger.tail(n)

    def capacity_snapshot(self) -> Dict[str, Any]:
        """Point-in-time capacity card (``continuous_batching.py:
        1248-1292``): pool occupancy by owner class (sums to num_pages),
        what the prefix cache could give back on demand, spill-tier
        residency and the ledger's stats. Host-side ints only, safe
        from any thread."""
        occ = self.allocator.occupancy()
        out: Dict[str, Any] = {
            "num_pages": int(self.num_pages),
            "page_size": int(self.page_size),
            "occupancy": occ,
            "used_fraction": round(
                1.0 - occ["free"] / self.num_pages, 4)
            if self.num_pages else 0.0,
            "steps": int(self.steps),
            "forecast_admission": bool(self.forecast_admission),
            "forecast_denials": int(self.forecast_denials),
        }
        pc = self._prefix_cache
        evictable = 0
        if pc is not None:
            # refcount-0 cache pages are reclaimed at every admission,
            # so the pressure figure is the unreclaimable remainder
            for _ in range(3):  # a read racing the engine thread
                try:
                    evictable = int(pc.evictable_pages())
                    break
                except RuntimeError:
                    continue
        out["evictable_pages"] = evictable
        out["unreclaimable_pages"] = max(
            0, self.num_pages - occ["free"] - evictable)
        out["unreclaimable_fraction"] = round(
            out["unreclaimable_pages"] / self.num_pages, 4) \
            if self.num_pages else 0.0
        if pc is not None and getattr(pc, "tiers", None):
            for t in pc.tiers:
                out[f"{t.name}_tier_pages"] = int(t.blob_count)
                out[f"{t.name}_tier_bytes"] = int(t.occupancy_bytes)
        if self.ledger is not None:
            out["ledger"] = self.ledger.stats()
        return out

    def _account_req_pages(self, req: DecodeRequest,
                           now: Optional[float] = None) -> None:
        """Fold the request's current page holding into its peak-pages
        and page-seconds attribution."""
        owned = len(self.allocator._owned.get(req.req_id, ()))
        st = req.stats
        st.peak_pages = max(st.peak_pages, owned)
        now = time.monotonic() if now is None else now
        last = getattr(req, "_pages_t", None)
        if last is not None and owned:
            st.page_seconds += owned * max(0.0, now - last)
        req._pages_t = now

    def _tl_commit(self, t_step: float) -> None:
        now = time.monotonic()
        for r in self._slots:
            if r is not None:
                self._account_req_pages(r, now)
        entry: Dict[str, Any] = {
            "step": self.steps,
            "t_us": t_step * 1e6,
            "ms": round((now - t_step) * 1e3, 4),
            "programs": self._tl_programs,
            "slots_active": self.num_active,
            "slots_decoding": sum(
                1 for r in self._slots
                if r is not None and r.state == "decoding"),
            "queued": len(self._queue),
            "free_pages": self.allocator.free_count,
            "reserved_pages": self.allocator.reserved_total,
            # the pool by owner class (sums to num_pages); the capacity
            # op's forecast reads the free deltas
            "occupancy": self.allocator.occupancy(),
        }
        pc = self._prefix_cache
        if pc is not None and getattr(pc, "tiers", None):
            for t in pc.tiers:
                entry[f"{t.name}_tier_pages"] = int(t.blob_count)
        for k, v in self._tl_ms.items():
            entry[k] = round(v, 4)
        # the boundary that drained a macro launch carries its record
        # (per_token_timeline() expands it into per-step rows)
        if self._tl_macro is not None:
            entry["macro"] = self._tl_macro
            self._tl_macro = None
        self.timeline.append(entry)

    # -- scheduler ---------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        return self.prompt_buckets[-1]

    def _fits(self, req: DecodeRequest) -> bool:
        """Could ``req`` be admitted now? Its whole capacity (prompt +
        max_new) against the free pages, which leave out every
        speculative reservation, plus what the prefix cache could evict,
        excluding the entries the request's own match would pin
        (``continuous_batching.py:1956-1992``); ``match`` memoizes the
        chain hashes on the request."""
        need = -(-(len(req.prompt) + req.max_new_tokens) // self.page_size)
        avail = self.allocator.free_count
        if self._prefix_cache is not None:
            keys, shared = self._prefix_cache.match(req.prompt, memo=req)
            need -= len(shared)
            avail += self._prefix_cache.evictable_pages(excluding=keys)
        if need <= avail and self.forecast_admission:
            # byte planning (``continuous_batching.py:1972-1990``): the
            # admitted load's forecast page burn (an EWMA over the
            # timeline's free-page deltas) over this request's horizon,
            # max_new_tokens at the decode EMA, shrinks what is free.
            # Under multi_step > 1 decode_ema_s times a whole launch, so
            # the horizon is N times longer, as in the reference
            from .page_ledger import forecast_exhaustion
            fc = forecast_exhaustion(self.step_timeline())
            rate = fc.get("rate_pages_per_s")
            if rate is not None and rate > 0 and \
                    self.decode_ema_s is not None:
                horizon_s = req.max_new_tokens * self.decode_ema_s
                burn = int(rate * horizon_s)
                if need > avail - burn:
                    self.forecast_denials += 1
                    return False
        return need <= avail

    def _partial_debt_by_class(self) -> Dict[int, int]:
        """In-flight prefill debt (the unstored prompt of half-prefilled
        slots) by priority class: the debt gate's input."""
        out: Dict[int, int] = {}
        for r in self._slots:
            if r is not None and r.state == "prefill_partial":
                rem = len(r.prompt) - r.prefill_done_len
                out[r.priority] = out.get(r.priority, 0) + rem
        return out

    def _debt_allows(self, req: DecodeRequest) -> bool:
        """The per-class prefill-debt gate (chunked mode under a
        scheduler whose config has ``max_prefill_debt_tokens``): a class
        is admitted while its in-flight debt plus this prompt's
        (less its cache hit) stays under the cap; a class with no
        in-flight debt is always admissible."""
        if self.prefill_chunk_tokens is None:
            return True
        cfg = getattr(self._scheduler, "cfg", None)
        cap = getattr(cfg, "max_prefill_debt_tokens", None)
        if cap is None:
            return True
        cur = self._partial_debt_by_class().get(req.priority, 0)
        if cur == 0:
            return True
        add = len(req.prompt)
        if self._prefix_cache is not None:
            _keys, shared = self._prefix_cache.match(req.prompt, memo=req)
            add -= len(shared) * self.page_size
        return cur + add <= cap

    def _admissible(self, req: DecodeRequest) -> bool:
        return self._fits(req) and self._debt_allows(req)

    def _select_next(self) -> Optional[DecodeRequest]:
        if not self._queue:
            return None
        if self._scheduler is not None:
            idx = self._scheduler.select(self._queue, self._admissible,
                                         time.monotonic())
            return self._queue.pop(idx) if idx is not None else None
        # built-in FIFO: head or nothing (don't starve the head)
        if self._admissible(self._queue[0]):
            return self._queue.pop(0)
        return None

    def _shed_overloaded(self) -> List[DecodeRequest]:
        if self._scheduler is None or not self._queue:
            return []
        doomed = self._scheduler.shed(self._queue, time.monotonic())
        for req in doomed:
            self._terminate_queued(req, "shed")
        return doomed

    def set_on_complete(self, fn: Optional[Callable[["DecodeRequest"],
                                                    None]]) -> None:
        """Swap the completion hook (the server detaches it before a
        resurrection's teardown)."""
        self._on_complete = fn

    def _notify_complete(self, req: DecodeRequest) -> None:
        # multi-step: a request ending at a boundary may still hold
        # undelivered ring tokens; they stream before its completion on
        # every terminal path
        self._flush_req_emissions(req)
        tr = req.trace
        if tr is not None:
            self._tr_end(req, state=req.state)
            tr.event("complete", parent=tr.anchor, state=req.state,
                     tokens_out=len(req.generated), req_id=req.req_id)
            tr._tracer.finish(tr, state=req.state)
        if self._on_complete is not None:
            self._on_complete(req)

    def _emit_token(self, req: DecodeRequest, tok: int) -> None:
        # fires BEFORE _maybe_finish so streamed tokens precede the
        # completion; callbacks run on the engine thread
        if self._macro_mode:
            # every emission of a multi-step engine rides the pending
            # queue, a boundary prefill's first token included, so the
            # stream keeps the per-token engine's (step, slot) order:
            # the drained ring (earlier steps) before this boundary's
            # admissions (``continuous_batching.py:2087-2105``)
            self._pending_emit.append((req, tok, self._finish_due(req)))
            return
        req.last_emit_t = time.monotonic()
        if req.on_token is not None:
            req.on_token(req.req_id, tok, self._finish_due(req))

    def _park(self, slot: int) -> None:
        self._table[slot] = self._scratch
        self._lens[slot] = 0
        self._cur[slot] = 0
        self._slots[slot] = None

    def _evict_slot(self, slot: int, state: str) -> DecodeRequest:
        """Tear one active slot down with a typed terminal ``state``."""
        req = self._slots[slot]
        self._account_req_pages(req)
        if self.ledger is not None and state in ("stalled", "deadline"):
            req.page_forensics = self.ledger.history_for_owner(req.req_id)
        with self._led(state, req.req_id):
            self.allocator.free(req.req_id)
            self._release_cache_keys(req)
        req.prefill_done_len = 0
        req.state = state
        req.done = True
        req.stats.finish_t = time.monotonic()
        req.stats.tokens_out = len(req.generated)
        self._park(slot)
        self._notify_complete(req)
        return req

    def _terminate_queued(self, req: DecodeRequest, state: str) -> None:
        self._queue.remove(req)
        req.state = state
        req.done = True
        req.stats.finish_t = time.monotonic()
        self._notify_complete(req)

    def _release_cache_keys(self, req: DecodeRequest) -> None:
        """Drop the request's prefix-cache pins (matched at admission,
        or the whole inserted chain); every exit path calls this."""
        if self._prefix_cache is not None and req.cache_keys:
            self._prefix_cache.release(req.cache_keys)
        req.cache_keys = ()

    def _deadline_hopeless(self, req: DecodeRequest, now: float) -> bool:
        """True when the request cannot finish before its deadline:
        already expired, or its best-case remaining work at the observed
        step times overshoots it (``continuous_batching.py:2155-2212``).
        Best case: one token when an EOS may end it, and a speculative
        step emits up to k+1 tokens. ``decode_ema_s`` times one launch:
        a step of the per-token engine, a macro launch of up to N
        iterations (N x (k+1) tokens with in-program speculation).
        Chunked mode adds the prompt's remaining chunks after its
        prefix-cache hit: at the chunk EMA, or with in-program chunks N
        a launch at the launch EMA. With no decode EMA yet only expiry
        counts."""
        if req.deadline_t is None:
            return False
        if now >= req.deadline_t:
            return True
        if self.decode_ema_s is None:
            return False
        need = 1 if req.eos_token is not None else req.max_new_tokens
        if self._spec_cfg is not None:
            per_step = self._spec_cfg.k + 1
            if self._spec_inprogram:
                per_step *= self.multi_step
        else:
            per_step = self.multi_step
        est = -(-need // per_step) * self.decode_ema_s
        if self.prefill_chunk_tokens is not None:
            cached = 0
            if self._prefix_cache is not None:
                _keys, shared = self._prefix_cache.match(req.prompt,
                                                         memo=req)
                cached = len(shared) * self.page_size
            chunks = -(-(len(req.prompt) - cached)
                       // self.prefill_chunk_tokens)
            if self._chunk_inprogram:
                est += -(-chunks // self.multi_step) * self.decode_ema_s
            elif self.prefill_chunk_ema_s is not None:
                est += chunks * self.prefill_chunk_ema_s
        return now + est > req.deadline_t

    def expire_deadlines(self, now: Optional[float] = None
                         ) -> List[DecodeRequest]:
        """Terminate everything past its deadline ("deadline" state):
        queued requests before prefill, active slots mid-flight. A
        multi-step engine first drains the launch in flight and delivers
        its tokens, so the sweep sees current slot state."""
        self._flush_macro()
        return self._expire_deadlines_inner(now)

    def _expire_deadlines_inner(self, now: Optional[float] = None
                                ) -> List[DecodeRequest]:
        now = time.monotonic() if now is None else now
        expired: List[DecodeRequest] = []
        for req in [r for r in self._queue
                    if r.deadline_t is not None and now >= r.deadline_t]:
            self._terminate_queued(req, "deadline")
            expired.append(req)
        for slot, req in enumerate(self._slots):
            if req is not None and req.deadline_t is not None \
                    and now >= req.deadline_t:
                expired.append(self._evict_slot(slot, "deadline"))
        return expired

    def evict_stalled(self, now: Optional[float] = None
                      ) -> List[DecodeRequest]:
        """Evict slots that delivered no token for ``stall_timeout_s``
        ("stalled" state); no-op with the watchdog off. A multi-step
        engine first drains the launch in flight."""
        if self.stall_timeout_s is None:
            return []
        self._flush_macro()
        return self._evict_stalled_inner(now)

    def _evict_stalled_inner(self, now: Optional[float] = None
                             ) -> List[DecodeRequest]:
        if self.stall_timeout_s is None:
            return []
        now = time.monotonic() if now is None else now
        out: List[DecodeRequest] = []
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            last = max(req.last_emit_t, req.stats.admit_t)
            if self.multi_step > 1 and req.state == "decoding":
                # tokens arrive once a boundary: drain progress anywhere
                # is a decoding slot's liveness, and a broken engine
                # stops draining, so a real stall still fires
                last = max(last, self._last_macro_t)
            if req.state == "prefill_partial":
                # a half-prefilled slot may be waiting its turn for the
                # one chunk a step: chunk progress anywhere is its
                # liveness, and a broken step lands no chunk at all
                last = max(last, self._last_chunk_t)
            if now - last > self.stall_timeout_s:
                out.append(self._evict_slot(slot, "stalled"))
        return out

    def dump_inflight(self) -> List[DecodeRequest]:
        """Every request the engine still owes an answer (active slots
        and the wait queue) in submission order: the resurrection input.
        Each one's prompt plus emitted tokens rebuilds its KV on a fresh
        engine by one prefill; a half-prefilled request has emitted
        nothing, so it is replayed from its prompt. Releases nothing;
        close() tears down. A multi-step engine first folds the launch in
        flight into the snapshot (its tokens were never delivered); if
        that launch failed, its tokens never existed for any client."""
        try:
            self._flush_macro()
        except Exception:
            self._pending_macro = None
            self._deliver_pending()
        live = [r for r in self._slots if r is not None]
        return sorted(live + list(self._queue), key=lambda r: r.req_id)

    def _admit(self) -> None:
        if self.pause_admission:
            # the swap drain gate: a request admitted now would pin a
            # slot against the pending weight swap
            return
        self._shed_overloaded()
        for slot in range(self.num_slots):
            if self._slots[slot] is not None:
                continue
            while True:
                req = self._select_next()
                if req is None:
                    return
                if self._deadline_hopeless(req, time.monotonic()):
                    req.state = "deadline"
                    req.done = True
                    req.stats.finish_t = time.monotonic()
                    self._notify_complete(req)
                    continue
                break
            committed = self._admit_into(slot, req)
            if committed is False:
                return
            if committed is None:
                continue
            note = getattr(self._scheduler, "note_admitted", None)
            if note is not None:
                note(req, self._queue, time.monotonic())

    def _unwind_prefill_failure(self, slot: int, req: DecodeRequest
                                ) -> None:
        """Free a failed prefill's pages (a whole prefill's, or every
        chunk's of a half-prefilled slot) with any speculative
        reservation, drop its cache pins and requeue it at the head for
        a prefill from scratch, or fail it typed after
        ``max_prefill_attempts``."""
        with self._led("prefill_unwind", req.req_id):
            self.allocator.free(req.req_id)
            self._release_cache_keys(req)
        self._park(slot)
        req.prefill_done_len = 0
        req.slot = None
        req.stats.prefill_attempts += 1
        if req.stats.prefill_attempts >= self.max_prefill_attempts:
            req.state = "failed"
            req.done = True
            req.stats.finish_t = time.monotonic()
            self._notify_complete(req)
        else:
            req.state = "queued"
            self._tr_end(req, state="prefill_failed")
            if req.trace is not None:
                req.span = req.trace.begin(
                    "queue", parent=req.trace.anchor,
                    retry=req.stats.prefill_attempts)
            self._queue.insert(0, req)

    def _admit_into(self, slot: int, req: DecodeRequest
                    ) -> Optional[bool]:
        """Admit ``req`` into ``slot`` (``continuous_batching.py:
        2351-2607``): True on a committed admission, False when it does
        not fit (stop admitting this step), None when its deadline
        expired during the prefill (unwound typed).

        With a prefix cache: match, then pin the matched chain before
        anything is allocated (neither a restore's eviction pressure nor
        the fallback below may reclaim those pages); extend the match
        from the spill tiers; allocate the private pages, evicting
        refcount-0 entries if the free list is short; build the table
        row with the shared pages first; prefill only the suffix
        (chained when something was cached); hand the full prompt pages
        to the cache after a successful prefill."""
        cache = self._prefix_cache
        tr = req.trace
        keys: Tuple[Hashable, ...] = ()
        shared: List[int] = []
        device_hits = 0
        if cache is not None:
            keys, shared = cache.match(req.prompt, memo=req)
            device_hits = len(keys)
            cache.acquire(keys)
            if cache.spill_enabled:
                rsp = (tr.begin("restore", parent=tr.anchor)
                       if tr is not None else None)
                with self._led("restore", req.req_id):
                    rkeys, rpages, rinfo = cache.restore_from_spill(
                        req.prompt, keys, self.allocator, memo=req)
                if rkeys and self.ledger is not None:
                    self.ledger.record("restore", req.req_id,
                                       pages=rpages)
                if tr is not None:
                    # fetched: restored pages whose blobs came over the
                    # wire rather than from a local eviction
                    tr.end(rsp, pages=len(rkeys),
                           fetched=rinfo.get("fetched", 0),
                           corrupt=rinfo.get("corrupt", 0))
                if rkeys:
                    cache.acquire(rkeys)
                    keys = tuple(keys) + rkeys
                    shared = list(shared) + rpages
                if rkeys or rinfo.get("corrupt"):
                    st = req.stats
                    st.restored_pages += len(rkeys)
                    st.restored_host_pages += rinfo.get("host", 0)
                    st.restored_disk_pages += rinfo.get("disk", 0)
                    st.restore_corrupt += rinfo.get("corrupt", 0)
                    st.restore_ms += rinfo.get("ms", 0.0)
                    st.handoff_pages += rinfo.get("fetched", 0)
        req._pfx_device_hits = device_hits
        cached_len = len(shared) * self.page_size
        need = -(-(len(req.prompt) + req.max_new_tokens) // self.page_size)
        private_need = need - len(shared)

        def grab():
            if not self._reserve_growth:
                return self.allocator.alloc(req.req_id, private_need)
            # speculation reserves the whole capacity and binds only the
            # prefill's pages: decode grows the set out of the
            # reservation (_ensure_pages), and a rejection hands unused
            # pages back to it (_rollback_pages), so no decode step can
            # fail to allocate
            prefill_need = (-(-len(req.prompt) // self.page_size)
                            - len(shared))
            if not self.allocator.reserve(req.req_id, private_need):
                return None
            return self.allocator.alloc_reserved(req.req_id, prefill_need)

        try:
            with self._led("admit", req.req_id):
                pages = grab()
                if pages is None and cache is not None and \
                        cache.evict_until(self.allocator, private_need):
                    pages = grab()
        except InjectedFault:
            # armed alloc.page: a transient allocation failure is a
            # non-fit (alloc raises before it mutates anything)
            pages = None
        if pages is None:
            if cache is not None:
                cache.release(keys)
            self._queue.insert(0, req)
            return False
        req.stats.admit_t = time.monotonic()
        self._account_req_pages(req, req.stats.admit_t)
        if tr is not None:
            exp = {}
            explain = getattr(self._scheduler, "explain", None)
            if explain is not None:
                exp = dict(explain(req, req.stats.admit_t))
            self._tr_end(req, bypass_count=req.bypass_count, **exp)
        req.stats.cached_pages = len(shared)
        req.stats.cached_tokens = cached_len
        req.stats.prompt_pages = (len(req.prompt) - 1) // self.page_size
        req.stats.cache_enabled = cache is not None
        req.cache_keys = keys
        req.state = "prefill"
        row = self._table[slot]
        row[:] = self._scratch
        row[:len(shared)] = shared
        row[len(shared):len(shared) + len(pages)] = pages
        if self.prefill_chunk_tokens is not None:
            # chunked admission: bind the pages and store nothing yet.
            # The slot's stored length is the cache hit; the matched
            # pins stay on req.cache_keys for every exit path, and
            # insert() runs when the last chunk lands
            req.state = "prefill_partial"
            req.prefill_done_len = cached_len
            req.slot = slot
            self._lens[slot] = cached_len
            self._cur[slot] = 0
            self._slots[slot] = req
            if tr is not None:
                req.span = tr.begin("prefill", parent=tr.anchor,
                                    chunked=True,
                                    remaining=len(req.prompt) - cached_len)
            return True
        suffix = req.prompt[cached_len:]
        plen = len(suffix)
        bucket = self._bucket(plen)
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :plen] = suffix
        chained = cached_len > 0
        sp_pref = (tr.begin("prefill", parent=tr.anchor, bucket=bucket,
                            chained=chained, cached_pages=len(shared))
                   if tr is not None else None)

        def run_prefill():
            self._check_pools_live("prefill")
            fault_point("serving.prefill")
            return self._run_prefill(row, ids, plen, cached_len)

        t0 = time.monotonic()
        try:
            if self._prefill_retry is not None:
                nxt = self._prefill_retry.call(run_prefill,
                                               site="serving.prefill")
            else:
                nxt = run_prefill()
        except Exception:
            # unwind so the request is retryable and its pages do not
            # leak, then surface the error. A prefill that failed
            # partway may have written private pages; the shared ones
            # hold positions below cached_len, which it never writes.
            if tr is not None:
                tr.end(sp_pref, error=True)
            self._unwind_prefill_failure(slot, req)
            raise
        kind = "prefill_chained" if chained else "prefill"
        self._launched(kind)
        self._capture_cost(kind, lambda: self._prefill_cost(bucket,
                                                            cached_len))
        now = time.monotonic()
        req.stats.prefill_ms = (now - t0) * 1e3
        self._tl_ms["prefill_ms"] = (self._tl_ms.get("prefill_ms", 0.0)
                                     + req.stats.prefill_ms)
        if tr is not None:
            tr.end(sp_pref, ms=round(req.stats.prefill_ms, 3))
        req.stats.prefill_attempts += 1
        req.stats.prefill_chunks = 1
        if req.deadline_t is not None and now >= req.deadline_t:
            # expired during the prefill: unwind typed instead of
            # delivering a token past the deadline
            self._account_req_pages(req, now)
            if self.ledger is not None:
                req.page_forensics = self.ledger.history_for_owner(
                    req.req_id)
            with self._led("deadline", req.req_id):
                self.allocator.free(req.req_id)
                self._release_cache_keys(req)
            self._table[slot] = self._scratch
            req.state = "deadline"
            req.done = True
            req.stats.finish_t = now
            self._notify_complete(req)
            return None
        req.stats.first_token_t = now
        self._lens[slot] = len(req.prompt)
        self._cur[slot] = nxt
        req.slot = slot
        req.state = "decoding"
        req.generated.append(nxt)
        req.stats.tokens_out = 1
        if cache is not None:
            # the full prompt pages now hold valid KV: ownership moves to
            # the cache, with this request's reference until it finishes
            # (row is the slot's table row: a dedup fold retargets it)
            req.cache_keys = cache.insert(
                req.prompt, row, self.allocator, req.req_id,
                self.page_size, keys, device_hits=device_hits)
        self._slots[slot] = req
        if tr is not None:
            tr.event("first_token", parent=tr.anchor, token=nxt)
            req.span = tr.begin("decode", parent=tr.anchor)
        self._emit_token(req, nxt)
        self._maybe_finish(slot)
        return True

    # -- chunked prefill ---------------------------------------------------

    def _select_chunk_slot(self, partial: List[Tuple[int, DecodeRequest]]
                           ) -> Optional[int]:
        """The half-prefilled slot that gets this step's chunk: the
        scheduler's ``select_chunk`` when it has one (higher-class decode
        may defer a lower-class chunk, a bounded number of times), else
        the oldest admission."""
        sel = getattr(self._scheduler, "select_chunk", None)
        if sel is not None:
            decoding = [r for r in self._slots
                        if r is not None and r.state == "decoding"]
            return sel(partial, decoding, time.monotonic())
        return min(partial, key=lambda sr: sr[1].req_id)[0]

    def _advance_prefill_chunk(self, slot: Optional[int] = None) -> bool:
        """Spend this step's prefill budget (``continuous_batching.py:
        2628-2765``): advance at most one half-prefilled slot by one
        page-aligned chunk of ``prefill_chunk_tokens``, padded to that
        one bucket. A chunk after stored tokens (earlier chunks or a
        cache hit) is the chained prefill; a fresh first chunk keeps the
        dense prefill, so a prompt that fits one chunk is the whole
        prefill's launch. The last chunk's token is the first generated
        one. Returns True when a chunk ran. ``slot``: a slot the
        in-program planner already picked (its fresh first chunk runs
        here), so the scheduler is asked once a boundary."""
        partial = [(i, r) for i, r in enumerate(self._slots)
                   if r is not None and r.state == "prefill_partial"]
        if not partial:
            return False
        if slot is None:
            slot = self._select_chunk_slot(partial)
        if slot is None:
            return False  # the scheduler deferred it: decode first
        req = self._slots[slot]
        cache = self._prefix_cache
        chunk = self.prefill_chunk_tokens
        done = req.prefill_done_len
        suffix = req.prompt[done:done + chunk]
        final = done + len(suffix) == len(req.prompt)
        ids = np.zeros((1, chunk), np.int32)
        ids[0, :len(suffix)] = suffix
        chained = done > 0
        row = self._table[slot]

        def run_chunk():
            self._check_pools_live("prefill")
            fault_point("serving.prefill")
            return self._run_prefill(row, ids, len(suffix), done)

        tr = req.trace
        sp_chunk = (tr.begin("prefill_chunk", parent=req.span,
                             idx=req.stats.prefill_chunks,
                             done_tokens=done)
                    if tr is not None else None)
        t0 = time.monotonic()
        try:
            if self._prefill_retry is not None:
                nxt = self._prefill_retry.call(run_chunk,
                                               site="serving.prefill")
            else:
                nxt = run_chunk()
        except Exception:
            # unwind the whole half-prefilled admission, not just this
            # chunk: the retry prefills from scratch
            if tr is not None:
                tr.end(sp_chunk, error=True)
            self._unwind_prefill_failure(slot, req)
            raise
        kind = "prefill_chained" if chained else "prefill"
        self._launched(kind)
        self._capture_cost(kind, lambda: self._prefill_cost(chunk, done))
        now = time.monotonic()
        dt = now - t0
        self._tl_ms["chunk_ms"] = self._tl_ms.get("chunk_ms", 0.0) + dt * 1e3
        if tr is not None:
            tr.end(sp_chunk, tokens=len(suffix))
        req.stats.prefill_ms += dt * 1e3
        req.stats.prefill_chunks += 1
        if self._chunk_warm[chained]:
            self.prefill_chunk_ema_s = dt \
                if self.prefill_chunk_ema_s is None \
                else 0.8 * self.prefill_chunk_ema_s + 0.2 * dt
        else:
            self._chunk_warm[chained] = True
        req.prefill_done_len = done + len(suffix)
        self._lens[slot] = req.prefill_done_len
        # chunk progress is liveness for the stall watchdog, for this
        # slot and (engine-wide) for the ones waiting their turn
        req.last_emit_t = now
        self._last_chunk_t = now
        req.chunk_deferrals = 0
        if req.deadline_t is not None and now >= req.deadline_t:
            # expired mid-prefill: evict typed (pages, reservation and
            # cache pins all return) instead of a token past the deadline
            self._evict_slot(slot, "deadline")
            return True
        if not final:
            return True
        req.stats.prefill_attempts += 1
        req.stats.first_token_t = now
        self._cur[slot] = nxt
        req.state = "decoding"
        req.generated.append(nxt)
        req.stats.tokens_out = 1
        if tr is not None:
            self._tr_end(req, chunks=req.stats.prefill_chunks)
            tr.event("first_token", parent=tr.anchor, token=nxt)
            req.span = tr.begin("decode", parent=tr.anchor)
        if cache is not None:
            # the full prompt pages now hold valid KV; a sibling with the
            # same prompt may have inserted them meanwhile, which is
            # where the dedup fold retargets this row
            req.cache_keys = cache.insert(
                req.prompt, row, self.allocator, req.req_id,
                self.page_size, req.cache_keys,
                device_hits=getattr(req, "_pfx_device_hits", None))
        self._emit_token(req, nxt)
        self._maybe_finish(slot)
        return True

    def _finish_due(self, req: DecodeRequest) -> bool:
        hit_eos = (req.eos_token is not None and req.generated and
                   req.generated[-1] == req.eos_token)
        return len(req.generated) >= req.max_new_tokens or hit_eos

    def _maybe_finish(self, slot: int) -> None:
        req = self._slots[slot]
        if req is not None and self._finish_due(req):
            self._finish_slot(slot)

    def _finish_slot(self, slot: int, notify: bool = True) -> None:
        """Terminal "done" teardown: free pages, park on scratch.
        ``notify=False`` (the macro drain) leaves the completion to the
        delivery, after the request's ring tokens."""
        req = self._slots[slot]
        req.done = True
        req.state = "done"
        req.stats.finish_t = time.monotonic()
        req.stats.tokens_out = len(req.generated)
        self._finished[req.req_id] = req
        self._account_req_pages(req)
        with self._led("done", req.req_id):
            self.allocator.free(req.req_id)
            self._release_cache_keys(req)
        self._park(slot)
        if notify:
            self._notify_complete(req)

    # -- stepping ----------------------------------------------------------

    def step(self) -> int:
        """Expire deadlines and stalls, admit what fits, spend the
        chunked-prefill budget (at most one slot's next chunk), run ONE
        decode step (or one draft-and-verify step) for every slot past
        prefill, finish what is done. Returns the number of still-active
        slots. The ``engine.step`` fault site fires first, before
        admission and any launch, so an injected failure leaves host and
        device state as the previous step left them (what the server's
        replay needs)."""
        fault_point("engine.step")
        self._tl_programs = {}
        self._tl_ms = {}
        if self.ledger is not None:
            self.ledger.step = self.steps
        t_step = time.monotonic()
        try:
            if self._macro_mode:
                # one boundary: drain launch K-1, the boundary work,
                # dispatch launch K, deliver K-1's tokens. A speculative
                # engine whose verify cannot move inside keeps its
                # per-step verify
                return self._macro_multi_step()
            self.expire_deadlines()
            self.evict_stalled()
            self._admit()
            if self.num_active == 0:
                return 0
            if self.prefill_chunk_tokens is not None:
                self._advance_prefill_chunk()
            if not any(r is not None and r.state == "decoding"
                       for r in self._slots):
                # every active slot is still mid-prefill: no decode step
                # this time; num_active keeps run() looping
                return self.num_active
            t0 = time.monotonic()
            try:
                if self._spec_cfg is not None:
                    return self._spec_step()
                return self._decode_step()
            finally:
                # only the decode or verify call is timed (chunks have
                # their own EMA), and the first step, warm-up dominated,
                # would poison the deadline gate's estimate
                if self.steps > 1:
                    dt = time.monotonic() - t0
                    self.decode_ema_s = dt if self.decode_ema_s is None \
                        else 0.8 * self.decode_ema_s + 0.2 * dt
        finally:
            self._tl_commit(t_step)

    def _decode_step(self) -> int:
        decoding = np.array([r is not None and r.state == "decoding"
                             for r in self._slots])
        table, lens = self._table, self._lens
        if any(r is not None and r.state == "prefill_partial"
               for r in self._slots):
            # half-prefilled slots ride the step masked to the scratch
            # page at length 0: their next position belongs to the next
            # chunk. The host keeps their real table and length.
            table = np.where(decoding[:, None], table,
                             self._scratch).astype(np.int32)
            lens = np.where(decoding, lens, 0).astype(np.int32)
        t0 = time.monotonic()
        nxt, lens_new = self._run_decode(table, lens)
        t1 = time.monotonic()
        self._launched("decode")
        self._capture_cost("decode", lambda: self._decode_cost(
            lens[decoding]))
        self._tl_ms["decode_ms"] = (t1 - t0) * 1e3
        self.steps += 1
        # slots not decoding wrote to the scratch page; keep their host
        # length (0 when empty, prefill_done_len when half-prefilled)
        self._lens = np.where(decoding, lens_new,
                              self._lens).astype(np.int32)
        for slot, req in enumerate(self._slots):
            if req is None or req.state != "decoding":
                continue
            tok = int(nxt[slot])
            req.generated.append(tok)
            req.stats.tokens_out = len(req.generated)
            self._cur[slot] = tok
            if req.trace is not None:
                req.trace.add("decode_step", t0 * 1e6, t1 * 1e6,
                              parent=req.span, step=self.steps, token=tok)
            self._emit_token(req, tok)
            self._maybe_finish(slot)
        return self.num_active

    # -- multi-step decode ---------------------------------------------------
    #
    # multi_step=N turns the per-token cadence into one macro launch per
    # N tokens (``continuous_batching.py:2855-3265``): _dispatch_macro
    # binds each decoding slot's growth pages out of its reservation and
    # starts the launch without waiting for it; the boundary that drains
    # launch K is the top of step K+1, and ring K-1's tokens are
    # delivered (callbacks, tracing, metrics) while launch K computes.
    # Admission and boundary chunks run between drain and dispatch: they
    # rewrite the launch's inputs and write the pools. Every external
    # entry point that reads or changes slot state (expire_deadlines,
    # evict_stalled, dump_inflight, close) drains the launch in flight
    # first, and _notify_complete streams a request's undelivered tokens
    # before its completion.

    def _plan_inprogram_chunks(self) -> Optional[Dict[str, Any]]:
        """Schedule up to ``multi_step`` chained chunks of one
        half-prefilled slot inside the next macro launch
        (``continuous_batching.py:2766-2835``): iteration j runs chunk j
        while the other slots decode. The scheduler is asked once, as at
        the boundary. A fresh first chunk of an uncached prompt keeps
        the dense prefill and runs here, at the boundary. Returns the
        plan (None: nothing to schedule this launch)."""
        partial = [(i, r) for i, r in enumerate(self._slots)
                   if r is not None and r.state == "prefill_partial"]
        if not partial:
            return None
        slot = self._select_chunk_slot(partial)
        if slot is None:
            return None  # the scheduler deferred it: decode first
        req = self._slots[slot]
        if req.prefill_done_len == 0:
            self._advance_prefill_chunk(slot=slot)
            return None
        n = self.multi_step
        chunk = self.prefill_chunk_tokens
        done = req.prefill_done_len
        total = len(req.prompt)
        count = min(n, -(-(total - done) // chunk))
        ids = np.zeros((n, chunk), np.int32)
        valid = np.zeros((n,), np.int32)
        start = np.zeros((n,), np.int32)
        final = np.zeros((n,), bool)
        pos = done
        for j in range(count):
            suffix = req.prompt[pos:pos + chunk]
            ids[j, :len(suffix)] = suffix
            valid[j] = len(suffix)
            start[j] = pos
            pos += len(suffix)
            final[j] = pos == total
        return {"slot": slot, "req": req, "count": count,
                "done0": done, "end": pos, "tokens": pos - done,
                "has_final": bool(final[:count].any()),
                "final_idx": int(np.argmax(final)) if final.any() else -1,
                "ids": ids, "valid": valid, "start": start,
                "final": final}

    def _macro_hist(self, chunk_plan: Optional[Dict[str, Any]] = None):
        """Token histories for the in-program draft: each decoding
        slot's prompt and generated tokens, right-padded to
        ``[num_slots, max_seq_len]``, so the device draft sees what the
        host draft would; the planned chunk slot's whole prompt, ready
        when its final chunk activates it."""
        hcap = int(self.max_seq_len)
        hist = np.zeros((self.num_slots, hcap), np.int32)
        hlen = np.zeros((self.num_slots,), np.int32)
        for i, r in enumerate(self._slots):
            if r is None:
                continue
            if r.state == "decoding":
                t = np.asarray(r.tokens, np.int32)
            elif chunk_plan is not None and i == chunk_plan["slot"]:
                t = np.asarray(r.prompt, np.int32)
            else:
                continue
            t = t[:hcap]
            hist[i, :len(t)] = t
            hlen[i] = len(t)
        return hist, hlen

    def _macro_state(self) -> Dict[str, Any]:
        """The macro launch's device state, built at the first launch:
        the loop carry, the staged inputs (page table, budgets, EOS ids,
        histories, the chunk schedule) at fixed addresses, page-locked
        host twins of the outputs on the card, and the graphs."""
        if self._macro is not None:
            return self._macro
        from ..models.gpt import MacroCarry
        from .graphs import Staging
        b, n, dev = self.num_slots, self.multi_step, self.device
        i32 = torch.int32
        k = int(self._spec_cfg.k) if self._spec_inprogram else 0
        carry = MacroCarry(b, n, dev, k=k,
                           hist_cap=self.max_seq_len if k else 0)
        specs: Dict[str, Any] = {
            "table": ((b, self.max_pages), i32), "rem": ((b,), i32),
            "eos": ((b,), i32), "cur": carry.cur, "lens": carry.lens,
            "act": carry.act}
        if k:
            specs.update(hist=carry.hist, hist_len=carry.hist_len)
        if self._chunk_inprogram:
            specs.update(ids=((n, self.prefill_chunk_tokens), i32),
                         valid=((n,), i32), start=((n,), i32),
                         final=((n,), torch.bool), slot=((), i32))
        out = None
        if dev.type == "cuda":
            out = {name: torch.empty(tuple(getattr(carry, name).shape),
                                     dtype=i32, pin_memory=True)
                   for name in ("ring", "steps", "cur", "lens")}
        self._macro = {"carry": carry, "io": Staging(dev, specs),
                       "out": out, "graphs": None,
                       "event": (torch.cuda.Event() if out is not None
                                 else None)}
        return self._macro

    def _macro_iterate(self, with_chunk: bool) -> None:
        """One iteration of the launch (``models/gpt.py``
        ``macro_iteration``) on the staged inputs: the decode body, or
        with in-program speculation the device draft and the verify
        body; ``with_chunk`` adds the scheduled chained chunk."""
        from ..models.gpt import macro_iteration
        m = self._macro
        io = m["io"].dev
        spec = chunk = None
        if self._spec_inprogram:
            spec = {"k": int(self._spec_cfg.k),
                    "vocab": int(self.cfg.vocab_size),
                    "draft_fn": self._device_draft,
                    "verify_fn": self._verify_body}
        if with_chunk:
            chunk = {"prefill_fn": self._chained_chunk_body,
                     "ids": io["ids"], "valid": io["valid"],
                     "start": io["start"], "final": io["final"],
                     "slot": io["slot"]}
        with torch.no_grad():
            macro_iteration(m["carry"], self._macro_step_body,
                            io["table"], io["rem"], io["eos"],
                            self._scratch, spec=spec, chunk=chunk)

    def _macro_step_body(self, table, lens, cur) -> torch.Tensor:
        return self._decode_body(table, lens, cur)[0]

    def _chained_chunk_body(self, trow, lens, plen, ids) -> torch.Tensor:
        return self._prefill_body(trow, lens, plen, ids, chained=True)

    def _device_draft(self, hist, hist_len, cur) -> torch.Tensor:
        """The draft as device math (``speculative.py``
        ``device_draft_params``): the n-gram lookup over the histories,
        or the self draft's repeat of the current token."""
        from ..nn.decode import ngram_draft_tokens
        d = self._spec_device_draft
        k = int(self._spec_cfg.k)
        if d["kind"] == "self":
            return cur[:, None].expand(cur.shape[0], k)
        return ngram_draft_tokens(hist, hist_len, k, d["max_ngram"],
                                  d["min_ngram"])

    def _macro_quiesce(self) -> None:
        """Every slot inactive and no chunk token valid: an iteration
        then writes only the scratch page (the graphs' warm-up)."""
        m = self._macro
        m["carry"].clear()
        m["carry"].act.zero_()
        io = m["io"].dev
        for name in ("valid", "start", "final", "slot"):
            if name in io:
                io[name].zero_()

    def _macro_capture(self, with_chunk: bool) -> None:
        """Capture the iteration graphs this launch needs and has not
        got yet; records each one's kernel launches in
        ``step_programs``. Graphs whose weights were replaced or moved
        since their capture (``convert_to_weight_only_int8`` swaps the
        layers; ``WeightWatch``) would read the old, freed storage: they
        are dropped and captured again on the model as it is."""
        from .graphs import IterationGraphs, WeightWatch, pools_key
        m = self._macro
        if m["graphs"] is not None and m["watch"].moved():
            m["graphs"].close()
            m["graphs"] = None
        if m["graphs"] is None:
            m["graphs"] = IterationGraphs(self.device,
                                          pools_key(self._pools))
            m["watch"] = WeightWatch(self.model)
            # a graph reads every weight at its address now: a swap must
            # copy into these tensors, never replace them
            self._graph_weight_ptrs = {
                name: t.data_ptr()
                for name, t in self.model.state_dict().items()}
        graphs = m["graphs"]
        kinds = (("decode", False),) + ((("chunk", True),)
                                        if with_chunk else ())
        for kind, chunk in kinds:
            if graphs.captured(kind):
                continue
            nodes = graphs.capture(
                kind, lambda c=chunk: self._macro_iterate(c),
                self._macro_quiesce)
            self.step_programs["decode_multi" + ("_chunk" if chunk
                                                 else "")] = nodes

    def _count_iteration_ops(self, with_chunk: bool) -> None:
        """On the CPU, the operators one iteration dispatches stand in
        for the graph's kernel launches in ``step_programs``: the
        first iteration of each kind runs under a counting mode."""
        from torch.utils._python_dispatch import TorchDispatchMode

        class _Count(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.n = 0

            def __torch_dispatch__(self, func, types, args=(),
                                   kwargs=None):
                self.n += 1
                return func(*args, **(kwargs or {}))

        with _Count() as ops:
            self._macro_iterate(with_chunk)
        self.step_programs["decode_multi" + ("_chunk" if with_chunk
                                             else "")] = ops.n

    def _macro_launch(self, active: np.ndarray, rem: np.ndarray,
                      eos: np.ndarray, hist, hlen,
                      plan: Optional[Dict[str, Any]]):
        """Stage the inputs and run the launch: on the card N graph
        replays (iterations j < count with the chunk), then the outputs
        copied into page-locked buffers behind an event, without
        waiting; on the CPU the plain early-exit loop. Returns the
        output handles and the event."""
        from ..models.gpt import run_macro_loop
        m = self._macro_state()
        carry, io = m["carry"], m["io"]
        n = self.multi_step
        count = int(plan["count"]) if plan is not None else 0
        cuda = self.device.type == "cuda"
        if cuda:
            self._macro_capture(count > 0)
        io.put("table", self._table)
        io.put("rem", rem)
        io.put("eos", eos)
        if plan is not None:
            for name in ("ids", "valid", "start", "final"):
                io.put(name, plan[name])
            io.put("slot", np.int32(plan["slot"]))
        carry.clear()
        io.put("cur", self._cur)
        io.put("lens", self._lens)
        io.put("act", active)
        if hist is not None:
            io.put("hist", hist)
            io.put("hist_len", hlen)
        if cuda:
            from .graphs import pools_key
            key = pools_key(self._pools)
            for j in range(n):
                m["graphs"].replay("chunk" if j < count else "decode", key)
            out = m["out"]
            for name, host in out.items():
                host.copy_(getattr(carry, name), non_blocking=True)
            m["event"].record()
            return out, m["event"]

        def iterate(with_chunk: bool) -> None:
            if "decode_multi" + ("_chunk" if with_chunk else "") in \
                    self.step_programs:
                self._macro_iterate(with_chunk)
            else:
                self._count_iteration_ops(with_chunk)

        run_macro_loop(carry, iterate, n, count)
        return ({name: getattr(carry, name)
                 for name in ("ring", "steps", "cur", "lens")}, None)

    def _dispatch_macro(self,
                        chunk_plan: Optional[Dict[str, Any]] = None
                        ) -> bool:
        """Start ONE macro launch of up to ``multi_step`` iterations over
        every decoding slot (``continuous_batching.py:2899-2990``);
        False when nothing decodes and no chunk is scheduled. Does not
        wait: the handles land in ``_pending_macro`` for the next
        boundary's drain. Each decoding slot's pages are bound first to
        cover ``lens + min(N x per_iter, rem)`` positions out of its
        reservation (cannot fail), so the table is a constant of the
        launch. With a chunk plan the slot enters inactive with its
        budget and EOS, and the launch activates it at its final
        chunk."""
        n = self.multi_step
        spec_on = self._spec_inprogram
        per_iter = (int(self._spec_cfg.k) + 1) if spec_on else 1
        reqs: Dict[int, DecodeRequest] = {}
        active = np.zeros((self.num_slots,), bool)
        rem = np.zeros((self.num_slots,), np.int32)
        eos = np.full((self.num_slots,), -1, np.int32)
        for i, r in enumerate(self._slots):
            if r is None or r.state != "decoding":
                continue
            r_rem = r.max_new_tokens - len(r.generated)
            active[i] = True
            rem[i] = r_rem
            if r.eos_token is not None:
                eos[i] = int(r.eos_token)
            self._ensure_pages(
                i, r, int(self._lens[i]) + min(n * per_iter, r_rem))
            reqs[i] = r
        if chunk_plan is not None:
            ci, cr = chunk_plan["slot"], chunk_plan["req"]
            rem[ci] = cr.max_new_tokens
            if cr.eos_token is not None:
                eos[ci] = int(cr.eos_token)
            if chunk_plan["has_final"]:
                # the slot may activate and decode inside this launch
                self._ensure_pages(
                    ci, cr, len(cr.prompt)
                    + min(n * per_iter, cr.max_new_tokens))
        if not reqs and chunk_plan is None:
            return False
        self._check_pools_live("macro launch")
        hist = hlen = None
        if spec_on:
            hist, hlen = self._macro_hist(chunk_plan)
        t0 = time.monotonic()
        out, event = self._macro_launch(active, rem, eos, hist, hlen,
                                        chunk_plan)
        self._launched("decode_multi")
        self._capture_cost("decode_multi", lambda: self._decode_cost(
            self._lens[active], np.minimum(rem[active], n * per_iter),
            per_iter))
        self.macro_launches += 1
        self._pending_macro = {
            "out": out, "event": event, "reqs": reqs, "t_dispatch": t0,
            "launch": self.macro_launches,
            "dispatch_ms": (time.monotonic() - t0) * 1e3,
            "rem": rem, "chunk": chunk_plan,
        }
        return True

    def _drain_macro(self) -> List[Tuple]:
        """Wait for the launch in flight (if any) and fold its ring into
        host state (``continuous_batching.py:2992-3184``): the generated
        lists, each slot's length and token, the teardown of finished
        slots (pages and reservations back; the completion waits for
        delivery), the per-launch decode EMA and the timeline's macro
        record. Returns the emissions ``[(req, token, done)]`` in the
        per-token engine's (step, slot) order, undelivered."""
        pend = self._pending_macro
        if pend is None:
            return []
        # cleared first: a failed launch raises at the wait, and the
        # same dead handles would only raise again
        self._pending_macro = None
        t_wait = time.monotonic()
        if pend["event"] is not None:
            pend["event"].synchronize()
        idle_s = time.monotonic() - t_wait
        out = pend["out"]
        ring = out["ring"].numpy().copy()
        nsteps = int(out["steps"])
        lens_f = out["lens"].numpy().copy()
        cur_f = out["cur"].numpy().copy()
        now = time.monotonic()
        self._last_macro_t = now
        dt = now - pend["t_dispatch"]
        # the decode EMA times one launch (per-token estimates are
        # ema / N, _deadline_hopeless); the first launch, with its
        # capture, stays out
        if self._macro_warm:
            self.decode_ema_s = dt if self.decode_ema_s is None \
                else 0.8 * self.decode_ema_s + 0.2 * dt
        else:
            self._macro_warm = True
        reqs = dict(pend["reqs"])
        plan = pend.get("chunk")
        spec_mode = ring.ndim == 3
        k = int(self._spec_cfg.k) if spec_mode else 0
        # every planned chunk ran (the launch keeps iterating through
        # iteration count - 1), so the chunk bookkeeping is unconditional;
        # a final chunk's first token sits in the ring at final_idx and
        # the slot joins the fold below
        if plan is not None:
            ci = plan["slot"]
            creq = plan["req"]
            if self._slots[ci] is creq and \
                    creq.state == "prefill_partial":
                creq.stats.prefill_chunks += plan["count"]
                creq.prefill_done_len = plan["end"]
                self._lens[ci] = plan["end"]
                creq.last_emit_t = now
                self._last_chunk_t = now
                creq.chunk_deferrals = 0
                if creq.trace is not None:
                    creq.trace.add(
                        "prefill_chunk_inprogram",
                        pend["t_dispatch"] * 1e6, now * 1e6,
                        parent=creq.span, chunks=plan["count"],
                        tokens=plan["tokens"], launch=pend["launch"])
                if creq.deadline_t is not None and \
                        now >= creq.deadline_t:
                    # expired mid-prefill: no token past the deadline
                    self._evict_slot(ci, "deadline")
                elif plan["has_final"]:
                    fj = plan["final_idx"]
                    nxt0 = int(ring[ci, fj, 0] if spec_mode
                               else ring[ci, fj])
                    creq.stats.prefill_attempts += 1
                    creq.stats.first_token_t = now
                    creq.state = "decoding"
                    if creq.trace is not None:
                        self._tr_end(creq,
                                     chunks=creq.stats.prefill_chunks)
                        creq.trace.event("first_token",
                                         parent=creq.trace.anchor,
                                         token=nxt0)
                        creq.span = creq.trace.begin(
                            "decode", parent=creq.trace.anchor)
                    if self._prefix_cache is not None:
                        creq.cache_keys = self._prefix_cache.insert(
                            creq.prompt, self._table[ci],
                            self.allocator, creq.req_id,
                            self.page_size, creq.cache_keys,
                            device_hits=getattr(
                                creq, "_pfx_device_hits", None))
                    reqs[ci] = creq
        emissions: List[Tuple] = []
        per_step_tokens: List[int] = []
        emitted_ct = {i: 0 for i in reqs}
        runs_tot = drafted_tot = accepted_tot = 0
        rem0 = pend["rem"]
        for j in range(nsteps):
            count = 0
            for i in sorted(reqs):
                req = reqs[i]
                if spec_mode:
                    toks = []
                    for t in ring[i, j]:
                        t = int(t)
                        if t < 0:
                            break  # a run's entries are front-packed
                        toks.append(t)
                else:
                    t = int(ring[i, j])
                    toks = [t] if t >= 0 else []
                if not toks:
                    continue
                if spec_mode and not (plan is not None
                                      and i == plan["slot"]
                                      and j == plan["final_idx"]):
                    # the verify step's stats, as the boundary path
                    # records them: drafted = the budget-clipped k_eff
                    # the launch used, accepted = the run less its
                    # correction or bonus token
                    k_eff = max(
                        min(k, int(rem0[i]) - emitted_ct[i] - 1), 0)
                    req.stats.spec_steps += 1
                    req.stats.spec_drafted += k_eff
                    req.stats.spec_accepted += max(len(toks) - 1, 0)
                    runs_tot += 1
                    drafted_tot += k_eff
                    accepted_tot += max(len(toks) - 1, 0)
                emitted_ct[i] += len(toks)
                for tok in toks:
                    req.generated.append(tok)
                    req.stats.tokens_out = len(req.generated)
                    emissions.append((req, tok, self._finish_due(req)))
                count += len(toks)
            per_step_tokens.append(count)
        for i in sorted(reqs):
            req = reqs[i]
            if self._slots[i] is not req:
                continue  # reassigned (the flush discipline rules it out)
            self._lens[i] = int(lens_f[i])
            self._cur[i] = int(cur_f[i])
            if self._finish_due(req):
                # teardown now, so the boundary's admission sees the
                # pages; the completion follows the request's tokens
                self._finish_slot(i, notify=False)
            elif spec_mode:
                # the in-program rewind left the lengths past the
                # rejected drafts: hand wholly unused pages back
                self._rollback_pages(i, req, int(lens_f[i]))
            if req.trace is not None:
                req.trace.add("macro_step", pend["t_dispatch"] * 1e6,
                              now * 1e6, parent=req.span,
                              step=self.steps + nsteps,
                              launch=pend["launch"],
                              steps_run=nsteps,
                              tokens=emitted_ct.get(i, 0))
        self.steps += nsteps
        self._tl_add_ms("decode_ms", dt)
        self._tl_add_ms("overlap_idle_ms", idle_s)
        self._tl_macro = {
            "launch": pend["launch"], "steps": nsteps,
            "masked_steps": self.multi_step - nsteps,
            "tokens": int(sum(per_step_tokens)),
            "per_step_tokens": per_step_tokens,
            "ms": round(dt * 1e3, 4),
            "overlap_idle_ms": round(idle_s * 1e3, 4),
            "dispatch_ms": round(pend["dispatch_ms"], 4),
        }
        if spec_mode:
            self._tl_macro["spec"] = {
                "runs": runs_tot, "drafted": drafted_tot,
                "accepted": accepted_tot}
        if plan is not None:
            self._tl_macro["chunks"] = int(plan["count"])
        return emissions

    def _flush_macro(self) -> None:
        """External-entry drain: wait for the launch in flight and
        deliver everything pending now, completions included. The
        boundary itself (_macro_multi_step) drains without delivering,
        and delivers after the next dispatch: that is the overlap."""
        if self._pending_macro is not None:
            self._pending_emit.extend(self._drain_macro())
        self._deliver_pending()

    def _flush_req_emissions(self, req: DecodeRequest) -> None:
        """Stream ONE request's undelivered tokens (tokens before the
        completion on a terminal path)."""
        if not self._pending_emit:
            return
        mine = [e for e in self._pending_emit if e[0] is req]
        if not mine:
            return
        self._pending_emit = [e for e in self._pending_emit
                              if e[0] is not req]
        for _req, tok, done in mine:
            req.last_emit_t = time.monotonic()
            if req.on_token is not None:
                req.on_token(req.req_id, tok, done)

    def _deliver_pending(self) -> None:
        """Deliver the drained emissions in order: callbacks, liveness,
        and the completion of a request that finished inside the
        launch, after its last token."""
        while self._pending_emit:
            req, tok, done = self._pending_emit.pop(0)
            req.last_emit_t = time.monotonic()
            if req.on_token is not None:
                req.on_token(req.req_id, tok, done)
            if done and req.done:
                self._notify_complete(req)

    def _macro_multi_step(self) -> int:
        """One multi-step boundary (``continuous_batching.py:3235``):
        drain launch K-1, the boundary work (deadline and stall sweeps,
        admission, chunk planning or one boundary chunk), dispatch
        launch K, then deliver K-1's tokens while K computes."""
        emissions = self._drain_macro()
        if emissions:
            self._pending_emit.extend(emissions)
        # the inner sweeps: the public ones would flush and deliver the
        # emissions just drained, forfeiting the overlap
        self._expire_deadlines_inner()
        self._evict_stalled_inner()
        self._admit()
        if self.num_active == 0:
            self._deliver_pending()
            return 0
        chunk_plan = None
        if self.prefill_chunk_tokens is not None:
            if self._chunk_inprogram:
                chunk_plan = self._plan_inprogram_chunks()
            else:
                self._advance_prefill_chunk()
        self._dispatch_macro(chunk_plan)
        self._deliver_pending()
        return self.num_active

    def per_token_timeline(self) -> List[Dict[str, Any]]:
        """The step timeline with each macro launch's entry expanded into
        one row an iteration (``continuous_batching.py:3265``); other
        entries pass through."""
        out: List[Dict[str, Any]] = []
        for entry in self.timeline:
            macro = entry.get("macro")
            if not macro or not macro.get("steps"):
                out.append(dict(entry))
                continue
            nsteps = macro["steps"]
            base = entry["step"] - nsteps
            for j, toks in enumerate(macro["per_step_tokens"]):
                out.append({
                    "step": base + j + 1,
                    "ms": round(macro["ms"] / nsteps, 4),
                    "tokens": toks,
                    "macro_launch": macro["launch"],
                    "macro_offset": j,
                })
        return out

    # -- speculative decoding ----------------------------------------------

    def _ensure_pages(self, slot: int, req: DecodeRequest,
                      need_len: int) -> None:
        """Grow the slot's page set to cover positions [0, need_len) out
        of the request's reservation, which admission committed, so it
        cannot fail."""
        row = self._table[slot]
        want = -(-need_len // self.page_size)
        missing = [j for j in range(want) if row[j] == self._scratch]
        if not missing:
            return
        reason = "spec_grow" if self._spec_cfg is not None else "macro_grow"
        with self._led(reason, req.req_id):
            pages = self.allocator.alloc_reserved(req.req_id, len(missing))
        for j, p in zip(missing, pages):
            row[j] = p

    def _rollback_pages(self, slot: int, req: DecodeRequest,
                        new_len: int) -> int:
        """Rejection rollback: a page all of whose positions lie at or
        past the accepted length holds only rejected drafts' KV and goes
        back into the request's reservation. The page holding position
        ``new_len`` (the next append) stays: its stale positions are
        never attended and the next append overwrites them. Shared
        prefix pages lie below ``new_len`` and are never touched."""
        row = self._table[slot]
        keep = -(-(new_len + 1) // self.page_size)
        victims = [int(row[j]) for j in range(keep, self.max_pages)
                   if row[j] != self._scratch]
        if victims:
            with self._led("spec_rollback", req.req_id):
                self.allocator.release_pages(req.req_id, victims,
                                             rereserve=True)
            row[keep:] = self._scratch
        return len(victims)

    def _spec_step(self) -> int:
        """One draft-and-verify step over every decoding slot
        (``continuous_batching.py:3333-3445``): propose k tokens a slot,
        score all k+1 positions in ONE verify forward, emit each slot's
        longest accepted prefix plus its correction or bonus token,
        rewind the lengths past the rejections and hand wholly unused
        pages back. Half-prefilled slots are not verified: their valid
        count stays 0 and their writes park on the scratch page."""
        cfg = self._spec_cfg
        k = cfg.k
        active = [i for i, r in enumerate(self._slots)
                  if r is not None and r.state == "decoding"]
        hist = [None if (r is None or r.state != "decoding")
                else r.tokens for r in self._slots]
        drafts = np.asarray(self._spec_draft.propose(hist, k), np.int32)
        if drafts.shape != (self.num_slots, k):
            raise ValueError(
                f"draft source returned shape {drafts.shape}, expected "
                f"{(self.num_slots, k)}")
        # a draft over a larger vocabulary must not feed the target an
        # out-of-range id (a wrong guess is free, an OOB one is not)
        drafts = np.clip(drafts, 0, self.cfg.vocab_size - 1).astype(
            np.int32)
        tokens = np.zeros((self.num_slots, k + 1), np.int32)
        tokens[:, 0] = self._cur
        tokens[:, 1:] = drafts
        valid = np.zeros((self.num_slots,), np.int32)
        old_lens = self._lens.copy()
        for i in active:
            req = self._slots[i]
            rem = req.max_new_tokens - len(req.generated)
            valid[i] = 1 + min(k, rem - 1)  # emit at most rem tokens
            self._ensure_pages(i, req, int(old_lens[i]) + int(valid[i]))

        def run_verify():
            self._check_pools_live("verify")
            fault_point("serving.verify")
            return self._run_verify(tokens, valid)

        t0v = time.monotonic()
        if self._verify_retry is not None:
            accept, resid, full = self._verify_retry.call(
                run_verify, site="serving.verify")
        else:
            accept, resid, full = run_verify()
        t1v = time.monotonic()
        self._launched("verify")
        self._capture_cost("verify", lambda: self._verify_cost(
            old_lens[active], valid[active]))
        self._tl_ms["verify_ms"] = (self._tl_ms.get("verify_ms", 0.0)
                                    + (t1v - t0v) * 1e3)
        self.steps += 1
        for i in active:
            req = self._slots[i]
            k_eff = int(valid[i]) - 1
            n = 0
            while n < k_eff and accept[i, n]:
                n += 1
            req.stats.spec_steps += 1
            req.stats.spec_drafted += k_eff
            req.stats.spec_accepted += n
            if req.trace is not None:
                req.trace.add("verify_step", t0v * 1e6, t1v * 1e6,
                              parent=req.span, step=self.steps,
                              drafted=k_eff, accepted=n)
            nxt = int(resid[i, n]) if n < k_eff else int(full[i, k_eff])
            emitted = [int(t) for t in tokens[i, 1:1 + n]] + [nxt]
            finished = False
            for tok in emitted:
                req.generated.append(tok)
                req.stats.tokens_out = len(req.generated)
                self._cur[i] = tok
                self._emit_token(req, tok)
                if self._finish_due(req):
                    finished = True
                    break  # EOS inside the accepted run: stop emitting
            if finished:
                # the teardown frees pages and reservation wholesale
                self._maybe_finish(i)
                continue
            # KV now covers cur and the n accepted drafts; the last
            # emitted token's KV is written by the next step
            new_len = int(old_lens[i]) + n + 1
            self._lens[i] = new_len
            self._rollback_pages(i, req, new_len)
        return self.num_active

    def run(self, max_steps: int = 100000) -> Dict[int, np.ndarray]:
        """Drive until queue and slots drain; returns and clears
        {req_id: tokens} of everything finished."""
        steps = 0
        while self._queue or self.num_active:
            before = (len(self._queue), self.num_active)
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} "
                                   f"steps (state {before})")
        if self._prefix_cache is None:
            self.allocator.check_no_leak()
        else:
            # cached prefix pages outlive their requests: audit the
            # cache's books against the allocator instead
            self._prefix_cache.check_consistent(self.allocator)
        out = {rid: req.tokens for rid, req in self._finished.items()}
        self._finished.clear()
        return out

    def close(self) -> None:
        """Evict every active slot, drop every queued request, return
        their pages, clear the prefix cache (its pages and tier blobs)
        and assert nothing leaked. A multi-step engine first drains and
        delivers the launch in flight (a failed one is dropped: its
        tokens never reached a client)."""
        try:
            self._flush_macro()
        except Exception:
            self._pending_macro = None
            self._deliver_pending()
        for slot, req in enumerate(self._slots):
            if req is not None:
                self._evict_slot(slot, "evicted")
        for req in list(self._queue):
            self._terminate_queued(req, "evicted")
        if self._prefix_cache is not None:
            with self._led("close"):
                self._prefix_cache.clear(self.allocator)
        self.allocator.check_no_leak()

    def release_device(self) -> None:
        """Drop the engine's device state, its KV pools, after
        ``close()``: a rebuilt engine allocates its own, and must not
        find the dead one's still held beside them. Detaches the prefix
        cache's device IO too (through it the cache and the engine
        reference each other). The engine cannot step afterwards. The
        macro launch's graphs go with the pools: a replay against freed
        pools is impossible."""
        if getattr(self._prefix_cache, "tiers", None):
            self._prefix_cache.attach_device_io(None, None)
        if self._macro is not None and self._macro["graphs"] is not None:
            self._macro["graphs"].close()
        self._macro = None
        self._pending_macro = None
        self._pools = None


def create_decode_engine(model, device=None,
                         **kwargs) -> ContinuousBatchingEngine:
    """Serving-path entry: a continuous-batching decode engine over a
    causal-LM model that lives on ``device`` (CUDA unless named; raises
    when the model lives elsewhere or no GPU is present)."""
    dev = resolve_device(device)
    have = module_device(model)
    if have.type != dev.type or (dev.index is not None and
                                 have.index != dev.index):
        raise ValueError(f"the model lives on {have}, not on {dev}; build "
                         f"it with device={str(dev)!r}")
    return ContinuousBatchingEngine(model, **kwargs)
