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

Not ported yet (the constructor raises ``NotImplementedError``, see
ROADMAP.md): speculative decoding, chunked prefill, multi-step decode,
tensor-parallel meshes, forecast admission and weight hot-swap.
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

from ..device import module_device, resolve_device
from ..distributed.fault_inject import InjectedFault, fault_point

__all__ = ["PageAllocator", "DecodeRequest", "RequestStats",
           "ContinuousBatchingEngine", "create_decode_engine"]


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
        ``prefix_device`` (prefix-cache chains), ``reserved`` and
        ``free``, summing to ``num_pages``; retries the benign
        dict-iteration race with the engine thread."""
        infl = pfx = reserved = 0
        for _ in range(3):
            infl = pfx = reserved = 0
            try:
                for owner, pages in list(self._owned.items()):
                    kind = owner[0] if isinstance(owner, tuple) and \
                        owner else None
                    if kind == "prefix":
                        pfx += len(pages)
                    else:
                        infl += len(pages)
                reserved = self.reserved_total
                break
            except RuntimeError:
                continue
        free = max(0, self.num_pages - infl - pfx - reserved)
        return {"inflight": infl, "prefix_device": pfx,
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
    record ``serving/metrics.py`` aggregates. Fields of features not yet
    ported (handoff, chunked prefill, speculation) stay at their
    defaults."""

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
    # queued|prefill|decoding|done|evicted|shed|failed|deadline|stalled
    state: str = "queued"
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
    ``prefill_retry``: a RetryPolicy for the ``serving.prefill`` site."""

    def __init__(self, model, num_slots: int = 4, page_size: int = 64,
                 max_seq_len: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 kv_int8: bool = False,
                 prompt_buckets: Sequence[int] = (),
                 scheduler=None,
                 on_complete: Optional[Callable[["DecodeRequest"],
                                                None]] = None,
                 max_prefill_attempts: int = 3,
                 stall_timeout_s: Optional[float] = None,
                 fused_step: bool = True,
                 tracer=None, timeline_steps: int = 256,
                 page_ledger: bool = True,
                 ledger_events: int = 1024,
                 prefix_cache=None, prefill_retry=None, speculative=None,
                 mesh=None, prefill_chunk_tokens: Optional[int] = None,
                 multi_step: int = 1, forecast_admission: bool = False,
                 weight_generation: int = 0):
        for name, val, off in (
                ("speculative", speculative, None),
                ("mesh", mesh, None),
                ("prefill_chunk_tokens", prefill_chunk_tokens, None),
                ("multi_step>1", multi_step, 1),
                ("forecast_admission", forecast_admission, False),
                ("weight hot-swap (weight_generation)", weight_generation,
                 0)):
            if val != off:
                raise _not_ported(name)
        self.model = model
        model.eval()
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
        self.decode_ema_s: Optional[float] = None
        self.fused_step = bool(fused_step)
        self._tracer = tracer
        self.timeline: "collections.deque" = collections.deque(
            maxlen=max(1, int(timeline_steps)))
        # launches of each step program by kind ("prefill", "decode")
        self.programs_launched: Dict[str, int] = {}
        self._tl_ms: Dict[str, float] = {}

    # -- request lifecycle -------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               eos_token: Optional[int] = None, priority: int = 1,
               on_token: Optional[Callable[[int, int, bool], None]] = None,
               deadline_t: Optional[float] = None,
               trace=None, trace_ctx: Optional[Dict] = None) -> int:
        """Queue a request; returns its id. ``trace``: an existing
        RequestTrace to continue (the server's resurrection replay
        resubmits an in-flight request onto its tree); ``trace_ctx``: an
        upstream trace context that forces sampling."""
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
                                        else float(deadline_t)))
        req.stats.submit_t = time.monotonic()
        req.stats.prompt_len = len(prompt)
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
        None when fusion is off."""
        return self.model.head_params() if self.fused_step else None

    def _sample(self, hidden_or_logits, hp) -> torch.Tensor:
        from ..nn.decode import fused_sample_token, sample_token
        if hp is None:
            return sample_token(hidden_or_logits, 0.0)
        w, ty, bias = hp
        return fused_sample_token(hidden_or_logits.contiguous(), w, 0.0,
                                  transpose_y=ty, bias=bias)

    def _run_prefill(self, row: np.ndarray, ids: np.ndarray, plen: int,
                     cached_len: int = 0) -> int:
        """One slot prefill of the bucket-padded ``ids`` [1, bucket]
        holding ``plen`` real tokens; writes their KV into the slot's
        pages and returns the first generated token. ``cached_len`` > 0
        is the chained prefill (``gpt.py:798-874``): the slot already
        holds that many tokens in shared prefix pages, the suffix's
        positions start there and it attends the stored prefix through
        the paged reference, writing only past ``cached_len``."""
        dev = self.device
        table = torch.from_numpy(row[None]).to(dev)
        lens = torch.tensor([cached_len], dtype=torch.int32, device=dev)
        plen_t = torch.tensor([plen], dtype=torch.int32, device=dev)
        ids_t = torch.from_numpy(ids).to(dev)
        chained = cached_len > 0
        hp = self._fused_head()
        with torch.no_grad():
            caches = self._caches(table, lens)
            if hp is not None:
                hidden, _ = self.model.decode_hidden(
                    ids_t, caches, prefill_lens=plen_t,
                    prefill_chained=chained, fused=True)
                nxt = self._sample(hidden[:1, plen - 1], hp)
            else:
                logits, _ = self.model.forward(
                    ids_t, caches=caches, prefill_lens=plen_t,
                    prefill_chained=chained)
                nxt = self._sample(logits[:1, plen - 1], None)
        return int(nxt[0].item())

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
        self._tl_ms["splice_ms"] = (self._tl_ms.get("splice_ms", 0.0)
                                    + (time.monotonic() - t0) * 1e3)

    def _run_decode(self, table: np.ndarray, lens: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """One single-token decode step for every slot: returns (next
        tokens, new lengths) on the host."""
        dev = self.device
        table_t = torch.from_numpy(table).to(dev)
        lens_t = torch.from_numpy(lens).to(dev)
        cur = torch.from_numpy(self._cur).to(dev)[:, None]
        hp = self._fused_head()
        with torch.no_grad():
            caches = self._caches(table_t, lens_t)
            if hp is not None:
                hidden, nc = self.model.decode_hidden(cur, caches,
                                                      fused=True)
                nxt = self._sample(hidden[:, -1], hp)
            else:
                logits, nc = self.model.forward(cur, caches=caches)
                nxt = self._sample(logits[:, -1], None)
        return nxt.cpu().numpy(), nc[0].seq_lens.cpu().numpy()

    def _launched(self, kind: str) -> None:
        self.programs_launched[kind] = \
            self.programs_launched.get(kind, 0) + 1

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
            "slots_active": self.num_active,
            "queued": len(self._queue),
            "free_pages": self.allocator.free_count,
        }
        for k, v in self._tl_ms.items():
            entry[k] = round(v, 4)
        self.timeline.append(entry)

    # -- scheduler ---------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        return self.prompt_buckets[-1]

    def _fits(self, req: DecodeRequest) -> bool:
        """Could ``req`` be admitted now? Free pages plus what the prefix
        cache could evict, excluding the entries the request's own match
        would pin (``continuous_batching.py:1956-1992``); ``match``
        memoizes the chain hashes on the request."""
        need = -(-(len(req.prompt) + req.max_new_tokens) // self.page_size)
        avail = self.allocator.free_count
        if self._prefix_cache is not None:
            keys, shared = self._prefix_cache.match(req.prompt, memo=req)
            need -= len(shared)
            avail += self._prefix_cache.evictable_pages(excluding=keys)
        return need <= avail

    def _select_next(self) -> Optional[DecodeRequest]:
        if not self._queue:
            return None
        if self._scheduler is not None:
            idx = self._scheduler.select(self._queue, self._fits,
                                         time.monotonic())
            return self._queue.pop(idx) if idx is not None else None
        # built-in FIFO: head or nothing (don't starve the head)
        if self._fits(self._queue[0]):
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
        already expired, or its best-case remaining decode steps at the
        observed step time overshoot it. The JAX gate charges the prefix
        cache's hit only to the prefill chunks of chunked mode, which is
        not ported, so no cache term applies here."""
        if req.deadline_t is None:
            return False
        if now >= req.deadline_t:
            return True
        if self.decode_ema_s is not None:
            need = 1 if req.eos_token is not None else req.max_new_tokens
            return now + need * self.decode_ema_s > req.deadline_t
        return False

    def expire_deadlines(self, now: Optional[float] = None
                         ) -> List[DecodeRequest]:
        """Terminate everything past its deadline ("deadline" state):
        queued requests before prefill, active slots mid-flight."""
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
        ("stalled" state); no-op with the watchdog off."""
        if self.stall_timeout_s is None:
            return []
        now = time.monotonic() if now is None else now
        out: List[DecodeRequest] = []
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            last = max(req.last_emit_t, req.stats.admit_t)
            if now - last > self.stall_timeout_s:
                out.append(self._evict_slot(slot, "stalled"))
        return out

    def dump_inflight(self) -> List[DecodeRequest]:
        """Every request the engine still owes an answer (active slots
        and the wait queue) in submission order: the resurrection input.
        Each one's prompt plus emitted tokens rebuilds its KV on a fresh
        engine by one prefill. Releases nothing; close() tears down."""
        live = [r for r in self._slots if r is not None]
        return sorted(live + list(self._queue), key=lambda r: r.req_id)

    def _admit(self) -> None:
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
        """Free a failed prefill's pages and requeue it at the head, or
        fail it typed after ``max_prefill_attempts``."""
        with self._led("prefill_unwind", req.req_id):
            self.allocator.free(req.req_id)
            self._release_cache_keys(req)
        self._park(slot)
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
                    tr.end(rsp, pages=len(rkeys),
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
        cached_len = len(shared) * self.page_size
        need = -(-(len(req.prompt) + req.max_new_tokens) // self.page_size)
        private_need = need - len(shared)
        try:
            with self._led("admit", req.req_id):
                pages = self.allocator.alloc(req.req_id, private_need)
                if pages is None and cache is not None and \
                        cache.evict_until(self.allocator, private_need):
                    pages = self.allocator.alloc(req.req_id, private_need)
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
        row = np.full((self.max_pages,), self._scratch, np.int32)
        row[:len(shared)] = shared
        row[len(shared):len(shared) + len(pages)] = pages
        self._table[slot] = row
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
        self._launched("prefill_chained" if chained else "prefill")
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

    def _finish_due(self, req: DecodeRequest) -> bool:
        hit_eos = (req.eos_token is not None and req.generated and
                   req.generated[-1] == req.eos_token)
        return len(req.generated) >= req.max_new_tokens or hit_eos

    def _maybe_finish(self, slot: int) -> None:
        req = self._slots[slot]
        if req is not None and self._finish_due(req):
            self._finish_slot(slot)

    def _finish_slot(self, slot: int) -> None:
        """Terminal "done" teardown: free pages, park on scratch."""
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
        self._notify_complete(req)

    # -- stepping ----------------------------------------------------------

    def step(self) -> int:
        """Expire deadlines and stalls, admit what fits (prefilling each
        admission), run ONE decode step for every decoding slot, finish
        what is done. Returns the number of still-active slots. The
        ``engine.step`` fault site fires first, before admission and any
        launch, so an injected failure leaves host and device state as
        the previous step left them (what the server's replay needs)."""
        fault_point("engine.step")
        self._tl_ms = {}
        if self.ledger is not None:
            self.ledger.step = self.steps
        t_step = time.monotonic()
        try:
            self.expire_deadlines()
            self.evict_stalled()
            self._admit()
            if self.num_active == 0:
                return 0
            t0 = time.monotonic()
            n = self._decode_step()
            # the first decode step is warm-up dominated; it would
            # poison the deadline gate's estimate
            if self.steps > 1:
                dt = time.monotonic() - t0
                self.decode_ema_s = dt if self.decode_ema_s is None \
                    else 0.8 * self.decode_ema_s + 0.2 * dt
            return n
        finally:
            self._tl_commit(t_step)

    def _decode_step(self) -> int:
        t0 = time.monotonic()
        nxt, lens_new = self._run_decode(self._table, self._lens)
        t1 = time.monotonic()
        self._launched("decode")
        self._tl_ms["decode_ms"] = (t1 - t0) * 1e3
        self.steps += 1
        decoding = np.array([r is not None and r.state == "decoding"
                             for r in self._slots])
        # empty slots wrote to the scratch page; keep their host length
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
        and assert nothing leaked."""
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
        reference each other). The engine cannot step afterwards."""
        if getattr(self._prefix_cache, "tiers", None):
            self._prefix_cache.attach_device_io(None, None)
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
