"""Threaded socket front-end over the continuous-batching engine (port
of ``paddle_tpu/serving/server.py``).

Newline-JSON protocol (one JSON object per line, both directions):

    -> {"op": "generate", "prompt": [1, 2, 3], "max_new_tokens": 8,
        "priority": "interactive", "stream": true, "eos": 7,
        "deadline_ms": 5000}
    <- {"rid": 0, "token": 17, "done": false}          # per token (stream)
    <- {"rid": 0, "done": true, "tokens": [...], "stats": {...}}
    -> {"op": "health"}
    <- {"status": "ok", "active": 1, "queued": 0, "free_pages": 9, ...}
    -> {"op": "stats"}       # metrics snapshot (JSON)
    -> {"op": "metrics"}     # Prometheus text page (in "text")
    -> {"op": "drain"}       # stop admitting, finish in-flight
    -> {"op": "leak_check"}  # engine-thread page-accounting audit
    -> {"op": "export"}      # structured metrics (counters, buckets)
    -> {"op": "slo", "ttft_ms": 50, "tpot_ms": 10}   # retarget / read
    -> {"op": "trace", "n": 8}    # span trees, events, step timeline,
                                  # per-token timeline, program costs
    -> {"op": "capacity", "ledger_tail": 32}  # occupancy + forecast
    -> {"op": "profile", "ms": 300, "dir": "/path"}  # memory + capture
    -> {"op": "swap", "checkpoint": "/ckpt/dir", "generation": 1}
    -> {"op": "fetch_pages", "keys": [hex...], "heads": [hex...],
        "cursor": 0}         # a peer's chain-page blobs (base64)
    -> {"op": "prefetch", "host": h, "port": p, "heads": [hex...]}
                             # pull a peer's chains into the tiers

Typed failures are structured replies, never hangs: ``ServerOverloaded``
(queue past the SLO scheduler's bounds), ``ServerDraining`` (a drained
server rejects new generates), ``DeadlineExceeded`` (``deadline_ms``
elapsed before completion), ``BadRequest`` (malformed input),
``TransientServerError`` (the ``serving.request`` fault site; retryable),
``PrefillFailed``, ``RequestStalled``, ``ServerEvicted``, ``ReplayFailed``
and ``EngineFailed``.

The prefix cache is on by default, as in the JAX server
(``--no-prefix-cache`` turns it off; greedy outputs are the same):
requests sharing a prompt prefix share its full KV pages and prefill
only the suffix. ``--spill-mb`` / ``--spill-dir`` add host-RAM and disk
tiers that keep evicted prefix pages as crc-checked blobs and restore
them on a later hit; ``--blob-format`` picks their codec. With the cache
on, a full page that a sibling with the same prompt inserted first is
folded onto the resident copy (``dedup``, on by default; ``--no-dedup``
keeps the private copy).

Chunked prefill: ``--prefill-chunk 256`` admits long prompts without
stalling in-flight streams: each engine step prefills at most one
page-aligned 256-token chunk of one admitted prompt before the decode
step (greedy outputs equal whole prefill's; ``prefill_debt_tokens`` in
health and the gauges tracks the outstanding prefill).

Speculative decoding: ``--speculate 4`` (the n-gram prompt-lookup
draft) or ``--speculate 4 --draft-model gpt_125m`` (a model drafts over
a ``--draft-window`` context): a draft's k guesses are verified in one
multi-token forward, greedy outputs equal the vanilla engine's, and the
per-request acceptance rate and tokens a step land in the replies'
stats and the metrics.

Multi-step decode: ``--multi-step 8`` runs 8 decode iterations a
launch (on the card one CUDA graph of the decode iteration, replayed 8
times) and reads the tokens back once a launch; greedy outputs are the
same. Chunked prefill and n-gram speculation then run inside the
launch. Health and stats report ``multi_step`` and ``macro_launches``;
the metrics count ``serving_macro_steps_total`` and observe iterations
a launch (``serving_steps_per_launch``) and the host's wait at each
drain (``serving_host_overlap_idle_ms``).

Engine resurrection: after ``max_engine_errors`` consecutive step
failures the server tears the engine down (pages returned and audited),
rebuilds it from the captured recipe (a fresh prefix cache with it) and
replays every in-flight request as its prompt plus the tokens it already
emitted, one prefill; greedy continuations equal the uninterrupted run
(on the CPU bit for bit), so a client sees a pause. The reply reads as
one generation (``stats.replayed``). Only after ``max_engine_restarts``
resurrections does the server fail typed (``EngineFailed``).

Fault sites (``distributed/fault_inject.py``): ``serving.request`` in
the connection thread per generate, ``net.recv`` per received line (the
connection is torn down), ``engine.step``, ``serving.prefill`` and
``serving.verify`` (each retried by its site policy) and ``alloc.page``
in the engine, ``cache.spill`` in the prefix cache.

Observability (``server.py:1312-1397``): ``export`` is the metrics'
structured export; ``slo`` sets the TTFT / TPOT targets (an absent key
keeps its target, an explicit null clears it) and reads them back with
the attainment; ``trace`` returns the finished span trees (``n``, or
``drain`` to consume them; ``format: "chrome"`` for a chrome trace), the
tracer's events, the step timeline, the per-token timeline and each
program kind's flops and bytes (``program_costs``); ``capacity`` is the
engine's occupancy card with an exhaustion forecast over the timeline
and, on request, the page ledger's tail; ``profile`` reports each
card's ``torch.cuda.memory_stats`` (on the CPU ``memory_stats: null``
and ``chip_pending: true``) and with ``{"ms": N}`` runs a
``torch.profiler`` capture window of CPU and CUDA activity, opened and
closed on the engine thread between its steps while it keeps serving,
written as a chrome trace ``<dir>/profile-<pid>-<n>.trace.json`` that
``tools/merge_traces.py`` merges with span dumps (one capture at a
time: ``ProfileBusy``).

Weight hot-swap: ``swap`` loads and crc-validates the newest valid
checkpoint under ``checkpoint`` (a ``ResilientCheckpointManager``
directory) on the connection thread, then the engine thread pauses
admission, waits for the active slots to drain (``timeout_s``, default
120) and applies it between steps (``swap_weights``); queued requests
wait, none is dropped. A torn or corrupt checkpoint, a mismatched state
or an undrained engine is a typed ``SwapFailed`` with the old weights
serving. ``--checkpoint DIR`` boots from the newest valid checkpoint
(a missing or corrupt one fails startup) and ``--weight-generation N``
names the generation served; the generation salts the prefix cache's
chain keys and rides the resurrection recipe.

``--forecast-admission`` charges the forecast page burn at admission;
``--no-page-ledger`` turns the page ledger off.

Disaggregated roles: ``--role prefill`` serves ``prefill_only``
generates (the reply is an ack naming the chain keys), parks the
finished chain in its cache and tiers, advertises the heads in health's
``prefix_keys`` and serves the pages over ``fetch_pages`` (at most
``FETCH_PAGES_CAP`` = 512 a reply, ``next_cursor`` pages through the
rest); a plain generate gets a typed ``WrongRole``. ``--role decode``
takes a router's ``"fetch_from": {"host", "port", "generation"}`` hint
on a generate: the connection thread pulls the prompt's chain from the
peer (``--handoff-timeout-s``), the engine thread imports the blobs into
the tiers (each crc checked again) and admission splices them instead of
prefilling; greedy outputs equal the local path's. Any fetch failure is
a counted fallback to the local prefill (``handoff_failures_total``); a
hint of another weight generation is skipped and counted
(``cross_generation_skips_total``). ``prefetch`` pulls a peer's chains
into this replica's tiers (the receiving side of a drain handoff).
``--role mixed`` (the default) is the single server.

``--flight-dir DIR`` (``--flight-budget-mb``, default 64) writes a
black-box bundle on a resurrection, a terminal failure, a stall or a
failed swap; ``tools/flight_inspect.py`` lints it.

Not yet ported: ``--mesh`` (answered as the JAX server answers an
unknown flag).

Threading: the ENGINE THREAD exclusively owns the engine and every CUDA
launch (it sets the CUDA device first); connection threads parse
requests and hand them over through an inbox queue, and per-token
streaming flows back through per-request outbox queues.

Run it: ``python -m paddle_tpu_torch.serving.server --model gpt_1p3b``
(CUDA by default; ``--device cpu`` runs the plain versions on the CPU).
"""

from __future__ import annotations

import json
import os
import queue as queue_mod
import socket
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import module_device, resolve_device
from ..distributed.fault_inject import InjectedFault, fault_point
from ..distributed.resilience import (ResilientCheckpointManager,
                                      RetryExhausted, get_retry_policy)
from ..inference.continuous_batching import SwapFailed
from .fleet_metrics import FlightRecorder
from .metrics import ServingMetrics, SLOAttainment
from .prefix_cache import PrefixCache
from .scheduler import Priority, ServerOverloaded, SLOScheduler
from .tracing import SpanTracer, stderr_span_sink

__all__ = ["ServingServer", "client_request", "fetch_page_blobs",
           "PageFetchFailed"]

_PRIORITIES = {"batch": Priority.BATCH, "normal": Priority.NORMAL,
               "interactive": Priority.INTERACTIVE}

_ROLES = ("mixed", "prefill", "decode")


class PageFetchFailed(ConnectionError):
    """A cross-replica page fetch (the ``fetch_pages`` op) delivered no
    usable blobs: the peer is dead, the transport tore, the peer replied
    with a typed error or a malformed payload. Always recoverable: the
    caller falls back to a local (chained) prefill, the socket timeout
    bounds the wait and ``handoff_failures_total`` counts it."""


def _hexes(ks) -> List[str]:
    return [k.hex() if isinstance(k, bytes) else str(k) for k in ks]


def fetch_page_blobs(host: str, port: int, keys=None, heads=None,
                     timeout_s: float = 30.0):
    """Client side of the ``fetch_pages`` op: pull chain-page blobs from
    a peer replica. ``keys`` are exact chain keys (bytes or hex);
    ``heads`` are chain heads the peer expands to whole chains. Returns
    ``(blobs: {key_bytes: blob_bytes}, missing_hex, bytes_total)``;
    raises :class:`PageFetchFailed` on any transport or protocol
    failure. Blob crcs are checked by the importer
    (``PrefixCache.import_blobs``), not here.

    A chain longer than the peer's ``FETCH_PAGES_CAP`` pages through the
    reply's ``next_cursor``: the client pulls bounded windows, each its
    own timeout-bounded call, until the peer returns no next cursor (at
    most 256 rounds, so a peer echoing a cursor cannot spin it)."""
    import base64

    base: Dict[str, Any] = {"op": "fetch_pages"}
    if keys:
        base["keys"] = _hexes(keys)
    if heads:
        base["heads"] = _hexes(heads)
    blobs: Dict[bytes, bytes] = {}
    missing: List[str] = []
    total = 0
    cursor = 0
    for _round in range(256):
        payload = dict(base)
        if cursor:
            payload["cursor"] = cursor
        try:
            reply = client_request(host, int(port), payload,
                                   timeout_s=timeout_s)
        except Exception as e:
            raise PageFetchFailed(f"{type(e).__name__}: {e}")
        if not isinstance(reply, dict) or reply.get("error"):
            raise PageFetchFailed(
                f"{reply.get('error')}: {reply.get('reason')}"
                if isinstance(reply, dict) else "non-object reply")
        try:
            for khex, b64 in (reply.get("blobs") or {}).items():
                blob = base64.b64decode(b64)
                blobs[bytes.fromhex(khex)] = blob
                total += len(blob)
        except Exception as e:
            raise PageFetchFailed(f"malformed blob payload: "
                                  f"{type(e).__name__}: {e}")
        missing.extend(reply.get("missing") or ())
        nxt = reply.get("next_cursor")
        if not isinstance(nxt, int) or nxt <= cursor:
            break
        cursor = nxt
    return blobs, missing, total


class _Pending:
    """Engine-side record of one in-flight client request."""

    __slots__ = ("outbox", "stream")

    def __init__(self, stream: bool):
        self.outbox: "queue_mod.Queue[Optional[Dict]]" = queue_mod.Queue()
        self.stream = stream


class ServingServer:
    """In-process serving front-end (tests construct it directly; the
    CLI entry below wraps it). ``engine_kwargs`` pass through to
    ``create_decode_engine`` (num_slots, page_size, num_pages, ...);
    ``scheduler=None`` defaults to an ``SLOScheduler``.
    ``prefix_cache=True`` builds a ``PrefixCache`` of the engine's page
    size (with the ``spill_*`` tiers, ``blob_format`` and ``dedup``)
    with every engine; ``prefill_retry="site"`` resolves the
    ``serving.prefill`` site policy. ``speculative`` and
    ``prefill_chunk_tokens`` and ``multi_step`` ride in
    ``engine_kwargs``, so a resurrection rebuilds a speculative,
    chunked or multi-step engine. ``checkpoint``: boot from the newest
    valid checkpoint under that directory; ``weight_generation``: the
    generation served (the current one rides the resurrection recipe).
    The model must live on ``device`` (CUDA unless named)."""

    def __init__(self, model, host: str = "127.0.0.1", port: int = 0,
                 scheduler=None, prefix_cache: bool = True,
                 metrics: Optional[ServingMetrics] = None,
                 prefill_retry="site", max_new_tokens_cap: int = 512,
                 poll_interval_s: float = 0.02,
                 max_engine_errors: int = 32,
                 max_engine_restarts: int = 2,
                 spill_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 spill_disk_bytes: Optional[int] = None,
                 trace_sample: float = 0.0, trace_max: int = 64,
                 tracer: Optional[SpanTracer] = None,
                 slo_ttft_ms: Optional[float] = None,
                 slo_tpot_ms: Optional[float] = None,
                 slo_window_s: float = 120.0,
                 flight_dir: Optional[str] = None,
                 flight_budget_bytes: int = 64 << 20,
                 role: str = "mixed",
                 handoff_timeout_s: float = 30.0,
                 blob_format: str = "raw",
                 dedup: bool = True,
                 checkpoint: Optional[str] = None,
                 weight_generation: int = 0,
                 device=None, **engine_kwargs):
        # "mixed" is the single server. "prefill" admits and prefills
        # only (plain generates get a typed WrongRole) and parks finished
        # chains in its cache and tiers for peers to fetch; "decode"
        # serves streams and pulls advertised chains over fetch_pages
        # instead of prefilling again. Both need a spill tier (the
        # parking lot and the wire's landing zone): one is defaulted
        if role not in _ROLES:
            raise ValueError(f"role must be one of {_ROLES}; got "
                             f"{role!r}")
        self.role = role
        self.handoff_timeout_s = float(handoff_timeout_s)
        if role != "mixed" and prefix_cache and spill_bytes is None \
                and spill_dir is None:
            spill_bytes = 64 << 20
        self.device = resolve_device(device)
        if tracer is not None:
            self.tracer = tracer
        else:
            rate, sink = float(trace_sample), None
            if os.environ.get("PT_SERVING_DEBUG"):
                rate, sink = 1.0, stderr_span_sink
            self.tracer = SpanTracer(sample_rate=rate,
                                     max_traces=int(trace_max),
                                     on_span=sink)
        self.host = host
        self._requested_port = port
        self.scheduler = scheduler if scheduler is not None \
            else SLOScheduler()
        if metrics is not None:
            # the caller owns the SLO monitor (its window included); the
            # targets given here overlay it one by one, keeping a target
            # already set there (``server.py:334-345``)
            self.metrics = metrics
            if slo_ttft_ms is not None or slo_tpot_ms is not None:
                slo = metrics.slo
                slo.set_targets(
                    slo_ttft_ms if slo_ttft_ms is not None
                    else slo.ttft_ms,
                    slo_tpot_ms if slo_tpot_ms is not None
                    else slo.tpot_ms)
        else:
            self.metrics = ServingMetrics(
                slo=SLOAttainment(ttft_ms=slo_ttft_ms, tpot_ms=slo_tpot_ms,
                                  window_s=slo_window_s))
        # crash flight recorder: black-box bundles on resurrection, a
        # terminal failure, a stall and a failed swap
        self.flight = (FlightRecorder(flight_dir,
                                      budget_bytes=flight_budget_bytes)
                       if flight_dir else None)
        # the resurrection recipe, captured once: a rebuild constructs an
        # equivalent engine (fresh allocator, pools and prefix cache)
        self._use_prefix_cache = bool(prefix_cache)
        self._spill_bytes = spill_bytes
        self._spill_dir = spill_dir
        self._spill_disk_bytes = spill_disk_bytes
        self._blob_format = str(blob_format)
        self._dedup = bool(dedup)
        self._page_size = int(engine_kwargs.get("page_size", 64))
        if prefill_retry == "site":
            prefill_retry = get_retry_policy("serving.prefill")
        self._model = model
        self._prefill_retry = prefill_retry
        self._engine_kwargs = dict(engine_kwargs)
        pb = self._engine_kwargs.get("prompt_buckets")
        if pb:
            # a replay prefills prompt + emitted tokens at once, so every
            # length up to max_seq_len must have a bucket
            msl = int(self._engine_kwargs.get("max_seq_len")
                      or model.config.max_seq_len)
            self._engine_kwargs["prompt_buckets"] = sorted(
                set(int(x) for x in pb) | {msl})
        # the generation served is part of the resurrection recipe: a
        # rebuilt engine and its cache come back salted to it. A boot
        # checkpoint is copied into the model before the engine is
        # built; a missing or corrupt one fails construction
        self._weight_generation = int(weight_generation)
        if checkpoint:
            _step, state = self._load_checkpoint_state(checkpoint)
            from ..nn.layer import load_jax_state
            try:
                load_jax_state(model, state)
            except KeyError as e:
                raise ValueError(f"boot checkpoint {checkpoint!r} does "
                                 f"not match the model: {e}") from None
        self.prefix_cache: Optional[PrefixCache] = None
        self.engine = self._build_engine()
        self.max_new_tokens_cap = int(max_new_tokens_cap)
        self.poll_interval_s = float(poll_interval_s)
        self.max_engine_errors = int(max_engine_errors)
        self.max_engine_restarts = int(max_engine_restarts)
        self._consec_errors = 0
        self._restarts = 0
        self._failed = False
        # replay ledger: new req_id -> (original prompt, tokens delivered
        # before the crash, the original request's stats); _on_complete
        # stitches the reply and the telemetry back together
        self._replay: Dict[int, tuple] = {}
        self.metrics.set_gauge_fn(self._gauges)
        # a parked weight swap (engine thread): (payload, _Pending, drain
        # deadline); while set the engine admits nothing
        self._swap_pending: Optional[tuple] = None
        # one profiler capture at a time; the open window (engine thread)
        self._profile_lock = threading.Lock()
        self._profiles = 0
        self._capture: Optional[tuple] = None
        self._inbox: "queue_mod.Queue[tuple]" = queue_mod.Queue()
        self._admission_lock = threading.Lock()
        self._pending: Dict[int, _Pending] = {}  # engine thread only
        self._wake = threading.Event()
        self._engine_done = threading.Event()
        self._draining = False
        self._stopping = False
        self._started = False
        self._listen_sock: Optional[socket.socket] = None
        self._threads = []
        self._conn_threads = []
        self._conns = []
        self._conns_lock = threading.Lock()
        self._t0 = time.monotonic()
        # scrape markers (``server.py:449-457``): (restart count, last
        # timeline step observed) and (restart count, engine macro
        # launches already counted); a resurrected engine starts both
        # afresh, so neither histogram nor counter winds back
        self._tl_seen: tuple = (None, -1)
        self._macro_seen: tuple = (None, 0)
        self.port: Optional[int] = None

    def _build_engine(self):
        """(Re)build the decode engine from the captured recipe, with a
        fresh prefix cache: a cache's books name pages of its engine's
        allocator, so it never outlives that engine."""
        from ..inference import create_decode_engine
        self.prefix_cache = (
            PrefixCache(self._page_size,
                        spill_bytes=self._spill_bytes,
                        spill_dir=self._spill_dir,
                        disk_bytes=self._spill_disk_bytes,
                        blob_format=self._blob_format,
                        dedup=self._dedup,
                        generation=self._weight_generation)
            if self._use_prefix_cache else None)
        return create_decode_engine(
            self._model, device=self.device, scheduler=self.scheduler,
            prefix_cache=self.prefix_cache,
            prefill_retry=self._prefill_retry,
            weight_generation=self._weight_generation,
            on_complete=self._on_complete,
            # the SAME tracer across resurrections: a replayed request's
            # spans land on its original tree. A served engine counts
            # its program costs: the gauges and the trace op read them
            tracer=self.tracer, capture_costs=True, **self._engine_kwargs)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> int:
        """Bind, listen, start the accept and engine threads; returns
        the bound port."""
        if self._started:
            return self.port
        self._listen_sock = socket.socket(socket.AF_INET,
                                          socket.SOCK_STREAM)
        self._listen_sock.setsockopt(socket.SOL_SOCKET,
                                     socket.SO_REUSEADDR, 1)
        self._listen_sock.bind((self.host, self._requested_port))
        self._listen_sock.listen(64)
        self.port = self._listen_sock.getsockname()[1]
        self._started = True
        for name, fn in (("engine", self._engine_loop),
                         ("accept", self._accept_loop)):
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"pt-serving-{name}")
            t.start()
            self._threads.append(t)
        return self.port

    def drain(self) -> None:
        """Stop admitting new requests; queued and in-flight work
        finishes normally."""
        self._draining = True
        self._wake.set()

    def stop(self, timeout_s: float = 60.0) -> None:
        """Graceful shutdown: drain, finish in-flight, return pages
        (``engine.close()`` asserts no leak), close sockets."""
        self._draining = True
        self._stopping = True
        self._wake.set()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=timeout_s)
        if self._listen_sock is not None:
            try:
                self._listen_sock.close()
            except OSError:
                pass
        with self._conns_lock:
            conns = list(self._conns)
            threads = list(self._conn_threads)
        # let conn threads flush their final replies before the sockets
        # are torn down
        flush_deadline = time.monotonic() + 5.0
        for t in threads:
            t.join(timeout=max(0.0, flush_deadline - time.monotonic()))
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for t in threads:
            t.join(timeout=5.0)

    def __enter__(self) -> "ServingServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- engine thread -----------------------------------------------------

    def _engine_loop(self) -> None:
        """Engine-thread entry: whatever escapes the loop becomes a
        typed EngineFailed broadcast, never a silently dead thread."""
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self._engine_loop_inner()
        except Exception:
            try:
                self._fail_engine()
            finally:
                self._engine_done.set()
        finally:
            # a capture window left open would keep tracing
            self._maybe_stop_capture(force=True)

    def _engine_loop_inner(self) -> None:
        while True:
            # re-read self.engine every turn: resurrection replaces it
            eng = self.engine
            self._drain_inbox()
            self._maybe_stop_capture()
            self._maybe_apply_swap(eng)
            if (eng.num_queued or eng.num_active) and not self._failed:
                failed = resurrect = False
                try:
                    before = eng.num_queued + eng.num_active
                    eng.step()
                    after = eng.num_queued + eng.num_active
                    self._consec_errors = 0
                    if after and after == before and not eng.num_active:
                        # queued but nothing admissible: don't hot-spin
                        time.sleep(self.poll_interval_s)
                except Exception:
                    # a failed prefill already unwound inside the engine;
                    # a PERSISTENT step failure resurrects the engine
                    # past max_engine_errors, and fails the server typed
                    # once the restarts are spent too
                    self.metrics.counter("engine_errors_total").add()
                    failed = True
                    self._consec_errors += 1
                    # a failing step never reaches its own sweeps
                    try:
                        eng.expire_deadlines()
                        eng.evict_stalled()
                    except Exception:
                        pass
                    if self._consec_errors >= self.max_engine_errors:
                        if self._restarts < self.max_engine_restarts:
                            resurrect = True
                        else:
                            self._fail_engine()
                # rebuild outside the handler: its traceback holds the
                # failed step's frames, and with them the dead pools
                if resurrect:
                    try:
                        self._resurrect_engine()
                    except Exception:
                        # the rebuild failed too (a sticky CUDA error
                        # poisons every later launch): terminal and typed
                        self.metrics.counter(
                            "engine_resurrect_failures_total").add()
                        self._fail_engine()
                if failed:
                    time.sleep(self.poll_interval_s)
                continue
            if self._stopping and self._inbox.empty():
                self._maybe_stop_capture(force=True)
                self._resolve_swap_pending(
                    {"error": "ServerEvicted",
                     "reason": "server shutting down"})
                try:
                    eng.close()
                finally:
                    for p in self._pending.values():
                        p.outbox.put(None)
                    self._pending.clear()
                    self._engine_done.set()
                return
            self._wake.wait(timeout=self.poll_interval_s)
            self._wake.clear()

    def _flight_record(self, reason: str, inflight=None,
                       **extra) -> None:
        """Crash flight recorder (engine thread): assemble and write one
        black-box bundle atomically, from bounded structures only (the
        timeline ring, the finished-trace ring, the in-flight dump).
        Never raises: a postmortem must not cause the next incident."""
        if self.flight is None:
            return
        eng = self.engine

        def collect() -> Dict:
            reqs = (inflight if inflight is not None
                    else eng.dump_inflight())
            return {
                # v2 bundles carry the page-ledger tail and a capacity
                # snapshot; tools/flight_inspect.py requires both
                "v": 2,
                "page_ledger": getattr(eng, "ledger_tail",
                                       lambda n: [])(256),
                "capacity": self._capacity(),
                "model": type(self._model).__name__,
                "weight_generation": self._weight_generation,
                "engine": eng.flight_summary(),
                "recipe": dict(self._engine_kwargs),
                "restarts": self._restarts,
                "consec_errors": self._consec_errors,
                "step_timeline": eng.step_timeline(),
                "traces": self.tracer.finished(),
                "events": self.tracer.events(),
                "metrics": self.metrics.export(),
                "inflight": [{"req_id": int(r.req_id),
                              "state": r.state,
                              "prompt_len": int(len(r.prompt)),
                              "generated": int(len(r.generated)),
                              "priority": int(r.priority)}
                             for r in reqs],
                **extra,
            }

        self.flight.record(reason, collect)

    def _resurrect_engine(self) -> None:
        """Recoverable engine death (engine thread; ``server.py:716-831``):
        snapshot every request the dead engine owes an answer, tear it
        down (pages returned and audited by ``close()``), rebuild it from
        the recipe and replay each request as its prompt plus the tokens
        it already emitted, one prefill, for its remaining tokens.
        Requests still in the inbox go to the new engine as usual."""
        self._restarts += 1
        self.metrics.counter("engine_restarts_total").add()
        old = self.engine
        snapshot = old.dump_inflight()
        # the bundle before teardown: the dying engine's timeline ring
        # and in-flight set are what the postmortem needs
        self._flight_record("resurrect", inflight=snapshot)
        self.tracer.annotate(
            "resurrect",
            rids=[(r.req_id, len(r.prompt), len(r.generated), r.state)
                  for r in snapshot],
            pending=sorted(self._pending), restarts=self._restarts)
        # detach each trace before teardown: close() would finish the
        # tree, and the replay must keep appending to it
        saved_traces: Dict[int, Any] = {}
        for req in snapshot:
            tr = req.trace
            if tr is None:
                continue
            if req.span is not None:
                tr.end(req.span, state="resurrect")
                req.span = None
            tr.event("resurrect_replay", parent=tr.anchor,
                     restarts=self._restarts,
                     pre_tokens=len(req.generated))
            saved_traces[req.req_id] = tr
            req.trace = None
        # teardown evictions are not replies the clients should see
        old.set_on_complete(None)
        try:
            old.close()
        except Exception:
            self.metrics.counter("engine_teardown_leaks_total").add()
        # the new engine's pools must not sit beside the dead one's
        old.release_device()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.engine = self._build_engine()
        if self._swap_pending is not None:
            # a swap was draining when the engine died: keep the gate
            # down, or the replays pin slots against it
            self.engine.pause_admission = True
        for req in snapshot:
            pending = self._pending.pop(req.req_id, None)
            # compose across repeated resurrections: the snapshot's
            # prompt may itself be a replay prompt
            prior = self._replay.pop(req.req_id, None)
            if prior is not None:
                orig_prompt, pre, orig_stats = prior
                pre = list(pre) + [int(t) for t in req.generated]
            else:
                orig_prompt = [int(t) for t in req.prompt]
                pre = [int(t) for t in req.generated]
                orig_stats = req.stats
            replay_prompt = np.concatenate(
                [req.prompt, np.asarray(req.generated, np.int32)])
            remaining = req.max_new_tokens - len(req.generated)
            on_token = None
            if pending is not None and pending.stream:
                def on_token(rid, tok, done, _p=pending):
                    _p.outbox.put({"rid": rid, "token": int(tok),
                                   "done": bool(done)})
            try:
                new_rid = self.engine.submit(
                    replay_prompt, max_new_tokens=remaining,
                    eos_token=req.eos_token, priority=req.priority,
                    deadline_t=req.deadline_t, on_token=on_token,
                    # a handoff-blocking prefill keeps its boost: a
                    # decode replica still waits on the chain
                    handoff=req.handoff,
                    trace=saved_traces.get(req.req_id))
            except Exception as e:
                self.tracer.annotate(
                    "replay_failed", old_rid=req.req_id,
                    error=f"{type(e).__name__}: {e}")
                tr = saved_traces.get(req.req_id)
                if tr is not None:
                    tr.event("complete", parent=tr.anchor,
                             state="replay_failed")
                    self.tracer.finish(tr, state="replay_failed")
                if pending is not None:
                    pending.outbox.put(
                        {"error": "ReplayFailed",
                         "reason": f"{type(e).__name__}: {e}"})
                    pending.outbox.put(None)
                continue
            self.metrics.counter("replayed_requests_total").add()
            self.tracer.annotate("replay", old_rid=req.req_id,
                                 new_rid=new_rid,
                                 pending=pending is not None)
            self._replay[new_rid] = (orig_prompt, pre, orig_stats)
            if pending is not None:
                self._pending[new_rid] = pending
        self._consec_errors = 0
        self._wake.set()

    def _fail_engine(self) -> None:
        """Terminal failure: answer every pending and inboxed request
        with a typed EngineFailed, return the engine's pages, stop
        admitting."""
        self._failed = True
        self._draining = True
        self._flight_record("engine_failed")
        self._resolve_swap_pending(
            {"error": "SwapFailed",
             "reason": "engine failed terminally before the swap "
                       "could apply"})
        err = {"error": "EngineFailed",
               "reason": f"decode engine failed {self._consec_errors} "
                         f"consecutive steps after {self._restarts} "
                         f"restart(s); server stopped admitting"}
        try:
            self.engine.close()
        except Exception:
            pass
        for p in list(self._pending.values()):
            p.outbox.put(dict(err))
            p.outbox.put(None)
        self._pending.clear()
        while True:
            try:
                _payload, p = self._inbox.get_nowait()
            except queue_mod.Empty:
                break
            p.outbox.put(dict(err))
            p.outbox.put(None)

    def _drain_inbox(self) -> None:
        while True:
            try:
                payload, pending = self._inbox.get_nowait()
            except queue_mod.Empty:
                return
            if payload.get("ctl") == "leak_check":
                pending.outbox.put(self._leak_check())
                pending.outbox.put(None)
                continue
            if payload.get("ctl") == "profile":
                self._start_capture(payload, pending)
                continue
            if payload.get("ctl") == "fetch_pages":
                # the serving side of a handoff: pages are read from the
                # pool and tier indexes walked on the engine thread, so
                # neither races a step
                pending.outbox.put(self._serve_fetch_pages(payload))
                pending.outbox.put(None)
                continue
            if payload.get("ctl") == "import_blobs":
                # the receiving side of a prefetch: the connection
                # thread pulled the blobs, the tier puts happen here
                pending.outbox.put(self._import_blobs(payload))
                pending.outbox.put(None)
                continue
            if payload.get("ctl") == "swap":
                # the connection thread loaded and validated the
                # checkpoint; park the apply until the active slots
                # drain (_maybe_apply_swap), admitting nothing meanwhile
                if self._swap_pending is not None:
                    pending.outbox.put(
                        {"error": "SwapFailed",
                         "reason": "another weight swap is already "
                                   "pending on this replica"})
                    pending.outbox.put(None)
                    continue
                self.engine.pause_admission = True
                deadline = time.monotonic() + float(
                    payload.get("timeout_s") or 120.0)
                self._swap_pending = (payload, pending, deadline)
                continue
            if self._failed:
                pending.outbox.put({"error": "EngineFailed",
                                    "reason": "engine step failed "
                                              "repeatedly"})
                pending.outbox.put(None)
                continue

            def on_token(rid, tok, done, _p=pending):
                if _p.stream:
                    _p.outbox.put({"rid": rid, "token": int(tok),
                                   "done": bool(done)})

            # a generate that rode a handoff carries the fetched blobs:
            # import them into the tiers now, so its admission restores
            # them instead of prefilling (corrupt blobs are dropped by
            # the crc check, missing ones fall to the chained prefill)
            handoff_info = None
            ho = payload.pop("_handoff", None)
            if ho is not None:
                pc = self.prefix_cache
                if pc is not None and pc.tiers:
                    rep = pc.import_blobs(ho["blobs"],
                                          heads=ho.get("heads", ()))
                    handoff_info = {"ms": ho["ms"], "bytes": ho["bytes"],
                                    "imported": rep["imported"],
                                    "corrupt": rep["corrupt"]}
                    if rep["corrupt"] and not rep["imported"]:
                        # the handoff delivered nothing: a counted
                        # fallback to the local prefill
                        self.metrics.counter(
                            "handoff_failures_total").add()
            try:
                rid = self.engine.submit(
                    np.asarray(payload["prompt"], np.int32),
                    max_new_tokens=payload["max_new_tokens"],
                    eos_token=payload.get("eos"),
                    priority=payload.get("priority", Priority.NORMAL),
                    deadline_t=payload.get("deadline_t"),
                    on_token=on_token,
                    # a prefill_only job is handoff-blocking (the
                    # scheduler's boost)
                    handoff=bool(payload.get("handoff")),
                    handoff_info=handoff_info,
                    trace_ctx=payload.get("trace_ctx"))
            except Exception as e:
                # one malformed payload costs that client a BadRequest,
                # never the engine thread
                pending.outbox.put({"error": "BadRequest",
                                    "reason": f"{type(e).__name__}: {e}"})
                pending.outbox.put(None)
                continue
            self._pending[rid] = pending

    # -- weight hot-swap ---------------------------------------------------

    def _resolve_swap_pending(self, reply: Dict) -> None:
        """Answer and clear a parked swap with ``reply`` (shutdown or
        terminal failure), so the swapping client never hangs."""
        if self._swap_pending is None:
            return
        _payload, pending, _deadline = self._swap_pending
        self._swap_pending = None
        self.metrics.counter("weight_swaps_failed_total").add()
        pending.outbox.put(dict(reply))
        pending.outbox.put(None)

    def _maybe_apply_swap(self, eng) -> None:
        """Engine-thread gate of a parked swap (``server.py:979-994``):
        once the active slots drain (admission is paused, so they only
        shrink) apply it between steps; past the drain deadline, fail
        it typed with the old weights serving."""
        if self._swap_pending is None:
            return
        payload, pending, deadline = self._swap_pending
        if eng.num_active and time.monotonic() < deadline:
            return  # active slots still finishing on the old weights
        self._swap_pending = None
        reply = self._apply_swap(eng, payload)
        eng.pause_admission = False
        self._wake.set()
        pending.outbox.put(reply)
        pending.outbox.put(None)

    def _apply_swap(self, eng, payload: Dict) -> Dict:
        """Apply a drained, validated swap (engine thread). Any failure
        is a typed SwapFailed reply: the engine refused before touching
        a tensor, so the old generation keeps serving."""
        outcome = ("rolled_back" if payload.get("rollback")
                   else "committed")
        if eng.num_active:
            self.metrics.counter("weight_swaps_failed_total").add()
            return {"error": "SwapFailed",
                    "reason": f"engine did not drain its "
                              f"{eng.num_active} active slot(s) "
                              f"within the swap timeout"}
        try:
            info = eng.swap_weights(payload["state"],
                                    generation=payload.get("generation"))
        except SwapFailed as e:
            self.metrics.counter("weight_swaps_failed_total").add()
            self._flight_record("swap_failed", swap_error=str(e))
            return {"error": "SwapFailed", "reason": str(e)}
        except Exception as e:
            self.metrics.counter("weight_swaps_failed_total").add()
            self._flight_record("swap_failed",
                                swap_error=f"{type(e).__name__}: {e}")
            return {"error": "SwapFailed",
                    "reason": f"{type(e).__name__}: {e}"}
        self._weight_generation = int(info["generation"])
        self.metrics.counter(f"weight_swaps_{outcome}_total").add()
        self.metrics.swap_ms.observe(float(info["swap_ms"]))
        self.tracer.annotate("weight_swap", outcome=outcome,
                             generation=info["generation"],
                             swap_ms=info["swap_ms"],
                             checkpoint_step=payload.get("step"))
        return {"ok": True, "outcome": outcome, **info}

    @staticmethod
    def _load_checkpoint_state(directory: str):
        """Load and crc-validate the newest valid checkpoint under
        ``directory`` on the calling thread (``server.py:1034-1058``):
        the live engine is never touched. The ``checkpoint.load`` site
        fires per attempt and transient faults retry per its policy; a
        directory with no valid checkpoint raises a typed SwapFailed.
        Returns (step, state)."""

        def load_once():
            fault_point("checkpoint.load")
            mgr = ResilientCheckpointManager(directory)
            got = mgr.restore_latest_valid()
            if got is None:
                raise SwapFailed(
                    f"no valid checkpoint under {directory!r} "
                    f"(skipped corrupt/partial steps: "
                    f"{mgr.last_skipped})")
            return got

        policy = get_retry_policy("checkpoint.load")
        return policy.call(load_once, site="checkpoint.load")

    def _swap(self, msg: Dict, send) -> None:
        """The ``swap`` op (connection thread, ``server.py:1060-1114``):
        load and validate the checkpoint before the engine hears of it,
        then hand the host state to the engine thread, which drains the
        active slots and applies it between steps. The reply carries the
        new generation and swap_ms."""
        ckpt = msg.get("checkpoint")
        if not isinstance(ckpt, str) or not ckpt:
            send({"error": "BadRequest",
                  "reason": "swap needs 'checkpoint': a checkpoint-"
                            "manager directory path"})
            return
        gen = msg.get("generation")
        if gen is not None and (isinstance(gen, bool)
                                or not isinstance(gen, int)
                                or gen < 0):
            send({"error": "BadRequest",
                  "reason": "generation must be a non-negative int"})
            return
        timeout_s = msg.get("timeout_s")
        if timeout_s is not None and (
                isinstance(timeout_s, bool)
                or not isinstance(timeout_s, (int, float))
                or timeout_s <= 0):
            send({"error": "BadRequest",
                  "reason": "timeout_s must be a positive number of "
                            "seconds"})
            return
        try:
            step, state = self._load_checkpoint_state(ckpt)
        except (SwapFailed, RetryExhausted) as e:
            self.metrics.counter("weight_swaps_failed_total").add()
            send({"error": "SwapFailed", "reason": str(e)})
            return
        except Exception as e:
            self.metrics.counter("weight_swaps_failed_total").add()
            send({"error": "SwapFailed",
                  "reason": f"{type(e).__name__}: {e}"})
            return
        payload: Dict[str, Any] = {"ctl": "swap", "state": state,
                                   "step": step}
        if gen is not None:
            payload["generation"] = gen
        if msg.get("rollback"):
            payload["rollback"] = True
        if timeout_s is not None:
            payload["timeout_s"] = float(timeout_s)
        pending = _Pending(stream=False)
        self._inbox.put((payload, pending))
        self._wake.set()
        self._await_outbox(pending, send)

    def _on_complete(self, req) -> None:
        """Engine callback: terminal state for a request (any state). A
        replayed request's reply and telemetry are stitched back into
        one generation from the original submit."""
        replay = self._replay.pop(req.req_id, None)
        if replay is not None:
            orig_prompt, pre, orig_stats = replay
            st = req.stats
            st.tokens_out = len(req.generated) + len(pre)
            st.prompt_len = len(orig_prompt)
            st.submit_t = orig_stats.submit_t
            if orig_stats.admit_t:
                st.admit_t = orig_stats.admit_t
            if orig_stats.first_token_t:
                st.first_token_t = orig_stats.first_token_t
            if orig_stats.prefill_ms:
                st.prefill_ms = orig_stats.prefill_ms
        self.metrics.observe_request(req)
        self.engine.result(req.req_id, pop=True)
        pending = self._pending.pop(req.req_id, None)
        if pending is None:
            return
        if req.state == "done":
            tokens = [int(t) for t in req.tokens]
            generated = [int(t) for t in req.generated]
            stats = _json_stats(req.stats)
            if replay is not None:
                # original prompt, then the pre-crash tokens in front of
                # the replayed continuation
                orig_prompt, pre, _orig_stats = replay
                generated = list(pre) + generated
                tokens = list(orig_prompt) + generated
                stats["tokens_out"] = len(generated)
                stats["replayed"] = True
            msg: Dict[str, Any] = {
                "rid": req.req_id, "done": True,
                "tokens": tokens, "generated": generated,
                "stats": stats}
        elif req.state == "deadline":
            msg = {"rid": req.req_id, "error": "DeadlineExceeded",
                   "reason": "deadline_ms elapsed before completion",
                   "tokens_out": int(req.stats.tokens_out)}
            fors = getattr(req, "page_forensics", None)
            if fors:
                msg["page_forensics"] = fors[-8:]
        elif req.state == "stalled":
            # a stall is the third black-box trigger: something below
            # the engine stopped without an error
            fors = getattr(req, "page_forensics", None)
            self._flight_record("stall", stalled_rid=int(req.req_id),
                                page_forensics=fors or [])
            msg = {"rid": req.req_id, "error": "RequestStalled",
                   "reason": f"no token for "
                             f"{self.engine.stall_timeout_s}s; evicted",
                   "tokens_out": int(req.stats.tokens_out)}
            if fors:
                msg["page_forensics"] = fors[-8:]
        elif req.state == "shed":
            cfg = getattr(self.scheduler, "cfg", None)
            msg = {"rid": req.req_id, "error": "ServerOverloaded",
                   "reason": "queued past SLO shed_after_s",
                   "retry_after_ms": getattr(cfg, "retry_after_ms", 1000)}
        elif req.state == "failed":
            msg = {"rid": req.req_id, "error": "PrefillFailed",
                   "attempts": req.stats.prefill_attempts}
        else:  # evicted (drain/close)
            msg = {"rid": req.req_id, "error": "ServerEvicted",
                   "reason": "server shutting down"}
        pending.outbox.put(msg)
        pending.outbox.put(None)

    # -- connection threads ------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                self._listen_sock.settimeout(0.2)
                conn, _addr = self._listen_sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="pt-serving-conn")
            with self._conns_lock:
                self._conns.append(conn)
                self._conn_threads = [x for x in self._conn_threads
                                      if x.is_alive()]
                self._conn_threads.append(t)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        rfile = conn.makefile("r", encoding="utf-8")
        wfile = conn.makefile("w", encoding="utf-8")

        def send(obj: Dict) -> None:
            wfile.write(json.dumps(obj) + "\n")
            wfile.flush()

        try:
            for line in rfile:
                try:
                    # chaos site: a torn receive; the connection dies
                    # like a half-open TCP teardown
                    fault_point("net.recv")
                except InjectedFault:
                    self.metrics.counter("net_recv_drops_total").add()
                    try:
                        conn.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    break
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError as e:
                    send({"error": "BadRequest", "reason": str(e)})
                    continue
                try:
                    self._handle(msg, send)
                except ServerOverloaded as e:
                    self.metrics.counter("rejected_total").add()
                    send({"error": "ServerOverloaded",
                          "reason": e.reason,
                          "retry_after_ms": e.retry_after_ms})
                except Exception as e:  # typed reply, never a hang
                    send({"error": type(e).__name__, "reason": str(e)})
        except (OSError, ValueError):
            pass  # client went away / socket torn down by stop()
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._conns_lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _handle(self, msg: Dict, send) -> None:
        op = msg.get("op", "generate")
        if op == "health":
            send(self._health())
            return
        if op == "stats":
            eng = self.engine
            send({"stats": self.metrics.snapshot(),
                  "prefix_cache": self._cache_stats(),
                  "step_timeline": eng.step_timeline()[-16:],
                  "programs_launched": dict(eng.programs_launched),
                  "multi_step": eng.multi_step,
                  "macro_launches": eng.macro_launches,
                  "step_programs": dict(eng.step_programs),
                  "weight_generation": self._weight_generation,
                  "weight_swaps": eng.weight_swaps})
            return
        if op == "metrics":
            send({"text": self.metrics.prometheus_text()})
            return
        if op == "export":
            send({"export": self.metrics.export()})
            return
        if op == "slo":
            self._slo(msg, send)
            return
        if op == "trace":
            self._trace(msg, send)
            return
        if op == "capacity":
            send(self._capacity(ledger_tail=msg.get("ledger_tail")))
            return
        if op == "profile":
            send(self._profile(msg))
            return
        if op == "swap":
            # allowed while draining: a drained replica is swapped
            self._swap(msg, send)
            return
        if op == "drain":
            self.drain()
            send({"ok": True, "status": "draining"})
            return
        if op == "leak_check":
            # answered on the engine thread so the audit never races a
            # step's allocator mutations
            pending = _Pending(stream=False)
            self._inbox.put(({"ctl": "leak_check"}, pending))
            self._wake.set()
            self._await_outbox(pending, send)
            return
        if op == "fetch_pages":
            # serve chain-page blobs to a peer; keys and heads are hex
            # chain keys, answered on the engine thread
            keys = self._parse_hex_keys(msg.get("keys"))
            heads = self._parse_hex_keys(msg.get("heads"))
            if keys is None or heads is None or not (keys or heads):
                send({"error": "BadRequest",
                      "reason": "fetch_pages needs 'keys' and/or "
                                "'heads' as lists of hex chain keys"})
                return
            try:
                cursor = max(0, int(msg.get("cursor") or 0))
            except (TypeError, ValueError):
                send({"error": "BadRequest",
                      "reason": "fetch_pages cursor must be an int"})
                return
            pending = _Pending(stream=False)
            self._inbox.put(({"ctl": "fetch_pages", "keys": keys,
                              "heads": heads, "cursor": cursor},
                             pending))
            self._wake.set()
            self._await_outbox(pending, send)
            return
        if op == "prefetch":
            # pull a peer's chains into this replica's tiers (the
            # receiving side of a drain handoff): the fetch runs on
            # this connection thread, the import on the engine thread
            self._prefetch(msg, send)
            return
        if op != "generate":
            send({"error": "BadRequest", "reason": f"unknown op {op!r}"})
            return
        if self._draining:
            send({"error": "ServerDraining",
                  "reason": "server is draining; not admitting"})
            return
        try:
            # a transient front-end failure is a retryable typed reply
            fault_point("serving.request")
        except InjectedFault as e:
            send({"error": "TransientServerError", "reason": str(e),
                  "retryable": True})
            return
        prompt = msg.get("prompt")
        if not isinstance(prompt, list) or not prompt:
            send({"error": "BadRequest",
                  "reason": "prompt must be a non-empty token list"})
            return
        prefill_only = bool(msg.get("prefill_only"))
        if self.role == "prefill" and not prefill_only:
            # a prefill replica only prefills; the role-aware router
            # never sends it a decode stream
            send({"error": "WrongRole", "retryable": True,
                  "reason": "replica role is 'prefill'; route decode "
                            "streams through a role-aware router or "
                            "send prefill_only requests"})
            return
        if prefill_only and self.prefix_cache is None:
            send({"error": "BadRequest",
                  "reason": "prefill_only needs a prefix cache to "
                            "park the finished chain in"})
            return
        mnt = int(msg.get("max_new_tokens", 16))
        if prefill_only:
            # the prefill is the work: one token (the least a submit
            # takes) proves the chain complete, and the reply is an ack
            # naming the chain
            mnt = 1
        if mnt < 1 or mnt > self.max_new_tokens_cap:
            send({"error": "BadRequest",
                  "reason": f"max_new_tokens must be in [1, "
                            f"{self.max_new_tokens_cap}]"})
            return
        prio = msg.get("priority", "normal")
        if prio not in _PRIORITIES:
            send({"error": "BadRequest",
                  "reason": f"priority must be one of "
                            f"{sorted(_PRIORITIES)}"})
            return
        deadline_t = None
        if msg.get("deadline_ms") is not None:
            dl = msg["deadline_ms"]
            if isinstance(dl, bool) or \
                    not isinstance(dl, (int, float)) or dl <= 0:
                send({"error": "BadRequest",
                      "reason": "deadline_ms must be a positive "
                                "number of milliseconds"})
                return
            # the budget starts at ARRIVAL
            deadline_t = time.monotonic() + float(dl) / 1e3
        # a fetch_from hint names the peer holding this prompt's chain:
        # pull its blobs on this connection thread before enqueueing (a
        # failed fetch is a counted fallback to the local prefill)
        handoff = None
        if not prefill_only and msg.get("fetch_from") is not None:
            # overload pre-check before the wire pull: a request the
            # gate would shed must not first spend the fetch
            self.scheduler.check_admission(self.engine.num_queued
                                           + self._inbox.qsize())
            handoff = self._handoff_fetch(msg.get("fetch_from"), prompt)
        pending = _Pending(stream=bool(msg.get("stream", False))
                           and not prefill_only)
        with self._admission_lock:
            # submit-time overload gate, atomic with the enqueue
            self.scheduler.check_admission(self.engine.num_queued
                                           + self._inbox.qsize())
            tctx = msg.get("trace")
            if not (isinstance(tctx, dict) and
                    isinstance(tctx.get("id"), str)):
                tctx = None
            payload = {"prompt": prompt, "max_new_tokens": mnt,
                       "eos": msg.get("eos"),
                       "priority": int(_PRIORITIES[prio]),
                       "deadline_t": deadline_t,
                       "trace_ctx": tctx}
            if prefill_only:
                payload["handoff"] = True
            if handoff is not None:
                payload["_handoff"] = handoff
            self._inbox.put((payload, pending))
        self._wake.set()
        self._await_outbox(pending, send,
                           transform=(self._prefill_ack(prompt)
                                      if prefill_only else None))

    def _slo(self, msg: Dict, send) -> None:
        """The ``slo`` op (``server.py:1320-1352``): retarget (resetting
        the window) when ``ttft_ms`` or ``tpot_ms`` is present, then read
        the targets and attainment back. An absent key keeps its target;
        an explicit null clears it."""
        slo = self.metrics.slo
        if "ttft_ms" in msg or "tpot_ms" in msg:
            for k in ("ttft_ms", "tpot_ms"):
                v = msg.get(k)
                if v is not None and (isinstance(v, bool)
                                      or not isinstance(v, (int, float))
                                      or v <= 0):
                    send({"error": "BadRequest",
                          "reason": f"{k} must be a positive number of "
                                    f"ms or null"})
                    return
            slo.set_targets(
                msg["ttft_ms"] if "ttft_ms" in msg else slo.ttft_ms,
                msg["tpot_ms"] if "tpot_ms" in msg else slo.tpot_ms)
        send({"slo": {"ttft_ms": slo.ttft_ms, "tpot_ms": slo.tpot_ms,
                      "window_s": slo.window_s,
                      "attainment": slo.attainment()}})

    def _trace(self, msg: Dict, send) -> None:
        """The ``trace`` op (``server.py:1353-1386``): the finished span
        trees (the last ``n``, or all of them consumed with ``drain``),
        the tracer's events, the step and per-token timelines and the
        program costs; ``format: "chrome"`` returns a chrome trace of
        the finished trees instead."""
        eng = self.engine
        if msg.get("format") == "chrome":
            send({"chrome": self.tracer.to_chrome()})
            return
        n = msg.get("n")
        if msg.get("drain") is True:
            traces = self.tracer.drain()
        else:
            traces = self.tracer.finished(
                n if isinstance(n, int) and not isinstance(n, bool)
                else None)
        send({"traces": traces,
              "events": self.tracer.events(),
              "step_timeline": eng.step_timeline(),
              "multi_step": eng.multi_step,
              "per_token_timeline": eng.per_token_timeline(),
              "program_costs": eng.program_costs(),
              "sample_rate": self.tracer.sample_rate})

    def _capacity(self, ledger_tail=None) -> Dict:
        """The ``capacity`` op (``server.py:2092-2107``): the engine's
        occupancy card, an EWMA exhaustion forecast over the step
        timeline and, on request, the ledger's tail. Connection-thread
        reads of host ints, as health's."""
        from ..inference.page_ledger import forecast_exhaustion
        eng = self.engine
        snap = eng.capacity_snapshot()
        snap["forecast"] = forecast_exhaustion(eng.step_timeline())
        n = ledger_tail
        if isinstance(n, int) and not isinstance(n, bool) and n > 0:
            snap["ledger_tail"] = eng.ledger_tail(n)
        snap["engine_restarts"] = self._restarts
        return snap

    def _profile(self, msg: Dict) -> Dict:
        """The ``profile`` op (``server.py:2109-2167``): each card's
        memory accounting (``torch.cuda.memory_stats`` and
        ``mem_get_info``; a CPU server reports ``memory_stats: null``
        and ``chip_pending: true``), and with ``{"ms": N, "dir": PATH}``
        a ``torch.profiler`` window of CPU and CUDA activity over N ms
        while the engine keeps stepping, written as
        ``PATH/profile-<pid>-<n>.trace.json``. The window runs on the
        engine thread (started and stopped between its steps), the
        thread that launches every kernel: a capture started on a
        connection thread records none of them on the card. One capture
        at a time: a concurrent one gets ProfileBusy."""
        out: Dict[str, Any] = {"devices": [], "chip_pending": True}
        if self.device.type == "cuda":
            for i in range(torch.cuda.device_count()):
                raw = torch.cuda.memory_stats(i)
                stats = {str(k): int(v) for k, v in raw.items()
                         if isinstance(v, (int, float))}
                free, total = torch.cuda.mem_get_info(i)
                stats["device_free_bytes"] = int(free)
                stats["device_total_bytes"] = int(total)
                out["chip_pending"] = False
                out["devices"].append(
                    {"id": i, "platform": "gpu",
                     "kind": torch.cuda.get_device_name(i),
                     "memory_stats": stats})
        else:
            out["devices"].append({"id": 0, "platform": "cpu",
                                   "memory_stats": None})
        ms = msg.get("ms")
        if ms is None:
            return out
        if isinstance(ms, bool) or not isinstance(ms, (int, float)) \
                or ms <= 0 or ms > 30_000:
            return {"error": "BadRequest",
                    "reason": "ms must be a capture window in "
                              "(0, 30000] milliseconds"}
        if not self._profile_lock.acquire(blocking=False):
            return {"error": "ProfileBusy",
                    "reason": "a profiler capture is already running; "
                              "retry after it finishes"}
        try:
            import tempfile
            trace_dir = msg.get("dir") or tempfile.mkdtemp(
                prefix="pt-profile-")
            os.makedirs(trace_dir, exist_ok=True)
            self._profiles += 1
            path = os.path.join(
                trace_dir,
                f"profile-{os.getpid()}-{self._profiles}.trace.json")
            pending = _Pending(stream=False)
            self._inbox.put(({"ctl": "profile", "ms": float(ms),
                              "path": path}, pending))
            self._wake.set()
            replies = []
            self._await_outbox(pending, replies.append)
        except OSError as e:
            return {"error": "ProfileFailed",
                    "reason": f"{type(e).__name__}: {e}"}
        finally:
            self._profile_lock.release()
        rep = replies[-1] if replies else {}
        if "error" in rep:
            return rep
        out.update(trace_dir=trace_dir, ms=float(ms), **rep)
        return out

    def _start_capture(self, payload: Dict, pending: _Pending) -> None:
        """Engine thread: open a profile op's capture window; the loop
        closes it once its time is up (``_maybe_stop_capture``)."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=acts)
            prof.start()
        except Exception as e:
            pending.outbox.put({"error": "ProfileFailed",
                                "reason": f"{type(e).__name__}: {e}"})
            pending.outbox.put(None)
            return
        self._capture = (prof, time.monotonic() + payload["ms"] / 1e3,
                         payload["path"], pending)

    def _maybe_stop_capture(self, force: bool = False) -> None:
        """Engine thread: close the capture window once its time is up
        (or now, ``force``: the loop is exiting) and answer the op."""
        if self._capture is None:
            return
        prof, deadline, path, pending = self._capture
        if not force and time.monotonic() < deadline:
            return
        self._capture = None
        try:
            prof.stop()
            prof.export_chrome_trace(path)
            reply = {"trace_file": path,
                     "trace_bytes": os.path.getsize(path)}
        except Exception as e:
            reply = {"error": "ProfileFailed",
                     "reason": f"{type(e).__name__}: {e}"}
        pending.outbox.put(reply)
        pending.outbox.put(None)

    def _await_outbox(self, pending: _Pending, send,
                      transform=None) -> None:
        """Relay one request's outbox to the client until the None
        sentinel (``transform`` rewrites each message: the prefill ack);
        a fully exited engine thread answers ServerEvicted instead of
        hanging."""
        while True:
            try:
                out = pending.outbox.get(timeout=1.0)
            except queue_mod.Empty:
                if self._engine_done.is_set():
                    send({"error": "ServerEvicted",
                          "reason": "server shutting down"})
                    return
                continue
            if out is None:
                return
            send(out if transform is None else transform(out))

    # -- disaggregated serving ---------------------------------------------

    @staticmethod
    def _parse_hex_keys(val) -> Optional[list]:
        """[] for absent, None for malformed, else the key bytes."""
        if val is None:
            return []
        if not isinstance(val, list):
            return None
        out = []
        for k in val:
            if not isinstance(k, str):
                return None
            try:
                out.append(bytes.fromhex(k))
            except ValueError:
                return None
        return out

    def _prefill_ack(self, prompt):
        """Reply transform of a prefill_only request: the engine's done
        reply becomes an ack naming the parked chain; typed errors pass
        through."""
        def transform(reply: Dict) -> Dict:
            if not reply.get("done"):
                return reply
            pc = self.prefix_cache
            chain = []
            if pc is not None:
                try:
                    chain = [k.hex() for k in pc.chain_keys_for(
                        np.asarray(prompt, np.int32))]
                except Exception:
                    chain = []
            return {"rid": reply.get("rid"), "done": True,
                    "prefilled": True, "keys": chain,
                    "page_size": self._page_size, "role": self.role,
                    "stats": reply.get("stats")}
        return transform

    def _handoff_fetch(self, ff, prompt) -> Optional[Dict]:
        """Wire pull of a generate carrying a ``fetch_from`` hint
        (connection thread): hash the prompt's chain keys, fetch their
        blobs from the peer and return the bundle the engine thread
        imports before the submit. Any failure (a malformed hint, a dead
        peer, a typed peer error) is a counted fallback to the local
        prefill (None), never a hang and never a client error."""
        pc = self.prefix_cache
        if pc is None or not pc.tiers or not isinstance(ff, dict):
            return None
        try:
            host = str(ff.get("host") or self.host)
            port = int(ff["port"])
        except (KeyError, TypeError, ValueError):
            return None
        # a hint stamped with another weight generation is skipped and
        # counted before any wire traffic: its pages came from other
        # weights (the salted chain keys would miss anyway)
        peer_gen = ff.get("generation")
        if peer_gen is not None:
            try:
                peer_gen = int(peer_gen)
            except (TypeError, ValueError):
                return None
            if peer_gen != self._weight_generation:
                self.metrics.counter(
                    "cross_generation_skips_total").add()
                self.tracer.annotate(
                    "handoff_skipped_cross_generation",
                    peer_generation=peer_gen,
                    generation=self._weight_generation)
                return None
        t0 = time.perf_counter()
        try:
            chain = pc.chain_keys_for(np.asarray(prompt, np.int32))
            if not chain:
                return None  # no full shareable block: nothing to pull
            blobs, _missing, nbytes = fetch_page_blobs(
                host, port, keys=chain,
                timeout_s=self.handoff_timeout_s)
        except PageFetchFailed as e:
            self.metrics.counter("handoff_failures_total").add()
            self.tracer.annotate("handoff_fetch_failed",
                                 peer=f"{ff.get('host')}:{ff.get('port')}",
                                 error=str(e)[:200])
            return None
        except Exception as e:
            # e.g. hashing a malformed prompt: the engine's BadRequest
            # owns the reply
            self.metrics.counter("handoff_failures_total").add()
            self.tracer.annotate("handoff_fetch_failed",
                                 error=f"{type(e).__name__}: {e}"[:200])
            return None
        if not blobs:
            return None  # the peer no longer holds the chain
        self.metrics.counter("handoff_bytes_total").add(nbytes)
        return {"blobs": blobs, "heads": chain[:1],
                "ms": (time.perf_counter() - t0) * 1e3,
                "bytes": nbytes}

    def _prefetch(self, msg: Dict, send) -> None:
        """The ``prefetch`` op: fetch a peer's chains (by key or head)
        into this replica's tiers. Fetched on this connection thread,
        imported on the engine thread; every failure is a typed
        reply."""
        keys = self._parse_hex_keys(msg.get("keys"))
        heads = self._parse_hex_keys(msg.get("heads"))
        if keys is None or heads is None or not (keys or heads):
            send({"error": "BadRequest",
                  "reason": "prefetch needs 'keys' and/or 'heads' as "
                            "lists of hex chain keys, plus the peer's "
                            "'host'/'port'"})
            return
        pc = self.prefix_cache
        if pc is None or not pc.tiers:
            send({"error": "PageFetchFailed",
                  "reason": "replica has no spill tier to land "
                            "fetched pages in"})
            return
        try:
            host = str(msg.get("host") or self.host)
            port = int(msg["port"])
        except (KeyError, TypeError, ValueError):
            send({"error": "BadRequest",
                  "reason": "prefetch needs the peer's 'port'"})
            return
        # the cross-generation rule of fetch_from hints
        peer_gen = msg.get("generation")
        if peer_gen is not None and not isinstance(peer_gen, bool) \
                and isinstance(peer_gen, int) \
                and peer_gen != self._weight_generation:
            self.metrics.counter("cross_generation_skips_total").add()
            send({"error": "StaleGeneration",
                  "reason": f"prefetch stamped generation {peer_gen} "
                            f"but this replica serves generation "
                            f"{self._weight_generation}; "
                            f"cross-generation pages never splice",
                  "generation": self._weight_generation})
            return
        t0 = time.perf_counter()
        try:
            blobs, missing, nbytes = fetch_page_blobs(
                host, port, keys=keys, heads=heads,
                timeout_s=self.handoff_timeout_s)
        except PageFetchFailed as e:
            self.metrics.counter("handoff_failures_total").add()
            send({"error": "PageFetchFailed", "reason": str(e)})
            return
        self.metrics.counter("handoff_bytes_total").add(nbytes)
        ms = (time.perf_counter() - t0) * 1e3
        pending = _Pending(stream=False)
        self._inbox.put(({"ctl": "import_blobs", "blobs": blobs,
                          "heads": heads}, pending))
        self._wake.set()

        def add_fetch_info(reply: Dict) -> Dict:
            if reply.get("ok"):
                reply = dict(reply)
                reply["fetch_ms"] = round(ms, 3)
                reply["missing"] = missing
            return reply

        self._await_outbox(pending, send, transform=add_fetch_info)

    def _health(self) -> Dict:
        eng = self.engine
        pc = self.prefix_cache

        def racy(fn, fallback):
            # a connection-thread read of the cache's books, which the
            # engine thread mutates: a probe degrades to a stale value,
            # never to an error the supervisor would count as a failure
            for _ in range(3):
                try:
                    return fn()
                except RuntimeError:
                    continue
            return fallback

        none = {"keys": [], "truncated": False}
        adv = (racy(pc.advertised_keys_info, none) if pc is not None
               else none)
        return {"status": ("failed" if self._failed else
                           "draining" if self._draining else "ok"),
                "pid": os.getpid(),
                "device": str(self.device),
                "active": eng.num_active,
                "queued": eng.num_queued,
                # the role-aware router's dispatch input
                "role": self.role,
                # cache affinity: the page size and the chain heads this
                # replica can serve (device entries and tier blobs);
                # truncated says "not advertised" may still be resident
                "page_size": eng.page_size,
                "prefix_keys": adv["keys"],
                "prefix_keys_truncated": adv["truncated"],
                "free_pages": eng.free_pages,
                "reserved_pages": eng.allocator.reserved_total,
                "cached_pages": pc.total_pages() if pc is not None else 0,
                "num_pages": eng.num_pages,
                "steps": eng.steps,
                "engine_restarts": self._restarts,
                "step_ema_ms": (None if eng.decode_ema_s is None
                                else round(eng.decode_ema_s * 1e3, 3)),
                "prefill_chunk_ema_ms": (
                    None if eng.prefill_chunk_ema_s is None
                    else round(eng.prefill_chunk_ema_s * 1e3, 3)),
                "prefill_debt_tokens": eng.prefill_debt_tokens,
                "prefill_chunk_tokens": eng.prefill_chunk_tokens,
                "fused_step": eng.fused_step,
                "kv_int8": eng.kv_int8,
                # decode iterations a launch (1 = per token) and the
                # launches this engine ran
                "multi_step": eng.multi_step,
                "macro_launches": eng.macro_launches,
                "step_programs": dict(eng.step_programs),
                # the generation served and the swaps this engine took
                "weight_generation": self._weight_generation,
                "weight_swaps": eng.weight_swaps,
                "trace_sample": self.tracer.sample_rate,
                "traces_finished": self.tracer.finished_total,
                "uptime_s": round(time.monotonic() - self._t0, 3)}

    def _gauges(self) -> Dict[str, float]:
        eng = self.engine
        pc = self.prefix_cache
        occ = eng.allocator.occupancy()
        g = {"inflight_slots": eng.num_active,
             "weight_generation": float(self._weight_generation),
             "num_slots": eng.num_slots,
             "queued_requests": eng.num_queued,
             "free_pages": eng.free_pages,
             "reserved_pages": eng.allocator.reserved_total,
             "num_pages": eng.num_pages,
             "prefix_cache_pages": pc.total_pages() if pc is not None
             else 0,
             # un-stored prompt tokens across half-prefilled slots and
             # the queue: the head-of-line pressure against TPOT
             "prefill_debt_tokens": eng.prefill_debt_tokens,
             "pages_inflight": occ["inflight"],
             "pages_prefix_device": occ["prefix_device"],
             "pages_used": eng.num_pages - occ["free"],
             "engine_steps": eng.steps}
        # used minus what the cache would give back on demand: a warm
        # cache fills the pool by design and is no exhaustion
        evictable = 0
        if pc is not None:
            try:
                evictable = int(pc.evictable_pages())
            except RuntimeError:
                pass  # racy read against the engine thread
        g["pages_unreclaimable"] = max(
            0, eng.num_pages - occ["free"] - evictable)
        led = eng.ledger
        if led is not None:
            g["ledger_events"] = led.seq
            g["ledger_dropped"] = led.dropped_total
        if pc is not None:
            for t in pc.tiers:
                g[f"spill_{t.name}_bytes"] = t.occupancy_bytes
                g[f"spill_{t.name}_logical_bytes"] = t.logical_bytes
                g[f"spill_{t.name}_blobs"] = t.blob_count
                g[f"spill_{t.name}_capacity_bytes"] = t.capacity_bytes
        g["step_programs"] = dict(eng.step_programs).get("decode", 0)
        for kind, n in dict(eng.programs_launched).items():
            g[f"programs_launched_{kind}"] = n
        tl = eng.step_timeline()
        if tl:
            g["step_last_ms"] = tl[-1].get("ms", 0.0)
            g["step_last_decode_ms"] = tl[-1].get("decode_ms", 0.0)
            self._feed_step_histogram(eng, tl)
        # each program kind's flops and bytes, counted at its first
        # launch (inference/costs.py)
        for kind, cost in eng.program_costs().items():
            if "flops" in cost:
                g[f"program_{kind}_flops"] = cost["flops"]
                g[f"program_{kind}_bytes_accessed"] = \
                    cost["bytes_accessed"]
        # the tracer's lifetime totals, synced at scrape (monotonic)
        for cname, val in (
                ("traces_sampled_total", self.tracer.sampled_total),
                ("traces_finished_total", self.tracer.finished_total),
                ("trace_spans_dropped_total",
                 self.tracer.spans_dropped_total)):
            self.metrics.counter(cname).set(val)
        return g

    def _feed_step_histogram(self, eng, tl) -> None:
        """Observe the timeline entries newer than the last scrape into
        ``serving_step_ms``, and a drained macro launch's iterations and
        host wait into ``serving_steps_per_launch`` /
        ``serving_host_overlap_idle_ms``; add the engine's new macro
        launches to ``serving_macro_steps_total``
        (``server.py:1960-1993``). Both markers key on the restart
        count, which only grows."""
        key, seen = self._tl_seen
        if key != self._restarts:
            key, seen = self._restarts, -1
        for entry in tl:
            s = entry.get("step", 0)
            if s > seen:
                self.metrics.step_ms.observe(entry.get("ms", 0.0))
                macro = entry.get("macro")
                if macro:
                    self.metrics.steps_per_launch.observe(
                        float(macro.get("steps", 0)))
                    self.metrics.host_overlap_idle_ms.observe(
                        float(macro.get("overlap_idle_ms", 0.0)))
                seen = s
        self._tl_seen = (key, seen)
        ml = int(eng.macro_launches)
        mkey, mseen = self._macro_seen
        if mkey != self._restarts:
            mkey, mseen = self._restarts, 0
        if ml > mseen:
            self.metrics.counter("macro_steps_total").add(ml - mseen)
            mseen = ml
        self._macro_seen = (mkey, mseen)

    # chain pages served a fetch_pages reply at most: bounds how long one
    # peer call holds the engine thread between steps
    FETCH_PAGES_CAP = 512

    def _serve_fetch_pages(self, payload: Dict) -> Dict:
        """Engine-thread half of the ``fetch_pages`` op: expand the
        requested chain heads, pack device-resident pages and read tier
        blobs, base64 them. A key this replica cannot produce is listed
        in ``missing`` (the peer's chained prefill covers it).

        Each reply serves at most ``FETCH_PAGES_CAP`` keys from
        ``payload["cursor"]`` (an offset into the expanded key list) and
        carries ``next_cursor`` while more remain, so a long chain hands
        off whole over several bounded calls; ``truncated`` says the
        list passed the cap."""
        import base64
        pc = self.prefix_cache
        if pc is None:
            return {"error": "PageFetchFailed",
                    "reason": "replica has no prefix cache"}
        keys = list(payload.get("keys") or ())
        heads = list(payload.get("heads") or ())
        if heads:
            seen = set(keys)
            keys += [k for k in pc.expand_heads(heads)
                     if k not in seen]
        cursor = max(0, int(payload.get("cursor") or 0))
        window = keys[cursor:cursor + self.FETCH_PAGES_CAP]
        remaining = len(keys) - (cursor + len(window))
        truncated = len(keys) > self.FETCH_PAGES_CAP
        blobs, missing = pc.export_blobs(window)
        reply = {"blobs": {k.hex(): base64.b64encode(b).decode("ascii")
                           for k, b in blobs.items()},
                 "missing": [k.hex() for k in missing],
                 "count": len(blobs),
                 "bytes": sum(len(b) for b in blobs.values()),
                 "truncated": truncated,
                 "role": self.role,
                 # the generation these blobs were computed under
                 "generation": self._weight_generation}
        if remaining > 0:
            reply["next_cursor"] = cursor + len(window)
        return reply

    def _import_blobs(self, payload: Dict) -> Dict:
        """Engine-thread half of the ``prefetch`` op: land fetched blobs
        in the cache's tiers (each crc checked by ``import_blobs``)."""
        pc = self.prefix_cache
        if pc is None or not pc.tiers:
            return {"error": "PageFetchFailed",
                    "reason": "replica has no spill tier to land "
                              "fetched pages in"}
        rep = pc.import_blobs(payload.get("blobs") or {},
                              heads=payload.get("heads") or ())
        rep["ok"] = True
        return rep

    def _leak_check(self) -> Dict:
        """Engine-thread page audit: with no in-flight work the
        allocator must balance (no cache: everything free; with one:
        free + cache-owned == pool, ``check_consistent``), and the page
        ledger must reconcile."""
        eng = self.engine
        led = eng.ledger
        ledger_info = ({"ok": True, "enabled": False} if led is None
                       else led.reconcile(eng.allocator))
        if eng.num_active or eng.num_queued:
            return {"ok": False, "busy": True,
                    "active": eng.num_active, "queued": eng.num_queued}
        pc = self.prefix_cache
        try:
            if pc is not None:
                pc.check_consistent(eng.allocator)
            else:
                eng.check_no_leak()
        except Exception as e:
            return {"ok": False, "busy": False,
                    "error": type(e).__name__, "reason": str(e),
                    "ledger": ledger_info}
        return {"ok": True, "busy": False, "free_pages": eng.free_pages,
                "cached_pages": pc.total_pages() if pc is not None else 0,
                "num_pages": eng.num_pages, "ledger": ledger_info}

    def _cache_stats(self) -> Optional[Dict]:
        pc = self.prefix_cache
        if pc is None:
            return None
        return {"pages": pc.total_pages(), "hit_pages": pc.hit_pages,
                "miss_pages": pc.miss_pages,
                "inserted_pages": pc.inserted_pages,
                "evicted_pages": pc.evicted_pages,
                "hit_rate": pc.hit_rate(),
                "tiers": pc.tier_stats(),
                "spilled_pages": pc.spilled_pages,
                "restored_pages": pc.restored_pages,
                "restore_corrupt": pc.restore_corrupt,
                "spill_failed": pc.spill_failed,
                # the wire handoff's pages, each way
                "exported_pages": pc.exported_pages,
                "imported_pages": pc.imported_pages,
                "import_corrupt": pc.import_corrupt,
                "blob_format": pc.blob_format,
                "dedup": pc.dedup,
                "dedup_hits": pc.dedup_hits,
                "codec_stats": dict(pc.codec_stats)}


def _json_stats(stats) -> Dict:
    out = stats.to_dict()
    return {k: (round(v, 6) if isinstance(v, float) else v)
            for k, v in out.items() if v is not None}


def client_request(host: str, port: int, payload: Dict,
                   timeout_s: float = 120.0, on_token=None) -> Dict:
    """Minimal blocking client: send one request, collect streamed
    tokens through ``on_token(token)``, return the final reply."""
    with socket.create_connection((host, port), timeout=timeout_s) as s:
        rfile = s.makefile("r", encoding="utf-8")
        wfile = s.makefile("w", encoding="utf-8")
        wfile.write(json.dumps(payload) + "\n")
        wfile.flush()
        for line in rfile:
            msg = json.loads(line)
            if "token" in msg:  # streamed chunk
                if on_token is not None:
                    on_token(msg["token"])
                continue
            return msg  # final reply: summary, admin reply, or error
    raise ConnectionError("server closed the connection mid-request")


def build_model(name: str, device=None, num_layers: Optional[int] = None):
    """A seed-0 random-init model of a named config on ``device`` (the
    served model and a ``--draft-model`` alike); ``num_layers`` cuts the
    config's depth, its widths kept."""
    import dataclasses

    from ..models.gpt import CONFIGS, GPTForCausalLM
    if name not in CONFIGS:
        raise SystemExit(f"unknown --model {name!r}; choose from "
                         f"{sorted(CONFIGS)}")
    cfg = CONFIGS[name]()
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = GPTForCausalLM(cfg, device=dev, generator=gen)
    model.eval()
    return model


def main(argv=None) -> None:
    import argparse
    parser = argparse.ArgumentParser(
        description="paddle_tpu_torch serving front-end (newline-JSON)")
    parser.add_argument("--model", default="gpt_125m")
    parser.add_argument("--num-layers", type=int, default=None,
                        help="the model's first N blocks (default: its "
                             "config's depth)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the "
                             "plain PyTorch versions of the kernels)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--num-slots", type=int, default=4)
    parser.add_argument("--page-size", type=int, default=64)
    parser.add_argument("--num-pages", type=int, default=None)
    parser.add_argument("--max-seq-len", type=int, default=None)
    parser.add_argument("--kv-int8", action="store_true",
                        help="int8 KV pages with per-(token, head) scales")
    parser.add_argument("--no-prefix-cache", action="store_true",
                        help="serve without the prefix cache (greedy "
                             "outputs are the same)")
    parser.add_argument(
        "--role", default="mixed", choices=list(_ROLES),
        help="'mixed' (default) is the whole replica. 'prefill' answers "
             "prefill_only requests only, parks finished KV chains in "
             "its cache and spill tiers, advertises them in health's "
             "prefix_keys and serves them to peers over fetch_pages "
             "(plain generates get a typed WrongRole). 'decode' serves "
             "token streams and, given a fetch_from hint, pulls the "
             "prompt's chain from the prefill peer and splices it in "
             "instead of prefilling (greedy outputs are the same either "
             "way). Non-mixed roles default a 64 MB host spill tier")
    parser.add_argument(
        "--handoff-timeout-s", type=float, default=30.0, metavar="S",
        help="socket timeout of a fetch_pages pull from a peer; on "
             "expiry the request falls back to the local prefill "
             "(counted, never a hang)")
    parser.add_argument(
        "--spill-mb", type=int, default=None, metavar="MB",
        help="add a host-RAM spill tier of this many MB: evicted prefix "
             "pages are kept as content-keyed blobs and restored on a "
             "later hit instead of prefilled again (default: evictions "
             "are dropped)")
    parser.add_argument(
        "--spill-dir", default=None, metavar="DIR",
        help="add a disk spill tier under DIR behind the host tier "
             "(blobs crc32-checked on restore, scrubbed on shutdown)")
    parser.add_argument(
        "--spill-disk-mb", type=int, default=1024, metavar="MB",
        help="byte budget of the --spill-dir disk tier (default 1024)")
    parser.add_argument(
        "--blob-format", default="raw", choices=["raw", "int8", "int4"],
        help="codec of the spill blobs: 'raw' (default) the pool's "
             "bytes; 'int8' lossless on int8 pages, quantized on float "
             "pages; 'int4' always lossy (the error is reported in the "
             "stats op's codec_stats)")
    parser.add_argument(
        "--max-engine-errors", type=int, default=32,
        help="consecutive engine-step failures before the engine is "
             "resurrected (torn down, rebuilt, in-flight replayed)")
    parser.add_argument(
        "--max-engine-restarts", type=int, default=2,
        help="engine resurrections before the server gives up and "
             "fails everything with a typed EngineFailed")
    parser.add_argument(
        "--stall-timeout-s", type=float, default=None,
        help="evict a slot that emits no token for this long with a "
             "typed RequestStalled reply (default: watchdog off)")
    parser.add_argument(
        "--no-dedup", action="store_true",
        help="keep a request's private copy of a full prompt page that "
             "a sibling with the same prompt cached first (default: "
             "fold it onto the shared page; greedy outputs are the same)")
    parser.add_argument(
        "--prefill-chunk", type=int, default=None, metavar="TOKENS",
        help="chunked prefill: prefill at most this many page-aligned "
             "tokens of one admitted prompt a decode step (a multiple "
             "of --page-size; default: whole-prompt prefill). Greedy "
             "outputs are the same; smaller chunks protect in-flight "
             "TPOT, larger ones finish long prefills sooner")
    parser.add_argument(
        "--speculate", type=int, default=0, metavar="K",
        help="draft K tokens a decode step and verify them in one "
             "forward (0 = off); greedy outputs are the same")
    parser.add_argument(
        "--draft-model", default="ngram",
        help="draft source for --speculate: 'ngram' (prompt lookup, "
             "no second model) or a model name, built like --model")
    parser.add_argument(
        "--draft-window", type=int, default=64,
        help="context window of a --draft-model draft")
    parser.add_argument(
        "--multi-step", type=int, default=1, metavar="N",
        help="run N decode iterations a launch (on the card one CUDA "
             "graph of the decode iteration replayed N times, the tokens "
             "read back once a launch; 1 = per-token decode). Greedy "
             "outputs are the same; with --prefill-chunk or --speculate "
             "the chunks and the verify run inside the launch")
    parser.add_argument(
        "--no-fused-step", action="store_true",
        help="run the unfused decode ops (attention, then the "
             "out-projection, then the full logits)")
    parser.add_argument("--trace-sample", type=float, default=0.0,
                        metavar="R",
                        help="sample this fraction of requests into "
                             "span trees (0 = off)")
    parser.add_argument("--slo-ttft-ms", type=float, default=None)
    parser.add_argument("--slo-tpot-ms", type=float, default=None)
    parser.add_argument("--slo-window-s", type=float, default=120.0)
    parser.add_argument(
        "--flight-dir", default=None, metavar="DIR",
        help="crash flight recorder: write black-box bundles (step "
             "timeline ring, sampled traces, metrics export, in-flight "
             "dump, engine recipe) to DIR on a resurrection, a terminal "
             "EngineFailed, a stalled request or a failed swap; atomic "
             "writes, byte-budgeted retention; read them with "
             "tools/flight_inspect.py")
    parser.add_argument(
        "--flight-budget-mb", type=int, default=64, metavar="MB",
        help="retention byte budget of --flight-dir (oldest bundles "
             "pruned first, the newest always kept; default 64)")
    parser.add_argument(
        "--no-page-ledger", action="store_true",
        help="turn the page ledger off (every page event in a bounded "
             "ring with owner, step and reason: leak forensics, ledger "
             "reconciliation, the capacity op's event tail); greedy "
             "outputs are the same either way")
    parser.add_argument(
        "--checkpoint", default=None, metavar="DIR",
        help="boot from the newest valid checkpoint under DIR "
             "(ResilientCheckpointManager layout, crc-validated) instead "
             "of the seeded weights; a missing or corrupt checkpoint "
             "fails startup. Swap a live server with the 'swap' op")
    parser.add_argument(
        "--weight-generation", type=int, default=0, metavar="N",
        help="the weight generation served (salts the prefix cache's "
             "chain keys, so pages of other generations miss)")
    parser.add_argument(
        "--forecast-admission", action="store_true",
        help="admission also charges the forecast page burn of the "
             "admitted load (an EWMA over the step timeline) over the "
             "request's expected lifetime (default: the free pages "
             "alone)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    if args.num_layers is None:
        model = build_model(args.model, device)
    else:
        model = build_model(args.model, device, args.num_layers)
    engine_kwargs = {"num_slots": args.num_slots,
                     "page_size": args.page_size,
                     "kv_int8": args.kv_int8,
                     "fused_step": not args.no_fused_step,
                     "stall_timeout_s": args.stall_timeout_s}
    if args.num_pages is not None:
        engine_kwargs["num_pages"] = args.num_pages
    if args.max_seq_len is not None:
        engine_kwargs["max_seq_len"] = args.max_seq_len
    if args.prefill_chunk is not None:
        # rides in engine_kwargs, so a resurrection rebuilds a chunked
        # engine too
        engine_kwargs["prefill_chunk_tokens"] = args.prefill_chunk
    if args.multi_step != 1:
        # rides in engine_kwargs: a resurrection rebuilds a multi-step
        # engine and replays onto it
        engine_kwargs["multi_step"] = args.multi_step
    if args.no_page_ledger:
        engine_kwargs["page_ledger"] = False
    if args.forecast_admission:
        # rides in engine_kwargs, so a rebuilt engine keeps the gate
        engine_kwargs["forecast_admission"] = True
    if args.speculate > 0:
        from ..inference import SpeculativeConfig
        draft = args.draft_model
        if draft != "ngram":
            draft = build_model(draft, device)
        engine_kwargs["speculative"] = SpeculativeConfig(
            k=args.speculate, draft=draft, draft_window=args.draft_window)
    server = ServingServer(model, host=args.host, port=args.port,
                           prefix_cache=not args.no_prefix_cache,
                           role=args.role,
                           handoff_timeout_s=args.handoff_timeout_s,
                           dedup=not args.no_dedup,
                           spill_bytes=(None if args.spill_mb is None
                                        else args.spill_mb << 20),
                           spill_dir=args.spill_dir,
                           spill_disk_bytes=(
                               None if args.spill_dir is None
                               else args.spill_disk_mb << 20),
                           blob_format=args.blob_format,
                           max_engine_errors=args.max_engine_errors,
                           max_engine_restarts=args.max_engine_restarts,
                           trace_sample=args.trace_sample,
                           slo_ttft_ms=args.slo_ttft_ms,
                           slo_tpot_ms=args.slo_tpot_ms,
                           slo_window_s=args.slo_window_s,
                           flight_dir=args.flight_dir,
                           flight_budget_bytes=(
                               args.flight_budget_mb << 20),
                           checkpoint=args.checkpoint,
                           weight_generation=args.weight_generation,
                           device=device, **engine_kwargs)
    port = server.start()
    print(f"[paddle_tpu_torch.serving] listening on {args.host}:{port} "
          f"(model {args.model}, {module_device(model)}); newline-JSON, "
          f"see module docstring", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("[paddle_tpu_torch.serving] draining ...", flush=True)
        server.stop()


if __name__ == "__main__":
    main()
