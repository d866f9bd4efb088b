"""End-to-end request tracing (r16): span trees from router to engine.

One trace id follows a request through every hop the serving stack has
grown — FailoverRouter pick/forward/failover, replica receive,
scheduler queue, admission (prefix-cache match, spill-tier restore),
every prefill chunk, every decode/verify step, resurrection replay —
as a tree of timestamped spans. The reference framework treats tracing
as a first-class layer (platform/profiler.h RecordEvent host markers +
CUPTI device tracing); this is the serving-stack half of that idea:
the per-request, per-hop latency attribution that aggregate histograms
(serving/metrics.py) cannot give, and the input the ``serving_goodput``
bench computes SLO attainment from.

Design constraints (the hot-path contract):

- OFF BY DEFAULT costs ~zero: tracing is decided once per request by a
  deterministic sampler (``sample_rate``; an accumulator, not an RNG,
  so a 0.1 rate traces exactly every 10th request), and every hook in
  the engine is a single ``req.trace is None`` attribute check. No
  per-token allocation happens for unsampled requests.
- BOUNDED MEMORY: finished traces live in a fixed-size ring
  (``max_traces``); a runaway generation stops allocating spans at
  ``max_spans_per_trace`` and counts the overflow in
  ``dropped_spans`` instead of growing without bound.
- ONE TREE PER REQUEST across stitch points: resurrection replay and
  keyed router failover continue the SAME trace (the replayed/failed-
  over request's spans append to the original tree with explicit
  replay/failover markers), and every terminal path closes its open
  spans — ``leaked_open`` is pinned 0 by tests.

Span ids are strings namespaced per trace PARTICIPANT (process ×
trace instance), so router spans and replica spans for the same trace
id merge without collisions; a cross-process parent (the router's
forward span) is carried as ``remote_parent`` in the child root's args
— locally the tree stays orphan-free (tools/trace_lint.py), merged it
links into one tree.

Export: ``to_dict`` span trees and Chrome trace-event JSON
(``to_chrome`` / ``chrome_events``). This is the PyTorch port's copy of
``paddle_tpu/serving/tracing.py``. When ``core/profiler.py`` is enabled,
finished spans are also injected as host events (``profiler_bridge``),
so one ``export_chrome_trace`` carries the request spans beside the
``RecordEvent`` markers.

Debug mode: PT_SERVING_DEBUG=1 (see server.py) is now this tracer at
``sample_rate=1.0`` with the ``stderr_span_sink`` — one event
vocabulary for lifecycle debugging and trace export, replacing the
ad-hoc r9 print sites.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core import profiler

__all__ = ["Span", "RequestTrace", "SpanTracer", "stderr_span_sink",
           "chrome_events", "request_latencies"]


def now_us() -> float:
    """The tracer clock: time.monotonic in microseconds (the same
    clock the engine's RequestStats use, so spans and stats agree)."""
    return time.monotonic() * 1e6


# per-process participant counter: each RequestTrace instance gets a
# unique segment so span ids from different processes (router vs
# replica) or trace instances never collide when merged
_SEG = itertools.count()


class Span:
    """One timed operation in a trace. ``t1_us`` is None while open."""

    __slots__ = ("sid", "parent", "name", "t0_us", "t1_us", "args")

    def __init__(self, sid: str, parent: Optional[str], name: str,
                 t0_us: float, args: Dict[str, Any]):
        self.sid = sid
        self.parent = parent
        self.name = name
        self.t0_us = t0_us
        self.t1_us: Optional[float] = None
        self.args = args

    def to_dict(self) -> Dict[str, Any]:
        return {"sid": self.sid, "parent": self.parent,
                "name": self.name, "t0_us": self.t0_us,
                "t1_us": self.t1_us, "args": dict(self.args)}


class RequestTrace:
    """The span tree of one request (one participant's share of it).

    Span mutation is engine-thread-dominant but submit/finish can run
    on connection threads; a small lock guards the id counter and the
    span list. All methods are no-op-cheap — the expensive decision
    (to trace at all) was made once at sampling time."""

    __slots__ = ("trace_id", "pid", "spans", "anchor", "state",
                 "dropped_spans", "leaked_open", "_seg", "_n",
                 "_lock", "_tracer", "_max_spans", "_finished")

    def __init__(self, trace_id: str, tracer: "SpanTracer",
                 max_spans: int):
        self.trace_id = trace_id
        self.pid = os.getpid()
        self.spans: List[Span] = []
        self.anchor: Optional[Span] = None  # the root/stage parent
        self.state: Optional[str] = None
        self.dropped_spans = 0
        self.leaked_open = 0
        self._seg = f"{self.pid:x}.{next(_SEG):x}"
        self._n = 0
        self._lock = threading.Lock()
        self._tracer = tracer
        self._max_spans = max_spans
        self._finished = False

    # -- span construction -------------------------------------------------

    def _new(self, name: str, parent, t0_us: float,
             args: Dict[str, Any]) -> Optional[Span]:
        pid_ = parent.sid if isinstance(parent, Span) else parent
        with self._lock:
            if self._finished or len(self.spans) >= self._max_spans:
                self.dropped_spans += 1
                return None
            self._n += 1
            sp = Span(f"{self._seg}:{self._n}", pid_, name, t0_us, args)
            self.spans.append(sp)
        return sp

    def begin(self, name: str, parent=None, **args) -> Optional[Span]:
        sp = self._new(name, parent, now_us(), args)
        if sp is not None:
            self._tracer._on_span("begin", self, sp)
        return sp

    def end(self, span: Optional[Span], **args) -> None:
        if span is None or span.t1_us is not None:
            return
        span.t1_us = now_us()
        if args:
            span.args.update(args)
        self._tracer._on_span("end", self, span)

    def add(self, name: str, t0_us: float, t1_us: float, parent=None,
            **args) -> Optional[Span]:
        """Append an already-timed (closed) span — the per-step path:
        the engine measures one decode/verify interval and attributes
        it to every sampled in-flight request without re-reading the
        clock per slot."""
        sp = self._new(name, parent, t0_us, args)
        if sp is not None:
            sp.t1_us = t1_us
            self._tracer._on_span("end", self, sp)
        return sp

    def event(self, name: str, parent=None, **args) -> Optional[Span]:
        """Zero-duration marker (first_token, complete, replay...)."""
        t = now_us()
        sp = self._new(name, parent, t, args)
        if sp is not None:
            sp.t1_us = t
            self._tracer._on_span("event", self, sp)
        return sp

    # -- wire context ------------------------------------------------------

    def ctx(self, parent=None) -> Dict[str, Any]:
        """The wire form another process continues this trace from:
        the receiving side adopts the id and records ``parent`` as its
        root's ``remote_parent`` (cross-process links stay out of the
        local parent field so a single participant's dump is still
        orphan-free for trace_lint)."""
        p = parent.sid if isinstance(parent, Span) else parent
        return {"id": self.trace_id, "parent": p, "sampled": True}

    # -- introspection -----------------------------------------------------

    def open_spans(self) -> int:
        with self._lock:
            return sum(1 for s in self.spans if s.t1_us is None)

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {"trace_id": self.trace_id, "pid": self.pid,
                    "state": self.state,
                    "dropped_spans": self.dropped_spans,
                    "leaked_open": self.leaked_open,
                    "spans": [s.to_dict() for s in self.spans]}


class SpanTracer:
    """Sampling, bounded-memory span tracer (the serving tentpole).

    ``sample_rate`` in [0, 1]: deterministic accumulator sampling.
    ``on_span(kind, trace_id, span_dict)`` is the optional live sink
    (``stderr_span_sink`` — the PT_SERVING_DEBUG lifecycle stream);
    ``profiler_bridge`` additionally injects finished spans into
    core/profiler.py's host-event buffer whenever that profiler is
    enabled, so one ``export_chrome_trace`` carries both."""

    def __init__(self, sample_rate: float = 0.0, max_traces: int = 64,
                 max_spans_per_trace: int = 4096,
                 on_span: Optional[Callable] = None,
                 profiler_bridge: bool = True):
        self.sample_rate = float(sample_rate)
        if not 0.0 <= self.sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate must be in [0, 1], got {self.sample_rate}")
        self.max_spans_per_trace = int(max_spans_per_trace)
        self.on_span = on_span
        self.profiler_bridge = bool(profiler_bridge)
        self._ring: "deque[Dict]" = deque(maxlen=int(max_traces))
        self._events: "deque[Dict]" = deque(maxlen=256)
        self._acc = 0.0
        self._nid = itertools.count()
        self._lock = threading.Lock()
        # lifetime counters (exported as serving_traces_* series)
        self.sampled_total = 0
        self.finished_total = 0
        self.spans_dropped_total = 0

    # -- sampling / lifecycle ----------------------------------------------

    def sample(self) -> bool:
        """Deterministic: rate 1.0 samples everything, 0.25 every 4th
        request — no RNG on the submit path, reproducible in tests."""
        if self.sample_rate <= 0.0:
            return False
        with self._lock:
            self._acc += self.sample_rate
            if self._acc >= 1.0 - 1e-9:
                self._acc -= 1.0
                return True
        return False

    def start(self, name: str, ctx: Optional[Dict] = None,
              sampled: Optional[bool] = None, **args
              ) -> Optional[RequestTrace]:
        """Open a new trace with root span ``name``; returns None when
        the request is not sampled. ``ctx`` (a ``RequestTrace.ctx()``
        dict from another hop) forces sampling and adopts its id."""
        if ctx is not None and isinstance(ctx, dict) and ctx.get("id"):
            tid = str(ctx["id"])
            take = True
            if ctx.get("parent"):
                args.setdefault("remote_parent", str(ctx["parent"]))
        else:
            take = sampled if sampled is not None else self.sample()
            if not take:
                return None
            tid = (f"{os.getpid():x}-{next(self._nid):x}-"
                   f"{time.time_ns() & 0xffffffff:08x}")
        with self._lock:
            self.sampled_total += 1
        tr = RequestTrace(tid, self, self.max_spans_per_trace)
        tr.anchor = tr.begin(name, **args)
        return tr

    def finish(self, trace: Optional[RequestTrace],
               state: Optional[str] = None) -> None:
        """Close the root, force-close stragglers (counted in
        ``leaked_open`` — the zero the stitch-point tests pin), and
        move the trace into the finished ring."""
        if trace is None or trace._finished:
            return
        if state is not None:
            trace.state = state
        if trace.anchor is not None and trace.anchor.t1_us is None:
            trace.end(trace.anchor, state=trace.state)
        t = now_us()
        with trace._lock:
            for s in trace.spans:
                if s.t1_us is None:
                    s.t1_us = t
                    s.args["leaked_open"] = True
                    trace.leaked_open += 1
            trace._finished = True
        with self._lock:
            self.finished_total += 1
            self.spans_dropped_total += trace.dropped_spans
            self._ring.append(trace.to_dict())

    # -- sinks -------------------------------------------------------------

    def _on_span(self, kind: str, trace: RequestTrace, span: Span
                 ) -> None:
        if self.on_span is not None:
            try:
                self.on_span(kind, trace.trace_id, span.to_dict())
            except Exception:
                pass  # a sink must never break the serving path
        if kind != "begin" and self.profiler_bridge \
                and span.t1_us is not None:
            _bridge_profiler(trace.trace_id, span)

    def annotate(self, name: str, **args) -> None:
        """Tracer-level event not tied to one request (resurrection
        snapshots, router restarts) — bounded ring + live sink; the
        chaos-postmortem channel the old debug prints served."""
        ev = {"name": name, "t_us": now_us(), "args": args}
        with self._lock:
            self._events.append(ev)
        if self.on_span is not None:
            try:
                self.on_span("annotate", None,
                             {"name": name, "t0_us": ev["t_us"],
                              "t1_us": ev["t_us"], "args": args,
                              "sid": None, "parent": None})
            except Exception:
                pass

    # -- export ------------------------------------------------------------

    def finished(self, n: Optional[int] = None) -> List[Dict]:
        with self._lock:
            out = list(self._ring)
        return out if n is None else out[-int(n):]

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def drain(self) -> List[Dict]:
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
        return out

    def to_chrome(self, traces: Optional[List[Dict]] = None) -> Dict:
        """Chrome trace-event JSON of finished traces — the format
        tools/merge_traces.py merges with ``jax.profiler`` output."""
        evs: List[Dict] = []
        for t in (self.finished() if traces is None else traces):
            evs.extend(chrome_events(t))
        return {"traceEvents": evs}


def chrome_events(trace: Dict) -> List[Dict]:
    """One finished-trace dict -> chrome 'X' events (one tid per
    trace, so each request renders as its own row)."""
    tid = abs(hash(trace.get("trace_id", ""))) % 1_000_000
    out = []
    for s in trace.get("spans", ()):
        t0 = s.get("t0_us", 0.0)
        t1 = s.get("t1_us")
        args = dict(s.get("args") or {})
        args["trace_id"] = trace.get("trace_id")
        if s.get("sid"):
            args["sid"] = s["sid"]
        if s.get("parent"):
            args["parent"] = s["parent"]
        out.append({"name": s.get("name", "?"), "ph": "X", "ts": t0,
                    "dur": max((t1 if t1 is not None else t0) - t0,
                               0.01),
                    "pid": trace.get("pid", 0), "tid": tid,
                    "args": args})
    return out


def request_latencies(trace: Dict) -> Optional[Dict[str, float]]:
    """TTFT / TPOT / e2e of one finished request trace — the numbers
    the serving_goodput bench computes SLO attainment from. Returns
    None when the trace lacks the lifecycle markers (e.g. a shed
    request that never produced a token)."""
    submit = first = complete = None
    tokens_out = pre_tokens = 0
    priority = None
    for s in trace.get("spans", ()):
        name = s.get("name")
        if name == "queue" and submit is None:
            submit = s.get("t0_us")
            p = (s.get("args") or {}).get("priority")
            if isinstance(p, int) and not isinstance(p, bool):
                priority = p
        elif name == "first_token" and first is None:
            first = s.get("t0_us")
        elif name == "complete":
            complete = s.get("t0_us")
            tokens_out = int((s.get("args") or {}).get("tokens_out", 0))
        elif name == "resurrect_replay":
            # a stitched tree's 'complete' counts only the FINAL
            # replay slice's tokens (the engine restarts generated[]
            # per replay); each resurrect marker carries its dying
            # slice's count — the client-experienced total is the sum
            pre_tokens += int((s.get("args") or {}).get(
                "pre_tokens", 0))
    if submit is None or complete is None:
        return None
    tokens_out += pre_tokens
    out = {"submit_us": submit, "complete_us": complete,
           "tokens_out": tokens_out,
           # the queue span's priority arg (None when untraced) — the
           # fleet SLO monitor tracks attainment per class, and the
           # trace-computed attainment must split the same way (r17)
           "priority": priority,
           "e2e_s": (complete - submit) / 1e6,
           "ttft_s": None, "tpot_s": None}
    if first is not None:
        out["first_token_us"] = first
        out["ttft_s"] = (first - submit) / 1e6
        if tokens_out > 1:
            out["tpot_s"] = ((complete - first) / 1e6
                             / (tokens_out - 1))
    return out


def stderr_span_sink(kind: str, trace_id: Optional[str],
                     span: Dict) -> None:
    """The PT_SERVING_DEBUG live sink: one line per span begin/end and
    tracer annotation on stderr — the unified replacement for the r9
    ad-hoc lifecycle prints (same information, one event vocabulary)."""
    args = span.get("args") or {}
    kv = " ".join(f"{k}={v}" for k, v in args.items())
    tid = (trace_id or "-")[-12:]
    dur = ""
    if kind == "end" and span.get("t1_us") is not None:
        dur = f" {(span['t1_us'] - span['t0_us']) / 1e3:.3f}ms"
    print(f"[pt-serving-trace {time.monotonic():.3f}] {kind} "
          f"{span.get('name')} trace={tid}{dur} {kv}".rstrip(),
          file=sys.stderr, flush=True)


def _bridge_profiler(trace_id: str, span: Span) -> None:
    """Inject a closed span into core/profiler.py's host-event buffer
    when that profiler is enabled: serving spans then ride the same
    ``export_chrome_trace`` as the RecordEvent markers."""
    if not profiler.profiler_active():
        return
    try:
        profiler.external_event(span.name, span.t0_us, span.t1_us,
                                annotation=trace_id)
    except Exception:
        pass  # the bridge must never break the serving path
