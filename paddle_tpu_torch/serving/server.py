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

Typed failures are structured replies, never hangs: ``ServerOverloaded``
(queue past the SLO scheduler's bounds), ``ServerDraining`` (a drained
server rejects new generates), ``DeadlineExceeded`` (``deadline_ms``
elapsed before completion), ``BadRequest`` (malformed input),
``PrefillFailed``, ``RequestStalled``, ``ServerEvicted`` and
``EngineFailed``.

This slice serves without a prefix cache: its behaviour is the JAX
server's ``--no-prefix-cache``, whose greedy outputs are identical.
Ops and flags not yet ported (``export``, ``slo``, ``trace``,
``capacity``, ``profile``, ``fetch_pages``, ``prefetch``, ``swap``;
``--role``, ``--spill-*``, ``--speculate``, ``--mesh``, ...) are
answered as the JAX server answers an unknown op or flag. Engine
resurrection is not ported: after ``max_engine_errors`` consecutive
step failures the server fails typed (``EngineFailed``).

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
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import module_device, resolve_device
from .metrics import ServingMetrics, SLOAttainment
from .scheduler import Priority, ServerOverloaded, SLOScheduler
from .tracing import SpanTracer, stderr_span_sink

__all__ = ["ServingServer", "client_request"]

_PRIORITIES = {"batch": Priority.BATCH, "normal": Priority.NORMAL,
               "interactive": Priority.INTERACTIVE}


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
    ``scheduler=None`` defaults to an ``SLOScheduler``. The model must
    live on ``device`` (CUDA unless named)."""

    def __init__(self, model, host: str = "127.0.0.1", port: int = 0,
                 scheduler=None, prefix_cache: bool = False,
                 metrics: Optional[ServingMetrics] = None,
                 max_new_tokens_cap: int = 512,
                 poll_interval_s: float = 0.02,
                 max_engine_errors: int = 32,
                 trace_sample: float = 0.0, trace_max: int = 64,
                 tracer: Optional[SpanTracer] = None,
                 slo_ttft_ms: Optional[float] = None,
                 slo_tpot_ms: Optional[float] = None,
                 slo_window_s: float = 120.0,
                 device=None, **engine_kwargs):
        from ..inference import create_decode_engine
        if prefix_cache:
            raise NotImplementedError(
                "the prefix cache is not yet ported to paddle_tpu_torch, "
                "see ROADMAP.md")
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
        self.metrics = metrics if metrics is not None else ServingMetrics(
            slo=SLOAttainment(ttft_ms=slo_ttft_ms, tpot_ms=slo_tpot_ms,
                              window_s=slo_window_s))
        self.engine = create_decode_engine(
            model, device=self.device, scheduler=self.scheduler,
            on_complete=self._on_complete, tracer=self.tracer,
            **engine_kwargs)
        self.max_new_tokens_cap = int(max_new_tokens_cap)
        self.poll_interval_s = float(poll_interval_s)
        self.max_engine_errors = int(max_engine_errors)
        self._consec_errors = 0
        self._failed = False
        self.metrics.set_gauge_fn(self._gauges)
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
        self.port: Optional[int] = None

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

    def _engine_loop_inner(self) -> None:
        eng = self.engine
        while True:
            self._drain_inbox()
            if (eng.num_queued or eng.num_active) and not self._failed:
                try:
                    before = eng.num_queued + eng.num_active
                    eng.step()
                    after = eng.num_queued + eng.num_active
                    self._consec_errors = 0
                    if after and after == before and not eng.num_active:
                        # queued but nothing admissible: don't hot-spin
                        time.sleep(self.poll_interval_s)
                except Exception:
                    self.metrics.counter("engine_errors_total").add()
                    self._consec_errors += 1
                    try:
                        eng.expire_deadlines()
                        eng.evict_stalled()
                    except Exception:
                        pass
                    if self._consec_errors >= self.max_engine_errors:
                        self._fail_engine()
                    time.sleep(self.poll_interval_s)
                continue
            if self._stopping and self._inbox.empty():
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

    def _fail_engine(self) -> None:
        """Terminal failure: answer every pending request with a typed
        EngineFailed, return the engine's pages, stop admitting."""
        self._failed = True
        self._draining = True
        err = {"error": "EngineFailed",
               "reason": "engine step failed repeatedly"}
        try:
            self.engine.close()
        except Exception:
            pass
        for p in list(self._pending.values()):
            p.outbox.put(dict(err))
            p.outbox.put(None)
        self._pending.clear()

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

            try:
                rid = self.engine.submit(
                    np.asarray(payload["prompt"], np.int32),
                    max_new_tokens=payload["max_new_tokens"],
                    eos_token=payload.get("eos"),
                    priority=payload.get("priority", Priority.NORMAL),
                    deadline_t=payload.get("deadline_t"),
                    on_token=on_token,
                    trace_ctx=payload.get("trace_ctx"))
            except Exception as e:
                # one malformed payload costs that client a BadRequest,
                # never the engine thread
                pending.outbox.put({"error": "BadRequest",
                                    "reason": f"{type(e).__name__}: {e}"})
                pending.outbox.put(None)
                continue
            self._pending[rid] = pending

    def _on_complete(self, req) -> None:
        """Engine callback: terminal state for a request (any state)."""
        self.metrics.observe_request(req)
        self.engine.result(req.req_id, pop=True)
        pending = self._pending.pop(req.req_id, None)
        if pending is None:
            return
        if req.state == "done":
            msg: Dict[str, Any] = {
                "rid": req.req_id, "done": True,
                "tokens": [int(t) for t in req.tokens],
                "generated": [int(t) for t in req.generated],
                "stats": _json_stats(req.stats)}
        elif req.state == "deadline":
            msg = {"rid": req.req_id, "error": "DeadlineExceeded",
                   "reason": "deadline_ms elapsed before completion",
                   "tokens_out": int(req.stats.tokens_out)}
            fors = getattr(req, "page_forensics", None)
            if fors:
                msg["page_forensics"] = fors[-8:]
        elif req.state == "stalled":
            msg = {"rid": req.req_id, "error": "RequestStalled",
                   "reason": f"no token for "
                             f"{self.engine.stall_timeout_s}s; evicted",
                   "tokens_out": int(req.stats.tokens_out)}
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
                  "prefix_cache": None,
                  "step_timeline": eng.step_timeline()[-16:],
                  "programs_launched": dict(eng.programs_launched)})
            return
        if op == "metrics":
            send({"text": self.metrics.prometheus_text()})
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
        if op != "generate":
            send({"error": "BadRequest", "reason": f"unknown op {op!r}"})
            return
        if self._draining:
            send({"error": "ServerDraining",
                  "reason": "server is draining; not admitting"})
            return
        prompt = msg.get("prompt")
        if not isinstance(prompt, list) or not prompt:
            send({"error": "BadRequest",
                  "reason": "prompt must be a non-empty token list"})
            return
        mnt = int(msg.get("max_new_tokens", 16))
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
        pending = _Pending(stream=bool(msg.get("stream", False)))
        with self._admission_lock:
            # submit-time overload gate, atomic with the enqueue
            self.scheduler.check_admission(self.engine.num_queued
                                           + self._inbox.qsize())
            tctx = msg.get("trace")
            if not (isinstance(tctx, dict) and
                    isinstance(tctx.get("id"), str)):
                tctx = None
            self._inbox.put(({"prompt": prompt, "max_new_tokens": mnt,
                              "eos": msg.get("eos"),
                              "priority": int(_PRIORITIES[prio]),
                              "deadline_t": deadline_t,
                              "trace_ctx": tctx}, pending))
        self._wake.set()
        self._await_outbox(pending, send)

    def _await_outbox(self, pending: _Pending, send) -> None:
        """Relay one request's outbox to the client until the None
        sentinel; a fully exited engine thread answers ServerEvicted
        instead of hanging."""
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
            send(out)

    def _health(self) -> Dict:
        eng = self.engine
        return {"status": ("failed" if self._failed else
                           "draining" if self._draining else "ok"),
                "pid": os.getpid(),
                "device": str(self.device),
                "active": eng.num_active,
                "queued": eng.num_queued,
                "page_size": eng.page_size,
                "free_pages": eng.free_pages,
                "num_pages": eng.num_pages,
                "steps": eng.steps,
                "step_ema_ms": (None if eng.decode_ema_s is None
                                else round(eng.decode_ema_s * 1e3, 3)),
                "fused_step": eng.fused_step,
                "kv_int8": eng.kv_int8,
                "trace_sample": self.tracer.sample_rate,
                "uptime_s": round(time.monotonic() - self._t0, 3)}

    def _gauges(self) -> Dict[str, float]:
        eng = self.engine
        occ = eng.allocator.occupancy()
        g = {"inflight_slots": eng.num_active,
             "num_slots": eng.num_slots,
             "queued_requests": eng.num_queued,
             "free_pages": eng.free_pages,
             "num_pages": eng.num_pages,
             "pages_inflight": occ["inflight"],
             "pages_used": eng.num_pages - occ["free"],
             "engine_steps": eng.steps}
        for kind, n in dict(eng.programs_launched).items():
            g[f"programs_launched_{kind}"] = n
        return g

    def _leak_check(self) -> Dict:
        """Engine-thread page audit: with no in-flight work every page
        must be free, and the page ledger must reconcile."""
        eng = self.engine
        led = eng.ledger
        ledger_info = ({"ok": True, "enabled": False} if led is None
                       else led.reconcile(eng.allocator))
        if eng.num_active or eng.num_queued:
            return {"ok": False, "busy": True,
                    "active": eng.num_active, "queued": eng.num_queued}
        try:
            eng.check_no_leak()
        except RuntimeError as e:
            return {"ok": False, "busy": False,
                    "error": type(e).__name__, "reason": str(e),
                    "ledger": ledger_info}
        return {"ok": True, "busy": False, "free_pages": eng.free_pages,
                "num_pages": eng.num_pages, "ledger": ledger_info}


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


def build_model(name: str, device=None):
    """A seed-0 random-init model of a named config on ``device``."""
    from ..models.gpt import CONFIGS, GPTForCausalLM
    if name not in CONFIGS:
        raise SystemExit(f"unknown --model {name!r}; choose from "
                         f"{sorted(CONFIGS)}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = GPTForCausalLM(CONFIGS[name](), device=dev, generator=gen)
    model.eval()
    return model


def main(argv=None) -> None:
    import argparse
    parser = argparse.ArgumentParser(
        description="paddle_tpu_torch serving front-end (newline-JSON)")
    parser.add_argument("--model", default="gpt_125m")
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
                        help="accepted for compatibility: this port has "
                             "no prefix cache yet")
    parser.add_argument(
        "--max-engine-errors", type=int, default=32,
        help="consecutive engine-step failures before the server fails "
             "typed (EngineFailed)")
    parser.add_argument(
        "--stall-timeout-s", type=float, default=None,
        help="evict a slot that emits no token for this long with a "
             "typed RequestStalled reply (default: watchdog off)")
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
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    model = build_model(args.model, device)
    engine_kwargs = {"num_slots": args.num_slots,
                     "page_size": args.page_size,
                     "kv_int8": args.kv_int8,
                     "fused_step": not args.no_fused_step,
                     "stall_timeout_s": args.stall_timeout_s}
    if args.num_pages is not None:
        engine_kwargs["num_pages"] = args.num_pages
    if args.max_seq_len is not None:
        engine_kwargs["max_seq_len"] = args.max_seq_len
    server = ServingServer(model, host=args.host, port=args.port,
                           max_engine_errors=args.max_engine_errors,
                           trace_sample=args.trace_sample,
                           slo_ttft_ms=args.slo_ttft_ms,
                           slo_tpot_ms=args.slo_tpot_ms,
                           slo_window_s=args.slo_window_s,
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
