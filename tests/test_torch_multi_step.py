"""Multi-step decode in the PyTorch port (``multi_step=N``), on the CPU at
gpt_tiny size with the JAX model's weights (``load_jax_state``),
mirroring the single-server cases of ``tests/test_multi_step_decode.py``:

- greedy tokens of ``multi_step=N`` equal the port's ``multi_step=1``
  and the JAX engine's with the same ``multi_step`` on the same weights
  (fp and int8 pools, the prefix cache, chunked prefill, speculation,
  an EOS at every offset inside a launch);
- one ``decode_multi`` launch per up to N tokens, the streamed order of
  the per-token engine, the per-launch EMA and the deadline gate's
  launch terms, the stall watchdog's drain liveness;
- every exit at a boundary is leak-free (close, deadline, resurrection
  replay onto a rebuilt multi-step engine, bit for bit);
- the timeline's macro records and the server's surface;
- the carry-form stop rules against their JAX twins, and the plain loop
  against the loop forced through all N iterations (what a CUDA graph
  replayed N times runs).
"""

import _torch_threads  # noqa: F401

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.inference import SpeculativeConfig as JaxSpecConfig
from paddle_tpu.inference import create_decode_engine as jax_engine
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.nn import decode as jdecode
from paddle_tpu.serving.prefix_cache import PrefixCache as JaxPrefixCache

from paddle_tpu_torch.core.monitor import StatRegistry
from paddle_tpu_torch.distributed import fault_inject as fi
from paddle_tpu_torch.inference import (SpeculativeConfig,
                                        create_decode_engine)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn import decode as tdecode
from paddle_tpu_torch.serving import (ServingMetrics, ServingServer,
                                      client_request)
from paddle_tpu_torch.serving.prefix_cache import PrefixCache


@pytest.fixture(autouse=True)
def _clean_injector():
    fi.reset()
    yield
    fi.reset()


@pytest.fixture(scope="module")
def models():
    pt.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    tgpt.load_jax_state(tm, jgpt.checkpoint_state(jm))
    return jm, tm


ENGINE_KW = dict(num_slots=2, page_size=8, max_seq_len=64)


def _port(tm, **kw):
    return create_decode_engine(tm, device="cpu", **dict(ENGINE_KW, **kw))


def _jax(jm, **kw):
    return jax_engine(jm, **dict(ENGINE_KW, **kw))


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 1024, n).astype(np.int32)
            for n in (5, 9, 13, 7)]


def _run_stream(eng, mnt=8, eos=None, prompts=None):
    ps = _prompts() if prompts is None else prompts
    rids = [eng.submit(p, max_new_tokens=mnt, eos_token=eos) for p in ps]
    res = eng.run()
    launches = dict(eng.programs_launched)
    eng.close()
    return [res[r].tolist() for r in rids], launches


def _both(models, mnt=8, eos=None, port_kw=None, jax_kw=None, **kw):
    """(port tokens, JAX tokens, port launches) for one configuration;
    ``port_kw`` / ``jax_kw`` add the package-specific arguments."""
    jm, tm = models
    got, launches = _run_stream(_port(tm, **kw, **(port_kw or {})), mnt,
                                eos)
    want, _ = _run_stream(_jax(jm, **kw, **(jax_kw or {})), mnt, eos)
    return got, want, launches


@pytest.fixture(scope="module")
def base(models):
    """The port's per-token engine: the reference of every case."""
    _, tm = models
    return _run_stream(_port(tm, multi_step=1))[0]


# ---------------------------------------------------------------------------
# Bit identity
# ---------------------------------------------------------------------------

class TestBitIdentity:
    @pytest.mark.parametrize("n", [2, 4, 7])
    def test_fp_pages(self, models, base, n):
        got, want, _ = _both(models, multi_step=n)
        assert got == base, f"multi_step={n} diverged from multi_step=1"
        assert got == want, f"multi_step={n} diverged from the JAX engine"

    @pytest.mark.parametrize("off", range(4))
    def test_eos_mid_macro_every_offset(self, models, base, off):
        """An EOS at every offset of a 4-iteration launch stops the slot
        where the per-token engine stops it."""
        _, tm = models
        plen = len(_prompts()[0])
        eos = base[0][plen + 1 + off]
        a, _ = _run_stream(_port(tm, multi_step=1), eos=eos)
        b, want, _ = _both(models, eos=eos, multi_step=4)
        assert a == b == want, f"EOS at macro offset {off} diverged"
        assert len(a[0]) < plen + 8  # the EOS fired early

    def test_int8_pages(self, models):
        _, tm = models
        a, _ = _run_stream(_port(tm, multi_step=1, kv_int8=True))
        b, want, _ = _both(models, multi_step=4, kv_int8=True)
        assert a == b == want

    def test_prefix_cache_on(self, models, base):
        got, want, _ = _both(
            models, multi_step=4,
            port_kw=dict(prefix_cache=PrefixCache(8)),
            jax_kw=dict(prefix_cache=JaxPrefixCache(8)))
        assert got == base == want

    def test_chunked_prefill(self, models):
        _, tm = models
        a, _ = _run_stream(_port(tm, multi_step=1, prefill_chunk_tokens=8))
        b, want, _ = _both(models, multi_step=4, prefill_chunk_tokens=8)
        assert a == b == want

    def test_speculative_composes(self, models, base):
        """The n-gram draft has a device twin, so its verify runs inside
        the launch; the tokens stay the vanilla engine's."""
        got, want, launches = _both(
            models, multi_step=4,
            port_kw=dict(speculative=SpeculativeConfig(k=2,
                                                       draft="ngram")),
            jax_kw=dict(speculative=JaxSpecConfig(k=2, draft="ngram")))
        assert got == base == want
        assert "verify" not in launches

    def test_multi_step_validation(self, models):
        _, tm = models
        with pytest.raises(ValueError, match="multi_step"):
            _port(tm, multi_step=0)


# ---------------------------------------------------------------------------
# Launch counts
# ---------------------------------------------------------------------------

class TestLaunchCounts:
    def test_decode_launches_strictly_reduced(self, models, base):
        _, tm = models
        _, l1 = _run_stream(_port(tm, multi_step=1))
        multi, l4 = _run_stream(_port(tm, multi_step=4))
        assert multi == base
        tokens = sum(len(s) for s in base) - sum(
            len(p) for p in _prompts())
        assert l1["decode"] > l4.get("decode", 0) + l4["decode_multi"]
        # one launch per up to 4 tokens (each prefill emits the first)
        assert l4["decode_multi"] <= -(-tokens // 4) + 1
        assert "decode" not in l4  # the per-token step never ran

    def test_step_programs_records_macro_kind(self, models):
        _, tm = models
        eng = _port(tm, multi_step=4)
        for p in _prompts()[:2]:
            eng.submit(p, max_new_tokens=6)
        eng.run()
        # on the CPU: the operators one iteration dispatches
        assert eng.step_programs.get("decode_multi", 0) > 0
        assert eng.macro_launches > 0
        assert eng.programs_launched["decode_multi"] == eng.macro_launches
        eng.close()


# ---------------------------------------------------------------------------
# Streaming order
# ---------------------------------------------------------------------------

def _stream(eng, mnt=8):
    toks = []
    for p in _prompts():
        eng.submit(p, max_new_tokens=mnt,
                   on_token=lambda rid, t, d: toks.append((rid, int(t),
                                                           bool(d))))
    eng.run()
    eng.close()
    return toks


class TestStreaming:
    def test_on_token_order_identical(self, models):
        """The (step, slot) interleave, done flags included, equals the
        per-token engine's and the JAX multi-step engine's."""
        jm, tm = models
        want = _stream(_port(tm, multi_step=1))
        assert _stream(_port(tm, multi_step=4)) == want
        assert _stream(_jax(jm, multi_step=4)) == want

    def test_single_token_requests(self, models):
        _, tm = models
        assert _stream(_port(tm, multi_step=1), mnt=1) == \
            _stream(_port(tm, multi_step=4), mnt=1)


# ---------------------------------------------------------------------------
# The per-launch EMA, the deadline gate, the stall watchdog
# ---------------------------------------------------------------------------

class TestMacroEma:
    def test_ema_tracked_per_macro_launch(self, models):
        _, tm = models
        eng = _port(tm, multi_step=4)
        for p in _prompts()[:2]:
            eng.submit(p, max_new_tokens=8)
        eng.run()
        assert eng.macro_launches >= 2
        assert eng.decode_ema_s is not None
        eng.close()

    def test_deadline_gate_charges_launches_not_tokens(self, models):
        """``decode_ema_s`` times one launch: 8 tokens at N=4 are 2
        launches, 16 are 4."""
        _, tm = models
        eng = _port(tm, multi_step=4)
        eng.decode_ema_s = 1.0  # seconds a launch
        now = time.monotonic()
        eng.submit(_prompts()[0], max_new_tokens=8, deadline_t=now + 2.5)
        queued = eng._queue[-1]
        assert not eng._deadline_hopeless(queued, now)
        queued.max_new_tokens = 16
        assert eng._deadline_hopeless(queued, now)
        eng.close()

    def test_deadline_gate_in_program_chunks(self, models):
        """In-program chunks ride launches, N a launch: a 40-token prompt
        at chunk 8 is 5 chunks, 2 launches at N=4."""
        _, tm = models
        eng = _port(tm, multi_step=4, prefill_chunk_tokens=8)
        eng.decode_ema_s = 1.0
        now = time.monotonic()
        eng.submit(np.arange(1, 41, dtype=np.int32), max_new_tokens=4,
                   deadline_t=now + 3.5)
        queued = eng._queue[-1]
        # 1 launch for 4 tokens + 2 launches for 5 chunks = 3.0 s
        assert not eng._deadline_hopeless(queued, now)
        queued.deadline_t = now + 2.5
        assert eng._deadline_hopeless(queued, now)
        eng.close()

    def test_stall_watchdog_multi_step_aware(self, models):
        _, tm = models
        eng = _port(tm, multi_step=4, stall_timeout_s=0.05)
        eng.submit(_prompts()[0], max_new_tokens=32)
        eng.step()  # admit + prefill + dispatch the first launch
        eng.step()  # drain + dispatch (sets _last_macro_t)
        req = next(r for r in eng._slots if r is not None)
        stale = time.monotonic() - 10.0
        req.last_emit_t = stale
        req.stats.admit_t = stale
        eng._last_macro_t = time.monotonic()
        assert eng.evict_stalled() == []  # the drains are fresh
        assert req.state == "decoding"
        eng.run()
        eng.submit(_prompts()[1], max_new_tokens=8)
        eng.step()
        eng._flush_macro()
        req2 = next(r for r in eng._slots if r is not None)
        req2.last_emit_t = stale
        req2.stats.admit_t = stale
        eng._last_macro_t = stale
        out = eng.evict_stalled()
        assert [r.state for r in out] == ["stalled"]
        assert eng.allocator.reserved_total == 0
        eng.close()


# ---------------------------------------------------------------------------
# Leak-free exits at a boundary
# ---------------------------------------------------------------------------

class TestLeakAudits:
    def test_growth_reservation_lifecycle(self, models):
        """Admission reserves the growth, each launch binds its pages
        out of it (ledger reason ``macro_grow``), every exit returns
        both."""
        _, tm = models
        eng = _port(tm, multi_step=4)
        eng.submit(_prompts()[0], max_new_tokens=32)
        eng.step()
        assert eng.allocator.reserved_total > 0
        eng.run()
        reasons = {e.get("reason") for e in eng.ledger.tail(4096)}
        assert "macro_grow" in reasons
        eng.close()
        eng.allocator.check_no_leak()

    def test_mid_flight_close(self, models):
        _, tm = models
        eng = _port(tm, multi_step=4)
        for p in _prompts():
            eng.submit(p, max_new_tokens=16)
        eng.step()
        eng.step()  # a launch is in flight
        assert eng._pending_macro is not None
        eng.close()
        eng.allocator.check_no_leak()

    def test_deadline_eviction_mid_macro(self, models):
        _, tm = models
        states = []
        eng = _port(tm, multi_step=4,
                    on_complete=lambda r: states.append(r.state))
        eng.submit(_prompts()[0], max_new_tokens=32,
                   deadline_t=time.monotonic() + 0.01)
        eng.step()
        time.sleep(0.02)
        eng.step()  # the boundary sweep evicts it typed
        assert "deadline" in states
        assert eng.num_active == 0
        eng.close()
        eng.allocator.check_no_leak()

    def test_streamed_tokens_precede_completion(self, models):
        _, tm = models
        events = []
        eng = _port(tm, multi_step=4,
                    on_complete=lambda r: events.append(("done",
                                                         r.req_id)))
        for p in _prompts()[:2]:
            eng.submit(p, max_new_tokens=8,
                       on_token=lambda rid, t, d: events.append(
                           ("tok", rid)))
        eng.run()
        eng.close()
        for rid in (0, 1):
            toks = [i for i, e in enumerate(events) if e == ("tok", rid)]
            done = events.index(("done", rid))
            assert all(i < done for i in toks)
            assert len(toks) == 8

    def test_dump_inflight_replays_bit_identical(self, models):
        """State dumped at a boundary replays onto a rebuilt
        ``multi_step=4`` engine (prompt + emitted tokens, one prefill)
        to the uninterrupted per-token run's tokens."""
        _, tm = models
        base, _ = _run_stream(_port(tm, multi_step=1), mnt=12)
        eng = _port(tm, multi_step=4)
        for p in _prompts():
            eng.submit(p, max_new_tokens=12)
        for _ in range(2):
            eng.step()
        snap = eng.dump_inflight()  # drains the launch in flight
        states = {r.req_id: r.state for r in snap}
        assert "decoding" in states.values()
        assert "queued" in states.values()
        pre = {r.req_id: ([int(t) for t in r.prompt],
                          [int(t) for t in r.generated],
                          r.max_new_tokens) for r in snap}
        eng.close()
        eng.allocator.check_no_leak()
        eng2 = _port(tm, multi_step=4)
        new_rids = {}
        for old_rid, (prompt, gen, mnt) in sorted(pre.items()):
            new_rids[old_rid] = eng2.submit(
                np.asarray(prompt + gen, np.int32),
                max_new_tokens=mnt - len(gen))
        res = eng2.run()
        eng2.close()
        for old_rid in sorted(pre):
            prompt, gen, _mnt = pre[old_rid]
            full = prompt + gen + [
                int(t) for t in
                res[new_rids[old_rid]][len(prompt) + len(gen):]]
            assert full == base[old_rid], \
                f"replay diverged for req {old_rid}"

    def test_release_device_drops_the_macro_state(self, models):
        _, tm = models
        eng = _port(tm, multi_step=4)
        eng.submit(_prompts()[0], max_new_tokens=8)
        eng.run()
        assert eng._macro is not None
        eng.close()
        eng.release_device()
        assert eng._macro is None and eng._pools is None


# ---------------------------------------------------------------------------
# Observability
# ---------------------------------------------------------------------------

class TestObservability:
    def test_timeline_marks_macro_launches(self, models):
        _, tm = models
        eng = _port(tm, multi_step=4)
        for p in _prompts()[:2]:
            eng.submit(p, max_new_tokens=8)
        eng.run()
        macros = [e["macro"] for e in eng.step_timeline()
                  if "macro" in e]
        assert macros, "no macro records on the timeline"
        for m in macros:
            assert 1 <= m["steps"] <= 4
            assert m["steps"] + m["masked_steps"] == 4
            assert m["tokens"] == sum(m["per_step_tokens"])
            assert m["overlap_idle_ms"] >= 0.0
        rows = [r for r in eng.per_token_timeline()
                if "macro_launch" in r]
        assert sum(r["tokens"] for r in rows) == \
            sum(m["tokens"] for m in macros)
        assert len(rows) == sum(m["steps"] for m in macros)
        eng.close()


# ---------------------------------------------------------------------------
# The serving surface
# ---------------------------------------------------------------------------

def _server(tm, **kw):
    kw.setdefault("metrics", ServingMetrics(registry=StatRegistry()))
    return ServingServer(tm, device="cpu", prefix_cache=False,
                         **dict(ENGINE_KW, **kw))


class TestServingSurface:
    def test_server_health_metrics_and_stream(self, models):
        jm, tm = models
        ref, _ = _run_stream(_jax(jm, multi_step=4), mnt=8,
                             prompts=[np.array([3, 1, 4, 1, 5], np.int32)])
        srv = _server(tm, multi_step=4)
        port = srv.start()
        try:
            toks = []
            rep = client_request("127.0.0.1", port, {
                "op": "generate", "prompt": [3, 1, 4, 1, 5],
                "max_new_tokens": 8, "stream": True},
                on_token=toks.append)
            assert "error" not in rep, rep
            assert toks == rep["generated"] == ref[0][5:]
            h = client_request("127.0.0.1", port, {"op": "health"})
            assert h["multi_step"] == 4
            assert h["macro_launches"] >= 2
            s = client_request("127.0.0.1", port, {"op": "stats"})
            assert s["multi_step"] == 4
            assert s["step_programs"]["decode_multi"] > 0
            mx = client_request("127.0.0.1", port,
                                {"op": "metrics"})["text"]
            assert "serving_steps_per_launch" in mx
            assert "serving_host_overlap_idle_ms" in mx
            line = [ln for ln in mx.splitlines()
                    if ln.startswith("serving_macro_steps_total")]
            assert line and int(float(line[0].split()[-1])) >= 2
            chk = client_request("127.0.0.1", port, {"op": "leak_check"})
            assert chk["ok"], chk
        finally:
            srv.stop()

    def test_recipe_threads_through_rebuild(self, models):
        _, tm = models
        srv = _server(tm, multi_step=4)
        try:
            assert srv.engine.multi_step == 4
            assert srv._engine_kwargs.get("multi_step") == 4
            rebuilt = srv._build_engine()
            assert rebuilt.multi_step == 4
            rebuilt.close()
        finally:
            srv.stop()

    def test_cli_flag_reaches_the_engine_kwargs(self, monkeypatch):
        from paddle_tpu_torch.serving import server as srv_mod
        made = {}

        class Stop(Exception):
            pass

        class Fake:
            def __init__(self, model, **kw):
                made.update(kw)

            def start(self):
                raise Stop

        monkeypatch.setattr(srv_mod, "ServingServer", Fake)
        monkeypatch.setattr(srv_mod, "build_model", lambda name, dev: None)
        with pytest.raises(Stop):
            srv_mod.main(["--device", "cpu", "--multi-step", "8"])
        assert made["multi_step"] == 8
        made.clear()
        with pytest.raises(Stop):
            srv_mod.main(["--device", "cpu"])
        assert "multi_step" not in made

    def test_resurrection_replays_onto_multi_step_engine(self, models):
        """Two failed steps once both requests hold tokens: one
        resurrection onto a rebuilt multi-step engine, streams without
        gap or duplicate, finals equal the JAX multi-step engine's, no
        leak."""
        jm, tm = models
        prompts = [list(range(1, 7)), list(range(3, 12))]
        # 24 tokens: six launches, so the second request is admitted
        # while the first still decodes however the clients are paced
        mnt = 24
        ref, _ = _run_stream(_jax(jm, multi_step=4), mnt=mnt,
                             prompts=[np.asarray(p, np.int32)
                                      for p in prompts])
        expected = [r[len(p):] for r, p in zip(ref, prompts)]
        met = ServingMetrics(registry=StatRegistry())
        srv = _server(tm, multi_step=4, metrics=met, max_engine_errors=2)
        eng = srv.engine
        step = eng.step

        def arming_step():
            # read the slots without draining: the launch stays in flight
            live = [r for r in eng._slots if r is not None]
            if not fi.get_injector().armed("engine.step") and \
                    len(live) == 2 and all(r.generated for r in live):
                fi.get_injector().arm("engine.step", at_calls=[1, 2])
            return step()

        eng.step = arming_step
        port = srv.start()
        outs = [None, None]
        toks = [[], []]

        def client(i):
            outs[i] = client_request(
                "127.0.0.1", port,
                {"op": "generate", "prompt": prompts[i],
                 "max_new_tokens": mnt, "stream": True},
                timeout_s=180.0, on_token=toks[i].append)

        try:
            ts = [threading.Thread(target=client, args=(i,))
                  for i in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=180)
            for i in range(2):
                assert outs[i] is not None, "client hung"
                assert "error" not in outs[i], outs[i]
                assert outs[i]["generated"] == expected[i]
                assert toks[i] == expected[i]  # no duplicate, no gap
            assert srv.engine is not eng
            assert srv.engine.multi_step == 4
            assert met.snapshot()["counters"]["engine_restarts_total"] == 1
            chk = client_request("127.0.0.1", port, {"op": "leak_check"})
            assert chk["ok"], chk
        finally:
            srv.stop()
        srv.engine.allocator.check_no_leak()


# ---------------------------------------------------------------------------
# The carry-form stop rules and the two loops
# ---------------------------------------------------------------------------

def _carry_case(seed, b=6):
    rng = np.random.default_rng(seed)
    nxt = rng.integers(0, 5, b).astype(np.int32)
    cur = rng.integers(0, 5, b).astype(np.int32)
    active = rng.random(b) < 0.7
    emitted = rng.integers(0, 4, b).astype(np.int32)
    rem = rng.integers(1, 6, b).astype(np.int32)
    eos = np.where(rng.random(b) < 0.5, rng.integers(0, 5, b),
                   -1).astype(np.int32)
    return nxt, cur, active, emitted, rem, eos


@pytest.mark.parametrize("seed", range(6))
def test_masked_carry_advance_matches_jax(seed):
    args = _carry_case(seed)
    want = jdecode.masked_carry_advance(*(jnp.asarray(a) for a in args))
    got = tdecode.masked_carry_advance(*(torch.from_numpy(a)
                                         for a in args))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(6))
def test_masked_run_advance_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    b, w = 6, 4
    run = rng.integers(0, 4, (b, w)).astype(np.int32)
    run_len = rng.integers(1, w + 1, b).astype(np.int32)
    _n, cur, active, emitted, _r, eos = _carry_case(seed, b)
    rem = (emitted + rng.integers(1, 6, b)).astype(np.int32)
    args = (run, run_len, cur, active, emitted, rem, eos)
    want = jdecode.masked_run_advance(*(jnp.asarray(a) for a in args))
    got = tdecode.masked_run_advance(*(torch.from_numpy(a) for a in args))
    for g, w_ in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w_))


def _decode_fixture(tm, b=3, page=8, pages=24):
    cfg = tm.config
    mp = cfg.max_seq_len // page
    protos = [tgpt.paged_cache_create(1, pages, page, cfg.num_heads,
                                      cfg.head_dim, torch.float32, mp,
                                      device="cpu")
              for _ in range(cfg.num_layers)]
    pools = {"k": [p.k_pages for p in protos],
             "v": [p.v_pages for p in protos]}
    table = torch.full((b, mp), pages, dtype=torch.int32)
    for i in range(b):
        table[i, :6] = torch.arange(6 * i, 6 * i + 6, dtype=torch.int32)
    w, ty, _ = tm.head_params()

    def caches(t, ln):
        return [tgpt.PagedKVCache(pools["k"][i], pools["v"][i], None, None,
                                  t, ln) for i in range(cfg.num_layers)]

    def step(t, ln, c):
        h, _ = tm.decode_hidden(c[:, None], caches(t, ln), fused=True)
        return tdecode.fused_sample_token(h[:, -1].contiguous(), w, 0.0,
                                          transpose_y=ty)

    def verify(t, ln, toks, valid):
        h, _ = tm.decode_hidden(toks, caches(t, ln), prefill_lens=valid,
                                prefill_chained=True, fused=True)
        return tdecode.fused_verify_tokens(h, toks[:, 1:], w, 0.0,
                                           transpose_y=ty)

    def prefill(trow, ln, plen, ids):
        h, _ = tm.decode_hidden(ids, caches(trow, ln), prefill_lens=plen,
                                prefill_chained=True, fused=True)
        last = torch.clamp_min(plen.long() - 1, 0)
        return tdecode.fused_sample_token(h[0].index_select(0, last), w,
                                          0.0, transpose_y=ty)

    # a stored prefix of 5 + 3i tokens a slot (slot 2: 16 tokens, of
    # which the chunk test stores 8 and leaves 8 to its chunk)
    rng = np.random.default_rng(7)
    lens = torch.tensor([5, 8, 8], dtype=torch.int32)
    hist = torch.zeros((b, cfg.max_seq_len), dtype=torch.int32)
    with torch.no_grad():
        for i in range(b):
            n = int(lens[i])
            ids = torch.from_numpy(rng.integers(0, 1024, (1, n)).astype(
                np.int32))
            hist[i, :n] = ids[0]
            tm.decode_hidden(ids, caches(table[i:i + 1],
                                         torch.zeros(1, dtype=torch.int32)),
                             prefill_lens=torch.tensor([n],
                                                       dtype=torch.int32),
                             fused=True)
    return pools, table, lens, hist, step, verify, prefill, pages


@pytest.mark.parametrize("variant", ["plain", "spec", "chunk"])
def test_full_loop_equals_early_exit(models, variant):
    """The loop forced through all N iterations (a graph replayed N
    times) ends with the same ring, lengths, tokens, mask, count and
    pools as the loop that stops once every slot has stopped; the
    iterations after that wrote only the scratch page."""
    _, tm = models
    outs = []
    for full in (False, True):
        pools, table, lens, hist, step, verify, prefill, scratch = \
            _decode_fixture(tm)
        cur = torch.tensor([11, 12, 0], dtype=torch.int32)
        active = torch.tensor([True, True, False])
        rem = torch.tensor([3, 5, 4], dtype=torch.int32)
        eos = torch.full((3,), -1, dtype=torch.int32)
        spec = chunk = None
        if variant == "spec":
            spec = {"k": 2, "vocab": 1024, "verify_fn": verify,
                    "draft_fn": lambda h, hl, c: tdecode.ngram_draft_tokens(
                        h, hl, 2),
                    "hist": hist, "hist_len": lens.clone()}
        if variant == "chunk":
            ids = np.zeros((8, 8), np.int32)
            ids[0] = np.arange(100, 108)
            chunk = {"prefill_fn": prefill, "count": 1, "slot": 2,
                     "ids": torch.from_numpy(ids),
                     "valid": torch.tensor([8] + [0] * 7,
                                           dtype=torch.int32),
                     "start": torch.tensor([8] + [0] * 7,
                                           dtype=torch.int32),
                     "final": torch.tensor([True] + [False] * 7)}
        with torch.no_grad():
            ring, steps, cur_f, lens_f, act_f, _ = tgpt.multi_step_decode(
                step, pools, table, lens, cur, active, rem, eos, 8,
                scratch, spec=spec, chunk=chunk, full=full)
        real = [t[:scratch] for t in pools["k"] + pools["v"]]
        outs.append((ring.clone(), int(steps), cur_f.clone(),
                     lens_f.clone(), act_f.clone(), real))
    (r0, s0, c0, l0, a0, p0), (r1, s1, c1, l1, a1, p1) = outs
    assert s0 == s1 < 8  # the early-exit loop stopped early
    assert torch.equal(r0, r1) and torch.equal(c0, c1)
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    assert all(torch.equal(x, y) for x, y in zip(p0, p1))
    assert not bool(a0.any())


def test_graph_runner_needs_a_card():
    from paddle_tpu_torch.inference.graphs import IterationGraphs
    with pytest.raises(ValueError, match="CUDA"):
        IterationGraphs(torch.device("cpu"), ())


def test_add_launches_counts_replays():
    from paddle_tpu_torch.ops import kernels
    before = kernels.launch_counts()
    kernels.add_launches({"paged_decode": 2, "fused_argmax": 1}, 3)
    after = kernels.launch_counts()
    assert after["paged_decode"] - before["paged_decode"] == 6
    assert after["fused_argmax"] - before["fused_argmax"] == 3
    kernels.add_launches({"paged_decode": 2, "fused_argmax": 1}, -3)
    assert kernels.launch_counts() == before
