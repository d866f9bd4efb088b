"""Chunked prefill in the PyTorch port (``prefill_chunk_tokens``), on the
CPU at gpt_tiny size, mirroring ``tests/test_chunked_prefill.py``:

- chunked greedy tokens equal whole prefill's bit for bit (chunk sizes 8
  and 16, one chunk, the prefix cache and a chunk boundary against a
  shared prefix, speculation, int8 pools) and the JAX chunked engine's
  on the same weights;
- every exit of a half-prefilled slot (deadline, stall, close, a failed
  chunk) returns its pages, pins and reservation;
- a resurrection replay of a request killed mid-chunks equals the
  uninterrupted run;
- the split EMAs, the deadline gate's chunk term and the per-class debt
  cap; the server with ``prefill_chunk_tokens``.
"""

import _torch_threads  # noqa: F401

import threading
import time

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.inference import create_decode_engine as jax_engine
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch.core.monitor import StatRegistry
from paddle_tpu_torch.distributed import fault_inject as fi
from paddle_tpu_torch.inference import (DecodeRequest, SpeculativeConfig,
                                        create_decode_engine)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.serving.prefix_cache import PrefixCache
from paddle_tpu_torch.serving.scheduler import (Priority, SLOConfig,
                                                SLOScheduler)
from paddle_tpu_torch.serving.server import ServingServer, client_request


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


# gpt_tiny's max_seq_len is 128: room for multi-chunk prompts
ENGINE_KW = dict(num_slots=3, page_size=8, max_seq_len=128)


def _engine(tm, **kw):
    return create_decode_engine(tm, device="cpu", **dict(ENGINE_KW, **kw))


def _prompts(rng=None, lens=(5, 21, 40, 13, 33)):
    rng = rng or np.random.default_rng(0)
    return [rng.integers(0, 1024, (n,)).astype(np.int32) for n in lens]


def _run_stream(tm, prompts, max_new=10, **kw):
    eng = _engine(tm, **kw)
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    out = eng.run()
    res = [out[r].tolist() for r in rids]
    eng.close()
    if kw.get("prefix_cache") is None:
        eng.allocator.check_no_leak()
    return res


@pytest.fixture(scope="module")
def whole(models):
    _, tm = models
    return _run_stream(tm, _prompts())


# -- bit identity: chunked against whole --------------------------------------

@pytest.mark.parametrize("chunk", [8, 16])
def test_bit_identical_across_chunk_sizes(models, whole, chunk):
    """More requests than slots, so recycling and mid-flight admission
    are live; 16 does not divide the prompt lengths (ragged last
    chunks)."""
    _, tm = models
    assert _run_stream(tm, _prompts(), prefill_chunk_tokens=chunk) == whole


def test_single_chunk_matches_whole_prefill_exactly(models):
    """A prompt that fits one chunk takes the whole prefill's dense
    launch: the same pool bytes, not only the same tokens."""
    _, tm = models
    prompt = _prompts(lens=(13,))[0]
    pools = {}
    for chunk in (None, 16):
        eng = _engine(tm, num_slots=1, prefill_chunk_tokens=chunk)
        eng.submit(prompt, max_new_tokens=1)
        eng.step()
        pools[chunk] = [t.clone() for t in eng._pools["k"] + eng._pools["v"]]
        assert eng.programs_launched == {"prefill": 1}
        eng.close()
    assert all(a.equal(b) for a, b in zip(pools[None], pools[16]))
    prompts = _prompts(lens=(5, 9, 13))
    assert _run_stream(tm, prompts, prefill_chunk_tokens=16) == \
        _run_stream(tm, prompts)


def test_prefix_cache_bit_identical(models):
    _, tm = models
    shared = (np.arange(19, dtype=np.int32) * 5) % 100
    prompts = [np.concatenate(
        [shared, (np.arange(t, dtype=np.int32) + 3 * t) % 100])
        for t in (3, 6, 9, 26)]
    ref = _run_stream(tm, prompts, max_new=12)
    pc = PrefixCache(8)
    eng = _engine(tm, prefix_cache=pc, prefill_chunk_tokens=16)
    rids = [eng.submit(p, max_new_tokens=12) for p in prompts]
    out = eng.run()
    assert pc.hit_pages > 0
    assert [out[r].tolist() for r in rids] == ref
    eng.close()
    eng.allocator.check_no_leak()


def test_chunk_boundary_against_shared_prefix(models):
    """A page-aligned (not chunk-aligned) cache hit shifts every later
    chunk boundary; the tokens still equal the uncached whole run."""
    _, tm = models
    base = (np.arange(40, dtype=np.int32) * 7) % 100
    prompts = [base,
               np.concatenate([base[:11],
                               (np.arange(13, dtype=np.int32) + 50) % 100]),
               base[:33]]
    ref = _run_stream(tm, prompts, max_new=8)
    pc = PrefixCache(8)
    eng = _engine(tm, prefix_cache=pc, prefill_chunk_tokens=16)
    outs = []
    for p in prompts:  # one at a time, so later prompts hit the cache
        rid = eng.submit(p, max_new_tokens=8)
        outs.append(eng.run()[rid].tolist())
    assert pc.hit_pages > 0
    assert outs == ref
    eng.close()


def test_speculative_bit_identical(models):
    _, tm = models
    prompts = _prompts(lens=(5, 21, 40))
    ref = _run_stream(tm, prompts, speculative=SpeculativeConfig(k=3))
    assert ref == _run_stream(tm, prompts)
    assert _run_stream(tm, prompts, speculative=SpeculativeConfig(k=3),
                       prefill_chunk_tokens=16) == ref


def test_int8_bit_identical(models):
    _, tm = models
    prompts = _prompts(lens=(5, 21, 40))
    assert _run_stream(tm, prompts, kv_int8=True,
                       prefill_chunk_tokens=16) == \
        _run_stream(tm, prompts, kv_int8=True)


def test_chunked_engine_matches_jax_chunked_engine(models, whole):
    jm, tm = models
    eng = jax_engine(jm, prefill_chunk_tokens=16, **ENGINE_KW)
    rids = [eng.submit(p, max_new_tokens=10) for p in _prompts()]
    out = eng.run()
    eng.close()
    want = [np.asarray(out[r]).tolist() for r in rids]
    assert _run_stream(tm, _prompts(), prefill_chunk_tokens=16) == want
    assert want == whole


def test_invalid_chunk_size_rejected(models):
    _, tm = models
    with pytest.raises(ValueError, match="multiple of page_size"):
        _engine(tm, prefill_chunk_tokens=12)  # page_size is 8
    with pytest.raises(ValueError, match="multiple of page_size"):
        _engine(tm, prefill_chunk_tokens=0)


# -- half-prefilled slots: every exit returns everything -----------------------

_LONG = (np.arange(96, dtype=np.int32) * 3) % 100


def _partial_engine(tm, **kw):
    """One step in: the long prompt is admitted and one chunk landed."""
    done = []
    eng = _engine(tm, prefill_chunk_tokens=16, on_complete=done.append,
                  **kw)
    rid = eng.submit(_LONG, max_new_tokens=4)
    eng.step()
    req = next(r for r in eng._slots if r is not None)
    assert req.req_id == rid and req.state == "prefill_partial"
    assert 0 < req.prefill_done_len < len(_LONG)
    return eng, req, done


def test_deadline_expiry_returns_pages(models):
    _, tm = models
    eng, req, done = _partial_engine(tm)
    req.deadline_t = time.monotonic() - 1.0
    expired = eng.expire_deadlines()
    assert [r.req_id for r in expired] == [req.req_id]
    assert req.state == "deadline" and req.done
    assert req.stats.tokens_out == 0 and req.prefill_done_len == 0
    assert done and done[0] is req
    eng.allocator.check_no_leak()


def test_deadline_expiry_returns_spec_reservation(models):
    _, tm = models
    eng, req, _ = _partial_engine(tm, speculative=SpeculativeConfig(k=3))
    assert eng.allocator.reserved(req.req_id) > 0
    req.deadline_t = time.monotonic() - 1.0
    eng.expire_deadlines()
    assert req.state == "deadline" and eng.allocator.reserved_total == 0
    eng.allocator.check_no_leak()


def test_stall_eviction_half_prefilled(models):
    _, tm = models
    eng, req, _ = _partial_engine(tm, stall_timeout_s=30.0)
    assert eng.evict_stalled() == []  # the chunk that landed is liveness
    out = eng.evict_stalled(now=req.last_emit_t + 31.0)
    assert [r.req_id for r in out] == [req.req_id]
    assert req.state == "stalled"
    eng.allocator.check_no_leak()


def test_waiting_partial_not_stalled_while_chunks_land(models):
    _, tm = models
    eng = _engine(tm, prefill_chunk_tokens=16, stall_timeout_s=30.0)
    eng.submit(_LONG, max_new_tokens=4)
    rid_b = eng.submit((_LONG + 1) % 100, max_new_tokens=4)
    eng.step()  # both admitted; only the first gets a chunk
    b = next(r for r in eng._slots if r is not None and r.req_id == rid_b)
    assert b.state == "prefill_partial" and b.prefill_done_len == 0
    b.stats.admit_t -= 100.0
    assert eng.evict_stalled() == []
    out = eng.evict_stalled(now=eng._last_chunk_t + 31.0)
    assert rid_b in [r.req_id for r in out]
    eng.close()
    eng.allocator.check_no_leak()


def test_close_mid_prefill(models):
    _, tm = models
    eng, req, _ = _partial_engine(tm)
    eng.close()  # asserts check_no_leak itself
    assert req.state == "evicted"


def test_deadline_with_prefix_cache_pins_released(models):
    _, tm = models
    pc = PrefixCache(8)
    eng = _engine(tm, prefix_cache=pc, prefill_chunk_tokens=16)
    seed = (np.arange(40, dtype=np.int32) * 3) % 100
    eng.submit(seed, max_new_tokens=2)
    eng.run()
    assert pc.total_pages() > 0
    rid = eng.submit(np.concatenate([seed, seed[:30] + 1]), max_new_tokens=4)
    eng.step()
    req = next(r for r in eng._slots if r is not None)
    assert req.req_id == rid and req.state == "prefill_partial"
    assert req.cache_keys
    req.deadline_t = time.monotonic() - 1.0
    eng.expire_deadlines()
    assert req.state == "deadline" and req.cache_keys == ()
    assert pc.evictable_pages() == pc.total_pages()
    pc.check_consistent(eng.allocator)
    eng.close()


def test_chunk_failure_unwinds_and_fails_typed(models):
    _, tm = models
    done = []
    eng = _engine(tm, prefill_chunk_tokens=16, max_prefill_attempts=3,
                  on_complete=done.append)
    eng.submit(_LONG, max_new_tokens=4)
    fi.get_injector().arm("serving.prefill", probability=1.0)
    for _ in range(3):
        with pytest.raises(fi.InjectedFault):
            eng.step()
    assert done and done[0].state == "failed"
    assert done[0].stats.prefill_attempts == 3
    assert eng.num_active == 0 and eng.num_queued == 0
    eng.allocator.check_no_leak()


def test_failure_after_progress_restarts_from_scratch(models):
    _, tm = models
    long_p = (np.arange(70, dtype=np.int32) * 3) % 100
    ref = _run_stream(tm, [long_p], max_new=6)[0]
    eng = _engine(tm, prefill_chunk_tokens=16)
    rid = eng.submit(long_p, max_new_tokens=6)
    eng.step()  # chunk 1 lands
    fi.get_injector().arm("serving.prefill", at_calls=[1])
    with pytest.raises(fi.InjectedFault):
        eng.step()  # chunk 2 faults: full unwind and requeue
    assert [r for r in eng._slots if r is not None] == []
    assert eng.num_queued == 1 and eng._queue[0].prefill_done_len == 0
    assert eng.run()[rid].tolist() == ref
    eng.close()
    eng.allocator.check_no_leak()


def test_dump_inflight_holds_the_half_prefilled_request(models):
    _, tm = models
    eng, req, _ = _partial_engine(tm)
    snap = eng.dump_inflight()
    assert snap == [req] and req.generated == []
    eng.close()


# -- resurrection mid-chunk ---------------------------------------------------

def test_replay_mid_chunked_prefill_bit_identical(models):
    """engine.step dies while the long prompt is mid-chunks: the rebuilt
    engine is chunked too (the recipe carries prefill_chunk_tokens) and
    replays the prompt from scratch; every reply equals the clean run."""
    _, tm = models
    kw = dict(num_slots=2, page_size=8, max_seq_len=128,
              prefill_chunk_tokens=16)
    long_p = [int(x) for x in (np.arange(60) * 3) % 100]
    short_p = [int(x) for x in (np.arange(7) * 5) % 100]

    def serve(arm):
        fi.reset()
        if arm:
            # steps 2 and 3: the long prompt needs 4 chunks
            fi.get_injector().arm("engine.step", at_calls=[2, 3])
        met = ServingMetrics(registry=StatRegistry())
        srv = ServingServer(tm, device="cpu", metrics=met,
                            max_engine_errors=2, prefix_cache=False, **kw)
        # both requests go in before the engine thread steps
        eng = srv.engine
        out = {}
        port = srv.start()
        try:
            def req(name, prompt):
                out[name] = client_request(
                    "127.0.0.1", port, {"op": "generate", "prompt": prompt,
                                        "max_new_tokens": 8})
            ts = [threading.Thread(target=req, args=a)
                  for a in (("short", short_p), ("long", long_p))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            restarts = met.counter("engine_restarts_total").get()
            replays = met.counter("replayed_requests_total").get()
            rebuilt = srv.engine is not eng
            chunk = srv.engine.prefill_chunk_tokens
        finally:
            srv.stop()
        return out, restarts, replays, rebuilt, chunk

    clean, r0, _, _, _ = serve(arm=False)
    crashed, r1, replayed, rebuilt, chunk = serve(arm=True)
    assert r0 == 0 and r1 == 1 and replayed >= 1
    assert rebuilt and chunk == 16
    for name in ("short", "long"):
        assert clean[name].get("done") and crashed[name].get("done")
        assert crashed[name]["tokens"] == clean[name]["tokens"]


# -- split EMAs and the deadline gate ----------------------------------------

def test_both_emas_populate_and_alias(models):
    _, tm = models
    eng = _engine(tm, prefill_chunk_tokens=16)
    eng.submit((np.arange(40, dtype=np.int32) * 3) % 100, max_new_tokens=6)
    eng.run()
    assert eng.decode_ema_s is not None
    assert eng.prefill_chunk_ema_s is not None
    assert eng.step_ema_s == eng.decode_ema_s
    eng.step_ema_s = 0.123
    assert eng.decode_ema_s == 0.123
    assert any("chunk_ms" in e for e in eng.step_timeline())
    eng.close()


def test_chunk_ema_skips_the_first_launch_of_each_kind(models):
    _, tm = models
    eng = _engine(tm, prefill_chunk_tokens=16)
    eng.submit(_LONG, max_new_tokens=2)
    eng.step()  # chunk 1: the first fresh chunk, left out
    assert eng.prefill_chunk_ema_s is None
    eng.step()  # chunk 2: the first chained chunk, left out
    assert eng.prefill_chunk_ema_s is None
    eng.step()  # chunk 3: recorded
    assert eng.prefill_chunk_ema_s is not None
    assert eng.prefill_chunk_ema_s < 1.0
    eng.run()
    eng.close()


def test_hopeless_gate_counts_remaining_chunks(models):
    """6 chunks at 50 ms + 4 steps at 10 ms overshoot 250 ms: shed at
    admission; a one-chunk prompt under a loose deadline is admitted."""
    _, tm = models
    done = []
    eng = _engine(tm, prefill_chunk_tokens=16, on_complete=done.append)
    eng.decode_ema_s = 0.01
    eng.prefill_chunk_ema_s = 0.05
    now = time.monotonic()
    eng.submit(_LONG, max_new_tokens=4, deadline_t=now + 0.25)
    rid_s = eng.submit(np.arange(9, dtype=np.int32), max_new_tokens=4,
                       deadline_t=now + 30.0)
    eng.step()
    assert [r.state for r in done] == ["deadline"]
    assert eng.num_active == 1
    out = eng.run()
    assert len(out[rid_s]) == 9 + 4
    eng.close()
    eng.allocator.check_no_leak()


def test_hopeless_gate_charges_chunks_after_the_cache_hit(models):
    """The chunk term counts the chunks left after the memoized prefix
    match: a cached prompt passes where the same prompt uncached is
    hopeless."""
    _, tm = models
    pc = PrefixCache(8)
    eng = _engine(tm, prefix_cache=pc, prefill_chunk_tokens=16)
    eng.submit(_LONG, max_new_tokens=1)
    eng.run()
    eng.decode_ema_s = 0.01
    eng.prefill_chunk_ema_s = 0.05
    now = time.monotonic()
    # requests built for the gate alone, never submitted
    hit = DecodeRequest(100, _LONG.copy(), 4, deadline_t=now + 0.12)
    miss = DecodeRequest(101, (_LONG + 1) % 100, 4, deadline_t=now + 0.12)
    # 96 tokens, 88 cached: 1 chunk (50 ms) + 4 steps (40 ms) fit 120 ms
    assert not eng._deadline_hopeless(hit, now)
    # nothing cached: 6 chunks (300 ms) do not
    assert eng._deadline_hopeless(miss, now)
    eng.close()


# -- the scheduler's chunk budget and the debt cap -----------------------------

def test_debt_gauge_and_per_class_cap(models):
    _, tm = models
    sched = SLOScheduler(SLOConfig(promote_after_s=1e9, shed_after_s=None,
                                   max_prefill_debt_tokens=100))
    eng = _engine(tm, scheduler=sched, prefill_chunk_tokens=16)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1024, (96,)).astype(np.int32)
    b = rng.integers(0, 1024, (96,)).astype(np.int32)
    ra = eng.submit(a, max_new_tokens=4, priority=int(Priority.BATCH))
    rb = eng.submit(b, max_new_tokens=4, priority=int(Priority.BATCH))
    assert eng.prefill_debt_tokens == 192
    eng.step()
    assert [r.req_id for r in eng._slots if r is not None] == [ra]
    assert eng.num_queued == 1  # b waits on a's outstanding debt
    assert eng._partial_debt_by_class() == {int(Priority.BATCH): 80}
    assert eng.prefill_debt_tokens == 80 + 96
    out = eng.run()
    assert eng.prefill_debt_tokens == 0
    ref = _run_stream(tm, [a, b], max_new=4)
    assert [out[ra].tolist(), out[rb].tolist()] == ref
    eng.close()
    eng.allocator.check_no_leak()


def test_interactive_decode_defers_a_batch_chunk(models):
    """The scheduler's chunk budget through the engine: a BATCH chunk
    waits while INTERACTIVE work decodes, for at most
    ``max_chunk_deferrals`` steps."""
    _, tm = models
    sched = SLOScheduler(SLOConfig(promote_after_s=1e9, shed_after_s=None,
                                   max_chunk_deferrals=2))
    eng = _engine(tm, scheduler=sched, prefill_chunk_tokens=16)
    ri = eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=8,
                    priority=int(Priority.INTERACTIVE))
    eng.step()  # the interactive prompt: one chunk, then decoding
    rb = eng.submit(_LONG, max_new_tokens=2, priority=int(Priority.BATCH))
    done_lens = []
    for _ in range(4):
        eng.step()
        b = next(r for r in eng._slots if r is not None and r.req_id == rb)
        done_lens.append(b.prefill_done_len)
    # deferred twice, then forced through
    assert done_lens[:2] == [0, 0] and done_lens[2] == 16
    out = eng.run()
    assert len(out[ri]) == 5 + 8
    eng.close()


# -- the server ---------------------------------------------------------------

def test_server_chunked_request_and_observability(models):
    _, tm = models
    met = ServingMetrics(registry=StatRegistry())
    srv = ServingServer(tm, device="cpu", metrics=met, num_slots=2,
                        page_size=8, max_seq_len=128,
                        prefill_chunk_tokens=16)
    port = srv.start()
    try:
        prompt = [int(x) for x in (np.arange(60) * 3) % 100]
        r = client_request("127.0.0.1", port,
                           {"op": "generate", "prompt": prompt,
                            "max_new_tokens": 6})
        assert r.get("done")
        assert r["stats"]["prefill_chunks"] == 4  # ceil(60 / 16)
        h = client_request("127.0.0.1", port, {"op": "health"})
        assert h["prefill_chunk_tokens"] == 16
        assert h["prefill_debt_tokens"] == 0
        assert h["prefill_chunk_ema_ms"] is not None
        m = client_request("127.0.0.1", port, {"op": "metrics"})
        assert "serving_prefill_debt_tokens" in m["text"]
        assert "serving_prefill_chunks_bucket" in m["text"]
        assert "serving_prefill_chunk_launches_total" in m["text"]
        lc = client_request("127.0.0.1", port, {"op": "leak_check"})
        assert lc["ok"]
    finally:
        srv.stop()
    assert met.prefill_chunks.total == 1
    assert met.counter("prefill_chunk_launches_total").get() == 4
