"""The PyTorch port's engine with the prefix cache on the CPU, gpt_tiny at
page 8, against the JAX package's engine with its cache (weights carried
by ``load_jax_state``), and against itself with the cache off: the same
greedy tokens; spill restore on the full-hit, partial and miss paths,
restored pages byte-equal to their blobs; shared pages never written;
every exit path leak-free; the ``serving.prefill``, ``alloc.page`` and
``engine.step`` fault sites.

int8 pools: a chained prefill attends the stored prefix as int8 while a
fresh prefill attends its own exact K/V, so cache on and off can part on
a near-tie in int8 (both packages: on ``_shared_prefix_prompts`` one
first token differs in each, and the port equals the JAX engine there).
On-against-off in int8 is pinned on the prompts the JAX package's own
tier tests pin it on (``_prompts``).
"""

import _torch_threads  # noqa: F401

import time

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.inference import create_decode_engine as jax_engine
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import PrefixCache as JaxPrefixCache
from paddle_tpu.serving.prefix_cache import \
    blob_logical_bytes as jax_blob_logical_bytes

from paddle_tpu_torch.distributed import fault_inject as fi
from paddle_tpu_torch.distributed.resilience import (RetryPolicy,
                                                     get_retry_policy)
from paddle_tpu_torch.inference import DecodeRequest, create_decode_engine
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.serving.prefix_cache import (BF16, PrefixCache,
                                                   blob_logical_bytes,
                                                   unpack_page_blob)

ENGINE_KW = dict(num_slots=2, page_size=8, max_seq_len=96, num_pages=12)


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


def _engine(tm, **kw):
    return create_decode_engine(tm, device="cpu", **dict(ENGINE_KW, **kw))


def _shared_prefix_prompts(shared_len=19, tails=(3, 5, 7, 9)):
    """``tests/test_serving.py:61-65``."""
    shared = (np.arange(shared_len, dtype=np.int32) * 5) % 100
    return [np.concatenate([shared,
                            (np.arange(t, dtype=np.int32) + 3 * t) % 100])
            for t in tails]


def _prompts(shared_len=19, tails=(3, 5, 7, 9)):
    """``tests/test_prefix_tiers.py:71-76``."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 100, (shared_len,)).astype(np.int32)
    return [np.concatenate([shared,
                            rng.integers(0, 100, (t,)).astype(np.int32)])
            for t in tails]


def _stream(make, prompts, mnt=12):
    """All prompts submitted at once (more requests than slots), tokens
    per request."""
    eng = make()
    rids = [eng.submit(p, max_new_tokens=mnt) for p in prompts]
    out = eng.run()
    eng.close()
    return [out[r].tolist() for r in rids]


def _one_by_one(eng, prompts, mnt=6):
    out = []
    for p in prompts:
        rid = eng.submit(p, max_new_tokens=mnt)
        out.append(eng.run()[rid].tolist())
    return out


def _baseline(tm, prompts, mnt=6, **kw):
    eng = _engine(tm, **kw)
    out = _one_by_one(eng, prompts, mnt)
    eng.close()
    return out


def _force_spill(eng):
    pc = eng._prefix_cache
    assert pc.evict_until(eng.allocator, eng.allocator.num_pages)
    return pc


@pytest.mark.parametrize("kv_int8", [False, True])
def test_cached_engine_matches_jax_cached_engine(models, kv_int8):
    jm, tm = models
    prompts = _shared_prefix_prompts()
    jpc, tpc = JaxPrefixCache(8), PrefixCache(8)
    want = _stream(lambda: jax_engine(jm, prefix_cache=jpc,
                                      kv_int8=kv_int8, **ENGINE_KW),
                   prompts)
    got = _stream(lambda: _engine(tm, prefix_cache=tpc, kv_int8=kv_int8),
                  prompts)
    assert got == want
    assert tpc.hit_pages == jpc.hit_pages > 0
    assert tpc.miss_pages == jpc.miss_pages


def test_cache_on_against_off_bitwise_fp(models):
    _, tm = models
    prompts = _shared_prefix_prompts()
    pc = PrefixCache(8)
    on = _stream(lambda: _engine(tm, prefix_cache=pc), prompts)
    off = _stream(lambda: _engine(tm), prompts)
    assert pc.hit_pages > 0 and on == off
    # the fused and unfused programs agree with the cache on too
    unfused = _stream(lambda: _engine(tm, prefix_cache=PrefixCache(8),
                                      fused_step=False), prompts)
    assert unfused == on


@pytest.mark.parametrize("kv_int8", [False, True])
def test_cache_on_against_off_bitwise_tier_prompts(models, kv_int8):
    _, tm = models
    prompts = _prompts()
    base = _baseline(tm, prompts, kv_int8=kv_int8)
    pc = PrefixCache(8)
    eng = _engine(tm, prefix_cache=pc, kv_int8=kv_int8)
    try:
        assert _one_by_one(eng, prompts) == base
        assert pc.hit_pages == 6  # 2 shared pages, 3 later requests
        done = []
        eng.set_on_complete(done.append)
        eng.submit(prompts[0], max_new_tokens=2)
        eng.run()
        st = done[0].stats
        assert st.cache_enabled and st.cached_pages == 2
        assert st.cached_tokens == 16 and st.prompt_pages == 2
        assert eng.programs_launched["prefill_chained"] >= 4
    finally:
        eng.close()


def test_cache_survives_batches_and_matches_reference(models):
    _, tm = models
    pc = PrefixCache(8)
    eng = _engine(tm, prefix_cache=pc)
    try:
        for p in _shared_prefix_prompts(tails=(3, 6)):
            eng.submit(p, max_new_tokens=10)
        eng.run()
        hits = pc.hit_pages
        second = _shared_prefix_prompts(tails=(4, 8))
        rids = [eng.submit(p, max_new_tokens=10) for p in second]
        out = eng.run()
        assert pc.hit_pages > hits
        base = _stream(lambda: _engine(tm), second, mnt=10)
        assert [out[r].tolist() for r in rids] == base
        assert pc.hit_rate() > 0
    finally:
        eng.close()


def test_page_size_mismatch_rejected_at_construction(models):
    _, tm = models
    with pytest.raises(ValueError, match="page_size"):
        _engine(tm, prefix_cache=PrefixCache(16))


def test_cache_eviction_under_page_pressure(models):
    _, tm = models
    pc = PrefixCache(8)
    eng = _engine(tm, num_pages=6, prefix_cache=pc)
    try:
        a = (np.arange(17, dtype=np.int32) * 3) % 100
        eng.submit(a, max_new_tokens=8)
        eng.run()
        assert pc.total_pages() == 2
        b = (np.arange(20, dtype=np.int32) * 7 + 1) % 100
        # 35 tokens -> 5 pages with 4 free: the cache must evict
        rb = eng.submit(b, max_new_tokens=15)
        out = eng.run()
        assert pc.evicted_pages >= 1
        assert out[rb].tolist() == _baseline(tm, [b], mnt=15)[0]
    finally:
        eng.close()


def test_fits_counts_evictable_pages_not_its_own_match(models):
    _, tm = models
    pc = PrefixCache(8)
    eng = _engine(tm, num_pages=6, prefix_cache=pc)
    try:
        a = (np.arange(17, dtype=np.int32) * 3) % 100
        eng.submit(a, max_new_tokens=8)
        eng.run()
        assert eng.free_pages == 4 and pc.evictable_pages() == 2

        def probe(prompt, max_new):
            return eng._fits(DecodeRequest(0, prompt, max_new))

        # a miss needing 6 pages: 4 free + 2 evictable
        assert probe(np.arange(40, 80, dtype=np.int32), 8)
        # a hit on the 2 cached pages needs 4 (48 tokens) or 5 (49)
        # more; its own match is not evictable, so only 4 are there
        b = np.concatenate([a, np.arange(8, dtype=np.int32)])
        assert probe(b, 23)
        assert not probe(b, 24)
    finally:
        eng.close()


@pytest.mark.parametrize("kv_int8", [False, True])
def test_restore_full_partial_and_miss_bitwise(models, kv_int8):
    _, tm = models
    prompts = _prompts()
    base = _baseline(tm, prompts, kv_int8=kv_int8)
    pc = PrefixCache(8, spill_bytes=1 << 20)
    eng = _engine(tm, prefix_cache=pc, kv_int8=kv_int8)
    try:
        # miss path: tiers on, nothing spilled yet
        assert _one_by_one(eng, prompts) == base
        # device-hit path, then spill everything
        _force_spill(eng)
        assert pc.spilled_pages > 0
        blobs = {k: pc.tiers[0]._load(k) for k in list(pc.tiers[0]._index)}
        done = []
        eng.set_on_complete(done.append)
        # full restore: the whole chain comes back from the host tier
        assert _one_by_one(eng, prompts[:1]) == base[:1]
        assert pc.restored_pages == 2 and pc.tier_hit_pages["host"] == 2
        st = done[-1].stats
        assert st.restored_pages == 2 and st.restored_host_pages == 2
        assert st.cached_pages == 2 and st.restore_ms > 0
        assert eng.programs_launched["restore"] == 1
        # every restored page re-reads byte-equal to its blob
        for key, ent in pc._entries.items():
            if key not in blobs:
                continue
            for a, b in zip(eng._read_page(ent.page),
                            unpack_page_blob(blobs[key])):
                for x, y in zip(a, b):
                    if x is None:
                        assert y is None
                        continue
                    assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        # partial: only the chain's head restores, the rest is prefilled
        _force_spill(eng)
        for key, _p, _b in pc._chain_keys(prompts[1])[1:]:
            pc.tiers[0].remove(key)
        assert _one_by_one(eng, prompts[1:2]) == base[1:2]
        assert pc.restored_pages == 3 and done[-1].stats.cached_pages == 1
        pc.check_consistent(eng.allocator)
    finally:
        eng.close()
    assert all(t.blob_count == 0 for t in pc.tiers)


def test_restore_equals_device_hit_bitwise_int8(models):
    """A restored chain holds the bytes the evicted one held, so a
    restore-hit request equals a device-hit request on any prompt."""
    _, tm = models
    prompts = _shared_prefix_prompts()
    pc = PrefixCache(8, spill_bytes=1 << 20)
    eng = _engine(tm, prefix_cache=pc, kv_int8=True)
    try:
        _one_by_one(eng, prompts[:1])
        hit = _one_by_one(eng, prompts[1:])
        _force_spill(eng)
        _one_by_one(eng, prompts[:1])  # restored, then re-inserted
        assert pc.restored_pages == 2
        restored = []
        for p in prompts[1:]:
            _force_spill(eng)
            restored += _one_by_one(eng, [p])
        assert restored == hit
    finally:
        eng.close()


def test_restore_bf16_pool_keeps_bf16_bytes():
    """A bf16 pool spills its own 2-byte values: each blob names
    "bfloat16" and holds half the bytes of an fp32 page, a restored page
    re-reads byte-equal to its blob, and restore equals no cache."""
    pt.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny(dtype="bfloat16"))
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(dtype="bfloat16"), device="cpu")
    tgpt.load_jax_state(tm, jgpt.checkpoint_state(jm))
    prompts = _prompts()
    base = _baseline(tm, prompts)
    pc = PrefixCache(8, spill_bytes=1 << 20)
    eng = _engine(tm, prefix_cache=pc)
    try:
        assert _one_by_one(eng, prompts) == base
        _force_spill(eng)
        blobs = {k: pc.tiers[0]._load(k) for k in list(pc.tiers[0]._index)}
        cfg = tm.config
        page_bytes = cfg.num_layers * 2 * 8 * cfg.hidden_size * 2
        for blob in blobs.values():
            assert b";bfloat16;" in blob[:64]
            assert blob_logical_bytes(blob) == page_bytes == \
                jax_blob_logical_bytes(blob)
            assert len(blob) < page_bytes + 64
        assert pc.tiers[0].logical_bytes == len(blobs) * page_bytes
        assert _one_by_one(eng, prompts) == base
        assert pc.restored_pages >= 2
        restored = 0
        for key, ent in pc._entries.items():
            if key not in blobs:
                continue
            for a, b in zip(eng._read_page(ent.page),
                            unpack_page_blob(blobs[key])):
                for x, y in zip(a[:2], b[:2]):
                    assert x.dtype == y.dtype == BF16
                    assert x.tobytes() == y.tobytes()
            restored += 1
        assert restored >= 2
        pc.check_consistent(eng.allocator)
    finally:
        eng.close()


def test_disk_tier_demotion_end_to_end(models, tmp_path):
    _, tm = models
    prompts = _prompts()
    base = _baseline(tm, prompts)
    # a gpt_tiny fp page blob is 16.4 KB (2 layers x k, v x 8x4x32 f32):
    # the host holds two, the disk the rest
    pc = PrefixCache(8, spill_bytes=40_000, spill_dir=str(tmp_path),
                     disk_bytes=1 << 20)
    eng = _engine(tm, prefix_cache=pc)
    try:
        assert _one_by_one(eng, prompts) == base
        _force_spill(eng)
        host, disk = pc.tiers
        assert host.occupancy_bytes <= host.capacity_bytes
        assert disk.blob_count > 0
        assert _one_by_one(eng, prompts[:1]) == base[:1]
        assert pc.tier_hit_pages["host"] + pc.tier_hit_pages["disk"] > 0
        pc.check_consistent(eng.allocator)
    finally:
        eng.close()
    assert not any(p.name.endswith(".kvblob") for p in tmp_path.iterdir())


def test_torn_spill_falls_back_to_prefill_same_tokens(models):
    _, tm = models
    prompts = _prompts()
    base = _baseline(tm, prompts[:2])
    pc = PrefixCache(8, spill_bytes=1 << 20)
    eng = _engine(tm, prefix_cache=pc)
    try:
        assert _one_by_one(eng, prompts[:2]) == base
        fi.get_injector().arm("cache.spill", probability=1.0,
                              mode="torn", seed=3)
        _force_spill(eng)
        fi.reset()
        assert _one_by_one(eng, prompts[:1]) == base[:1]
        assert pc.restore_corrupt > 0 and pc.restored_pages == 0
        pc.check_consistent(eng.allocator)
    finally:
        eng.close()


def _pool_bytes(eng, pages):
    return [[t[p].clone() for t in eng._pools["k"] + eng._pools["v"]]
            for p in pages]


def test_shared_pages_untouched_by_divergent_request(models):
    _, tm = models
    pc = PrefixCache(8)
    eng = _engine(tm, prefix_cache=pc)
    try:
        a = _prompts()[0]
        _one_by_one(eng, [a])
        keys, shared = pc.match(a)
        assert len(shared) == 2
        before = _pool_bytes(eng, shared)
        # shares block 0 only: diverges inside block 1, prefills and
        # decodes past both shared pages
        b = np.concatenate([a[:10], (a[10:] + 1) % 100,
                            np.arange(30, dtype=np.int32)])
        out = _one_by_one(eng, [b], mnt=20)
        assert out == _baseline(tm, [b], mnt=20)
        b_pages = pc.match(b)[1]  # b's chain is cached too now
        assert b_pages[0] == shared[0] and shared[1] not in b_pages
        after = _pool_bytes(eng, shared)
        for x, y in zip(before, after):
            for s, t in zip(x, y):
                assert s.equal(t)
    finally:
        eng.close()


def test_failed_prefill_partway_leaves_shared_pages_and_no_leak(models):
    _, tm = models
    pc = PrefixCache(8)
    states = []
    eng = _engine(tm, prefix_cache=pc, max_prefill_attempts=1,
                  on_complete=lambda r: states.append(r.state))
    block = tm.gpt.h[1]
    try:
        a = _prompts()[0]
        _one_by_one(eng, [a])
        keys, shared = pc.match(a)
        before = _pool_bytes(eng, shared)

        def boom(*args, **kwargs):
            raise RuntimeError("layer 1 failed after layer 0 wrote")

        block.forward = boom  # layer 0 appends, then the prefill dies
        eng.submit(_prompts()[1], max_new_tokens=4)
        with pytest.raises(RuntimeError, match="layer 1 failed"):
            eng.step()
        assert states[-1] == "failed"
        del block.forward
        for x, y in zip(before, _pool_bytes(eng, shared)):
            for s, t in zip(x, y):
                assert s.equal(t)
        pc.check_consistent(eng.allocator)
        assert all(e.refcount == 0 for e in pc._entries.values())
    finally:
        block.__dict__.pop("forward", None)
        eng.close()


def test_deadline_unwind_and_close_zero_leak(models):
    _, tm = models
    prompts = _prompts()
    pc = PrefixCache(8, spill_bytes=1 << 20)
    states = []
    eng = _engine(tm, prefix_cache=pc,
                  on_complete=lambda r: states.append(r.state))
    try:
        _one_by_one(eng, prompts[:1])
        _force_spill(eng)
        # expired at admission: shed before any restore
        eng.submit(prompts[0], max_new_tokens=6,
                   deadline_t=time.monotonic() - 1.0)
        eng.step()
        assert states[-1] == "deadline" and pc.restored_pages == 0
        # a restore-hit request evicted mid-flight by its deadline
        rid = eng.submit(prompts[0], max_new_tokens=50,
                         deadline_t=time.monotonic() + 60.0)
        eng.step()
        assert pc.restored_pages > 0
        expired = eng.expire_deadlines(now=time.monotonic() + 61.0)
        assert [r.req_id for r in expired] == [rid]
        assert all(e.refcount == 0 for e in pc._entries.values())
        pc.check_consistent(eng.allocator)
        # a device hit and a queued request when close() lands
        eng.submit(prompts[1], max_new_tokens=6)
        eng.submit(prompts[2], max_new_tokens=6)
        eng.submit(prompts[3], max_new_tokens=6)
        eng.step()
        assert eng.num_active == 2 and eng.num_queued == 1
        assert [r.req_id for r in eng.dump_inflight()] == \
            sorted(r.req_id for r in eng.dump_inflight())
        assert len(eng.dump_inflight()) == 3
    finally:
        eng.close()  # asserts check_no_leak
    assert states.count("evicted") == 3
    assert pc.total_pages() == 0
    assert all(t.blob_count == 0 for t in pc.tiers)


def test_prefill_fault_retried_by_site_policy(models):
    _, tm = models
    prompts = _prompts()
    base = _baseline(tm, prompts[:2])
    done = []
    pc = PrefixCache(8)
    eng = _engine(tm, prefix_cache=pc,
                  prefill_retry=get_retry_policy("serving.prefill"),
                  on_complete=done.append)
    try:
        fi.get_injector().arm("serving.prefill", at_calls=[2, 3])
        assert _one_by_one(eng, prompts[:2]) == base
        assert fi.get_injector().counts("serving.prefill") == \
            {"calls": 4, "fired": 2}
        assert [r.stats.prefill_attempts for r in done] == [1, 1]
        assert done[1].stats.cached_pages == 2
        # retries exhausted at every attempt: unwound, requeued, then
        # FAILED typed after max_prefill_attempts; no page leaks
        fi.get_injector().arm("serving.prefill", probability=1.0)
        eng.submit(prompts[2], max_new_tokens=4)
        for _ in range(eng.max_prefill_attempts):
            with pytest.raises(Exception, match="retry exhausted"):
                eng.step()
        assert done[-1].state == "failed"
        assert eng.num_queued == 0 and eng.num_active == 0
        pc.check_consistent(eng.allocator)
    finally:
        fi.reset()
        eng.close()


def test_alloc_page_fault_requeues(models):
    _, tm = models
    prompts = _prompts()
    base = _baseline(tm, prompts[:2])
    pc = PrefixCache(8)
    eng = _engine(tm, prefix_cache=pc)
    try:
        _one_by_one(eng, prompts[:1])
        fi.get_injector().arm("alloc.page", at_calls=[1])
        rid = eng.submit(prompts[1], max_new_tokens=6)
        eng.step()  # the allocation fails: requeued, pins released
        assert eng.num_queued == 1 and eng.num_active == 0
        assert all(e.refcount == 0 for e in pc._entries.values())
        assert eng.run()[rid].tolist() == base[1]
    finally:
        eng.close()


def test_engine_step_fault_leaves_state_untouched(models):
    _, tm = models
    prompts = _prompts()
    base = _baseline(tm, prompts[:1])
    eng = _engine(tm, prefix_cache=PrefixCache(8))
    try:
        rid = eng.submit(prompts[0], max_new_tokens=6)
        eng.step()
        snap = (eng._lens.copy(), eng._table.copy(), eng.steps,
                list(eng._slots[0].generated))
        fi.get_injector().arm("engine.step", at_calls=[1, 2])
        for _ in range(2):
            with pytest.raises(fi.InjectedFault):
                eng.step()
        assert (snap[0] == eng._lens).all() and (snap[1] == eng._table).all()
        assert snap[2] == eng.steps and snap[3] == eng._slots[0].generated
        assert eng.run()[rid].tolist() == base[0]
    finally:
        eng.close()


def test_cache_stats_reach_the_metrics(models):
    _, tm = models
    prompts = _prompts()
    met = ServingMetrics()
    pc = PrefixCache(8, spill_bytes=1 << 20)
    eng = _engine(tm, prefix_cache=pc, on_complete=met.observe_request)
    try:
        for p in prompts:
            eng.submit(p, max_new_tokens=4)
        eng.run()
        _force_spill(eng)
        eng.submit(prompts[0], max_new_tokens=4)
        eng.run()
        c = met.snapshot()["counters"]
        assert c["cache_hit_pages_total"] > 0
        assert c["cache_hit_requests_total"] > 0
        assert c["cache_restored_pages_total"] == 2
        assert c["cache_host_hit_pages_total"] == 2
        text = met.prometheus_text()
        assert "serving_restore_ms_bucket" in text
        assert "serving_cache_restored_pages_total" in text
    finally:
        eng.close()


def test_retry_policy_argument_is_a_policy(models):
    _, tm = models
    calls = []

    class Counting(RetryPolicy):
        def call(self, fn, *a, site="", **k):
            calls.append(site)
            return super().call(fn, *a, site=site, **k)

    eng = _engine(tm, prefill_retry=Counting(max_attempts=2))
    try:
        _one_by_one(eng, _prompts()[:2], mnt=2)
    finally:
        eng.close()
    assert calls == ["serving.prefill"] * 2


# -- the dedup fold at engine level (``tests/test_kv_substrate.py:363-418``) --

# 19 tokens = 2 full shareable blocks at page 8
_DEDUP_PROMPT = np.arange(3, 22, dtype=np.int32)
_DEDUP_OTHER = np.arange(40, 61, dtype=np.int32)
_DEDUP_STREAM = (_DEDUP_PROMPT, _DEDUP_PROMPT, _DEDUP_OTHER)


def _dedup_run(make, model, dedup, **kw):
    from paddle_tpu_torch.inference import SpeculativeConfig
    if kw.pop("spec", False):
        kw["speculative"] = SpeculativeConfig(k=2)
    if make is _engine:
        cache = PrefixCache(8, dedup=dedup)
        eng = _engine(model, prefix_cache=cache, **kw)
    else:
        cache = JaxPrefixCache(8, dedup=dedup)
        eng = make(model, prefix_cache=cache, **dict(ENGINE_KW, **kw))
    rids = [eng.submit(p, max_new_tokens=6) for p in _DEDUP_STREAM]
    out = eng.run()
    return [np.asarray(out[r]).tolist() for r in rids], eng, cache


def test_chunked_concurrent_prefill_folds_deterministically(models):
    """Chunked prefill keeps both same-prompt requests in flight past
    each other's match, so the second insert meets the first's entries:
    2 folds, the dedup class in ``occupancy()``, the ledger reconciles,
    and the books balance after close."""
    _, tm = models
    outs, eng, pc = _dedup_run(_engine, tm, True, prefill_chunk_tokens=8)
    try:
        assert pc.dedup_hits == 2
        assert eng.allocator.occupancy()["dedup"] == 2
        ts = pc.tier_stats()["device"]
        assert ts["dedup_pages"] == 2 and ts["dedup_hits"] == 2
        rec = eng.ledger.reconcile(eng.allocator)
        assert rec["ok"], rec
        assert outs[0] == outs[1]
    finally:
        eng.close()  # asserts check_no_leak


@pytest.mark.parametrize("mode_kw", [
    {}, {"prefill_chunk_tokens": 8}, {"spec": True},
], ids=["plain", "chunked", "spec"])
def test_dedup_on_against_off_bitwise(models, mode_kw):
    _, tm = models
    base, eng0, pc0 = _dedup_run(_engine, tm, False, **dict(mode_kw))
    eng0.close()
    outs, eng1, pc1 = _dedup_run(_engine, tm, True, **dict(mode_kw))
    eng1.close()
    assert outs == base
    assert pc0.dedup_hits == 0
    if "prefill_chunk_tokens" in mode_kw:
        assert pc1.dedup_hits > 0  # the fold is reached at engine level


def test_chunked_dedup_engine_matches_jax(models):
    jm, tm = models
    want, jeng, jpc = _dedup_run(jax_engine, jm, True,
                                 prefill_chunk_tokens=8)
    jeng.close()
    got, eng, pc = _dedup_run(_engine, tm, True, prefill_chunk_tokens=8)
    eng.close()
    assert got == want and pc.dedup_hits == jpc.dedup_hits == 2
