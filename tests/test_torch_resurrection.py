"""The PyTorch port's server survives a persistent engine-step failure by
resurrection (``tests/test_crash_safe_serving.py:90-224`` on the port,
CPU, gpt_tiny at page 8): teardown with the pages audited, a rebuilt
engine with a fresh prefix cache, and every in-flight request replayed
as its prompt plus the tokens it already emitted. Streams carry no
duplicate and no gap, finals equal the JAX package's engine on the same
weights (carried by ``load_jax_state``), the telemetry counts each token
once; spill tiers ride along (``tests/test_prefix_tiers.py:573``). The
rebuild allocates only once the dead engine's pools are freed.
"""

import _torch_threads  # noqa: F401

import threading
import time
import weakref

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.inference import create_decode_engine as jax_engine
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch.core.monitor import StatRegistry
from paddle_tpu_torch.distributed import fault_inject as fi
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import (ServingMetrics, ServingServer,
                                      client_request)

ENGINE_KW = dict(num_slots=2, page_size=8, max_seq_len=96, num_pages=12)


@pytest.fixture(autouse=True)
def _clean_injector():
    fi.reset()
    yield
    fi.reset()


@pytest.fixture(scope="module")
def jax_model():
    pt.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    jm.eval()
    return jm


@pytest.fixture(scope="module")
def model(jax_model):
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    tgpt.load_jax_state(tm, jgpt.checkpoint_state(jax_model))
    return tm


def _server(m, **kw):
    merged = dict(ENGINE_KW)
    merged.update(kw)
    merged.setdefault("metrics", ServingMetrics(registry=StatRegistry()))
    return ServingServer(m, device="cpu", **merged)


def _gen(port, payload, timeout_s=120.0, on_token=None):
    return client_request("127.0.0.1", port, payload,
                          timeout_s=timeout_s, on_token=on_token)


def _expected(jax_model, prompts, mnt):
    """The JAX engine's greedy continuations, no fault."""
    eng = jax_engine(jax_model, **ENGINE_KW)
    rids = [eng.submit(np.asarray(p, np.int32), mnt) for p in prompts]
    results = eng.run()
    eng.close()
    return [[int(t) for t in results[r][len(p):]]
            for r, p in zip(rids, prompts)]


def _arm_when_decoding(srv, n, at_calls=(1, 2), decoding=None):
    """Arm ``engine.step`` on the engine thread, at the first step that
    finds ``n`` requests in flight and ``decoding`` (default all) of them
    holding tokens, so the fault lands mid-decode however the client
    threads are scheduled. ``at_calls`` count from that step."""
    eng = srv.engine
    step = eng.step
    decoding = n if decoding is None else decoding

    def arming_step():
        live = eng.dump_inflight()
        if not fi.get_injector().armed("engine.step") and \
                len(live) == n and \
                sum(bool(r.generated) for r in live) >= decoding:
            fi.get_injector().arm("engine.step", at_calls=at_calls)
        return step()

    eng.step = arming_step


def _gather(srv, n, timeout_s=30.0):
    """Hold the engine's first steps, on the engine thread, until ``n``
    requests are in flight (draining the server's inbox meanwhile), so
    that every client's request is in the engine before any finishes,
    however the client threads are scheduled. Released once; at most
    ``timeout_s``."""
    eng = srv.engine
    step = eng.step
    released = []

    def gathered():
        end = time.monotonic() + timeout_s
        while not released and len(eng.dump_inflight()) < n and \
                time.monotonic() < end:
            srv._drain_inbox()
            time.sleep(0.002)
        released.append(True)
        return step()

    eng.step = gathered


def _clients(port, prompts, mnt, stream=False):
    results = [None] * len(prompts)
    toks = [[] for _ in prompts]

    def client(i):
        results[i] = _gen(port, {"op": "generate", "prompt": prompts[i],
                                 "max_new_tokens": mnt, "stream": stream},
                          on_token=toks[i].append)

    ts = [threading.Thread(target=client, args=(i,))
          for i in range(len(prompts))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    return results, toks


def test_replay_bit_identical_streams_and_finals(model, jax_model):
    prompts = [list(range(1, 7)), list(range(3, 12))]
    expected = _expected(jax_model, prompts, 8)
    met = ServingMetrics(registry=StatRegistry())
    srv = _server(model, metrics=met, max_engine_errors=2)
    # two consecutive step faults reach max_engine_errors=2 while both
    # requests are decoding
    _arm_when_decoding(srv, 2)
    port = srv.start()
    try:
        results, toks = _clients(port, prompts, 8, stream=True)
        for i in range(2):
            assert results[i] is not None, "client hung"
            assert "error" not in results[i], results[i]
            assert results[i]["generated"] == expected[i]
            assert toks[i] == expected[i]  # a pause, no dup, no gap
            assert results[i]["stats"].get("replayed") is True
            assert results[i]["tokens"] == prompts[i] + expected[i]
        counters = met.snapshot()["counters"]
        assert counters["engine_restarts_total"] == 1
        assert counters["replayed_requests_total"] == 2
        replays = [e["args"] for e in srv.tracer.events()
                   if e["name"] == "resurrect"]
        assert [g > 0 for _r, _p, g, _s in replays[0]["rids"]] == \
            [True, True]  # both held tokens when the engine died
        assert counters["tokens_generated_total"] == \
            sum(len(e) for e in expected)
        # the rebuilt engine serves new work, with its own fresh cache
        rep = _gen(port, {"op": "generate", "prompt": [5, 6, 7],
                          "max_new_tokens": 3})
        assert "error" not in rep and len(rep["generated"]) == 3
        health = _gen(port, {"op": "health"})
        assert health["engine_restarts"] == 1 and health["status"] == "ok"
        chk = _gen(port, {"op": "leak_check"})
        assert chk["ok"], chk
    finally:
        srv.stop()
    srv.engine.allocator.check_no_leak()


def test_replay_survives_short_prompt_bucket_ladder(model, jax_model):
    prompts = [list(range(1, 16))]  # fits bucket 16, its replay won't
    expected = _expected(jax_model, prompts, 8)
    srv = _server(model, max_engine_errors=2, prompt_buckets=(16,))
    assert srv.engine.prompt_buckets[-1] == ENGINE_KW["max_seq_len"]
    _arm_when_decoding(srv, 1)
    port = srv.start()
    try:
        rep = _gen(port, {"op": "generate", "prompt": prompts[0],
                          "max_new_tokens": 8})
        assert "error" not in rep, rep
        assert rep["generated"] == expected[0]
        assert rep["stats"].get("replayed") is True
    finally:
        srv.stop()
    srv.engine.allocator.check_no_leak()


def test_restart_budget_exhausted_escalates_typed(model):
    fi.get_injector().arm("engine.step", probability=1.0)
    srv = _server(model, max_engine_errors=2, max_engine_restarts=1)
    port = srv.start()
    try:
        rep = _gen(port, {"op": "generate", "prompt": [1, 2, 3],
                          "max_new_tokens": 4}, timeout_s=90)
        assert rep.get("error") in ("EngineFailed", "ServerEvicted"), rep
        h = _gen(port, {"op": "health"})
        assert h["status"] == "failed" and h["engine_restarts"] == 1
        late = _gen(port, {"op": "generate", "prompt": [1, 2],
                           "max_new_tokens": 2})
        assert late["error"] == "ServerDraining"
    finally:
        srv.stop()
    srv.engine.allocator.check_no_leak()


def test_queued_requests_replay_too(model, jax_model):
    prompts = [list(range(1, 20)), list(range(2, 21)),
               list(range(3, 22))]  # 3 requests, 2 slots: one queues
    expected = _expected(jax_model, prompts, 6)
    srv = _server(model, max_engine_errors=2)
    _gather(srv, 3)
    _arm_when_decoding(srv, 3, decoding=2)
    port = srv.start()
    try:
        results, _ = _clients(port, prompts, 6)
        for i in range(3):
            assert results[i] is not None and \
                "error" not in results[i], results[i]
            assert results[i]["generated"] == expected[i]
        (snap,) = [e["args"]["rids"] for e in srv.tracer.events()
                   if e["name"] == "resurrect"]
        assert sorted(s for *_x, s in snap) == \
            ["decoding", "decoding", "queued"]
    finally:
        srv.stop()
    srv.engine.allocator.check_no_leak()


def test_resurrection_twice_composes_the_replay(model, jax_model):
    """Two resurrections in one request's life: the second replays the
    first replay's prompt, and the reply still reads as one
    generation."""
    prompts = [list(range(1, 7)), list(range(3, 12))]
    expected = _expected(jax_model, prompts, 12)
    met = ServingMetrics(registry=StatRegistry())
    srv = _server(model, metrics=met, max_engine_errors=2)
    # calls 3 and 4 run on the rebuilt engine: the replays' prefill and
    # one decode step, then it dies too
    _arm_when_decoding(srv, 2, at_calls=(1, 2, 5, 6))
    port = srv.start()
    try:
        results, toks = _clients(port, prompts, 12, stream=True)
        for i in range(2):
            assert results[i]["generated"] == expected[i], results[i]
            assert toks[i] == expected[i]
            assert results[i]["tokens"] == prompts[i] + expected[i]
        counters = met.snapshot()["counters"]
        assert counters["engine_restarts_total"] == 2
        assert counters["tokens_generated_total"] == \
            sum(len(e) for e in expected)
    finally:
        srv.stop()


def test_resurrection_with_spill_tiers_zero_leak(model, jax_model,
                                                tmp_path):
    prompts = [list(range(1, 7)), list(range(3, 12))]
    expected = _expected(jax_model, prompts, 8)
    srv = _server(model, spill_bytes=1 << 20, spill_dir=str(tmp_path),
                  max_engine_errors=2)
    _arm_when_decoding(srv, 2)
    port = srv.start()
    try:
        results, _ = _clients(port, prompts, 8)
        for i in range(2):
            assert results[i] is not None and \
                "error" not in results[i], results[i]
            assert results[i]["generated"] == expected[i]
        assert srv._restarts == 1
        # the rebuilt engine's cache carries the same tiers, empty
        names = [t.name for t in srv.prefix_cache.tiers]
        assert names == ["host", "disk"]
        chk = _gen(port, {"op": "leak_check"})
        assert chk["ok"], chk
        stats = _gen(port, {"op": "stats"})
        assert set(stats["prefix_cache"]["tiers"]) == \
            {"device", "host", "disk"}
    finally:
        srv.stop()
    srv.prefix_cache.check_consistent(srv.engine.allocator)
    srv.engine.allocator.check_no_leak()
    assert all(t.blob_count == 0 for t in srv.prefix_cache.tiers)
    assert not any(p.name.endswith(".kvblob") for p in tmp_path.iterdir())


def test_serving_request_and_net_recv_sites(model):
    srv = _server(model)
    port = srv.start()
    try:
        fi.get_injector().arm("serving.request", at_calls=[1])
        rep = _gen(port, {"op": "generate", "prompt": [1, 2, 3],
                          "max_new_tokens": 2})
        assert rep["error"] == "TransientServerError" and rep["retryable"]
        fi.reset()
        fi.get_injector().arm("net.recv", at_calls=[1])
        with pytest.raises(ConnectionError):
            _gen(port, {"op": "health"})
        fi.reset()
        assert _gen(port, {"op": "health"})["status"] == "ok"
        counters = srv.metrics.snapshot()["counters"]
        assert counters["net_recv_drops_total"] == 1
    finally:
        srv.stop()


def test_replayed_request_keeps_its_trace(model):
    """The replay continues the original span tree: one finished tree a
    request, with the resurrect marker, two prefills and no leaked
    open span."""
    prompts = [list(range(1, 7)), list(range(3, 12))]
    srv = _server(model, max_engine_errors=2, trace_sample=1.0)
    _arm_when_decoding(srv, 2)
    port = srv.start()
    try:
        results, _ = _clients(port, prompts, 8)
        assert all(r["stats"].get("replayed") for r in results)
    finally:
        srv.stop()
    trees = srv.tracer.finished()
    assert len(trees) == 2
    for tree in trees:
        names = [s["name"] for s in tree["spans"]]
        assert tree["state"] == "done" and tree["leaked_open"] == 0
        assert names.count("resurrect_replay") == 1
        assert names.count("prefill") == 2 and names.count("request") == 1
    names = [e["name"] for e in srv.tracer.events()]
    assert "resurrect" in names and names.count("replay") == 2


def test_failed_rebuild_fails_the_server_typed(model):
    """A rebuild that raises (a sticky device error poisons every later
    launch) ends in a typed EngineFailed, never a dead engine thread."""
    met = ServingMetrics(registry=StatRegistry())
    srv = _server(model, metrics=met, max_engine_errors=2)

    def broken_rebuild():
        raise RuntimeError("device context lost")

    _arm_when_decoding(srv, 1)
    srv._build_engine = broken_rebuild
    port = srv.start()
    try:
        rep = _gen(port, {"op": "generate", "prompt": [1, 2, 3, 4],
                          "max_new_tokens": 8})
        assert rep["error"] in ("EngineFailed", "ServerEvicted"), rep
        assert _gen(port, {"op": "health"})["status"] == "failed"
        late = _gen(port, {"op": "generate", "prompt": [1, 2],
                           "max_new_tokens": 2})
        assert late["error"] == "ServerDraining"
        counters = met.snapshot()["counters"]
        assert counters["engine_resurrect_failures_total"] == 1
        assert counters["engine_restarts_total"] == 1
    finally:
        srv.stop()


def test_rebuild_allocates_after_the_dead_pools_are_freed(model, jax_model,
                                                          tmp_path):
    """A step that fails inside the decode (its frames hold the pools)
    twice: by the time the rebuild allocates, nothing holds the dead
    engine's pools, not the failed step's traceback and not the prefix
    cache's device IO (spill tiers on), so a pool over half the free
    memory can be rebuilt. No gc pass is needed for it."""
    prompts = [list(range(1, 7)), list(range(3, 12))]
    expected = _expected(jax_model, prompts, 8)
    srv = _server(model, spill_bytes=1 << 20, spill_dir=str(tmp_path),
                  max_engine_errors=2)
    eng = srv.engine
    refs = [weakref.ref(t) for ts in eng._pools.values() for t in ts
            if t is not None]
    fails, raised = [], []
    caches = eng._caches

    def failing_caches(table, lens):
        built = caches(table, lens)
        if fails:
            raised.append(fails.pop())
            raise RuntimeError("device step failed")
        return built

    step = eng.step

    def arming_step():
        live = eng.dump_inflight()
        if not srv._restarts and not fails and len(live) == 2 and \
                all(r.generated for r in live):
            fails.extend([1, 1])  # the next two decodes fail
        return step()

    eng._caches, eng.step = failing_caches, arming_step
    dead = []
    build = srv._build_engine

    def checked_build():
        dead.append([r() is None for r in refs])
        return build()

    srv._build_engine = checked_build
    port = srv.start()
    try:
        results, _ = _clients(port, prompts, 8)
        for i in range(2):
            assert results[i] is not None and \
                "error" not in results[i], results[i]
            assert results[i]["generated"] == expected[i]
            assert results[i]["stats"].get("replayed") is True
        assert srv._restarts == 1
    finally:
        srv.stop()
    assert raised == [1, 1] and srv.metrics.snapshot()["counters"][
        "engine_errors_total"] == 2
    assert len(refs) == 4 and dead == [[True] * 4]
    srv.engine.allocator.check_no_leak()
