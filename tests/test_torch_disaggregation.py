"""Disaggregated prefill / decode serving in the port
(``tests/test_disaggregation.py``, ``tests/test_crash_safe_serving.py``
``TestFailoverRouter`` and ``tests/test_kv_substrate.py``
``TestFleetCacheRouting`` on the port, CPU, gpt_tiny at page 8).

- The prefix cache's fleet methods against the JAX package's on the same
  pages: ``chain_keys_for``, ``expand_heads``, ``export_blobs`` (blob
  bytes equal), ``import_blobs`` (crc failure, skip, too big for a
  tier), ``advertised_keys_info`` (truncation, deep-touch recency).
- The wire ops: ``fetch_pages`` round trip, a missing key, cursor
  pagination, a bad request, a dead peer; ``prefetch`` landing a peer's
  chain in the tiers.
- A handoff against the local prefill, bitwise in the port over the
  reference's MODES (fp, int8, chunked, spec, spec + int8 + chunked),
  the same stats and counters, no page leak; and the port pair's tokens
  equal to a JAX pair's on the carried weights.
- The fallbacks: a dead peer, corrupt blobs, a partial chain, a wrong
  role, ``prefill_only`` validation, a cross-generation hint skipped and
  counted.
- The router with stub supervisors: ``_pick`` with ``exclude_prefill``,
  the ``_plan_handoff`` decision table, a failed prefill hop, an
  exhausted budget, ``_fleet_cache_hint``, ``rendezvous_owner`` equal to
  JAX's, keyed failover with stream dedupe and the remaining deadline, a
  dead client.
"""

import _torch_threads  # noqa: F401

import json
import socket
import threading
import time
import types

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core.monitor import StatRegistry as JStatRegistry
from paddle_tpu.inference import PageAllocator as JPageAllocator
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import prefix_cache as jpc_mod
from paddle_tpu.serving import supervisor as jsup
from paddle_tpu.serving.metrics import ServingMetrics as JServingMetrics
from paddle_tpu.serving.server import ServingServer as JServingServer

from paddle_tpu_torch.core.monitor import StatRegistry
from paddle_tpu_torch.distributed import fault_inject as fi
from paddle_tpu_torch.inference import (PageAllocator, SpeculativeConfig,
                                        create_decode_engine)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import prefix_cache as tpc_mod
from paddle_tpu_torch.serving import server as server_mod
from paddle_tpu_torch.serving import supervisor as tsup
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.serving.server import (PageFetchFailed, ServingServer,
                                             client_request,
                                             fetch_page_blobs)

ENGINE_KW = dict(num_slots=2, page_size=8, max_seq_len=96)
# 19 tokens = 2 full shareable blocks at page 8: a handoff moves exactly
# 2 pages and the chained prefill covers the 3-token tail
PROMPT = list(range(3, 22))
MNT = 6

JAX = types.SimpleNamespace(pc=jpc_mod, alloc=JPageAllocator, sup=jsup)
PORT = types.SimpleNamespace(pc=tpc_mod, alloc=PageAllocator, sup=tsup)


@pytest.fixture(scope="module", autouse=True)
def _single_device_jax():
    """The JAX models of this file on one device, whatever ran before in
    the worker (held for the module, as the module fixtures build JAX
    models)."""
    from paddle_tpu.distributed.topology import (
        get_hybrid_communicate_group, set_hybrid_communicate_group)
    prev = get_hybrid_communicate_group()
    set_hybrid_communicate_group(None)
    try:
        yield
    finally:
        set_hybrid_communicate_group(prev)


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
    tm.eval()
    return tm


def _free_dead_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _reference(model, mode_kw, prompt=PROMPT, mnt=MNT):
    """Greedy tokens of a bare port engine of the same configuration."""
    eng = create_decode_engine(model, device="cpu", **ENGINE_KW, **mode_kw)
    try:
        rid = eng.submit(np.asarray(prompt, np.int32), mnt)
        return [int(t) for t in eng.run()[rid]][len(prompt):]
    finally:
        eng.close()


def _server(model, role, mode_kw=None, **kw):
    srv = ServingServer(model, device="cpu", role=role,
                        metrics=ServingMetrics(registry=StatRegistry()),
                        **{**ENGINE_KW, **(mode_kw or {}), **kw})
    srv.start()
    return srv


def _leak_ok(*srvs):
    for s in srvs:
        chk = client_request("127.0.0.1", s.port, {"op": "leak_check"})
        assert chk.get("ok"), chk


def _do_handoff(pf, dec, prompt=PROMPT, mnt=MNT, hint=None):
    """The two hops the role-aware router makes: prefill_only on the
    prefill replica, then generate on the decode replica with a
    fetch_from hint naming it."""
    ack = client_request("127.0.0.1", pf.port,
                         {"op": "generate", "prompt": prompt,
                          "max_new_tokens": 1, "prefill_only": True},
                         timeout_s=120)
    assert ack.get("prefilled"), ack
    out = client_request(
        "127.0.0.1", dec.port,
        {"op": "generate", "prompt": prompt, "max_new_tokens": mnt,
         "fetch_from": hint or {"host": "127.0.0.1", "port": pf.port}},
        timeout_s=120)
    assert "error" not in out, out
    return ack, out


# -- the prefix cache's fleet methods against the JAX package's ----------

class _FakeIO:
    def __init__(self):
        self.spliced = {}

    def read_page(self, page):
        return [(np.full((4, 2, 3), page * 10 + l, np.float32),
                 np.full((4, 2, 3), page * 10 + l, np.float32),
                 None, None) for l in range(2)]

    def splice_page(self, pages, layers_list):
        for p, layers in zip(pages, layers_list):
            self.spliced[p] = float(layers[0][0].flat[0])


def _unit_cache(ns, **kw):
    pc = ns.pc.PrefixCache(4, **kw)
    io = _FakeIO()
    pc.attach_device_io(io.read_page, io.splice_page)
    return pc, io


def _seed_chain(pc, alloc, prompt, owner="req"):
    n = pc._shareable_blocks(prompt)
    pages = alloc.alloc(owner, n + 1)
    keys = pc.insert(prompt, np.array(pages, dtype=np.int32), alloc,
                     owner, pc.page_size, ())
    pc.release(keys)
    alloc.free(owner)
    return keys


def _hex(keys):
    return [k.hex() for k in keys]


def _chains_cache(ns, n_chains, blocks=2, page=4):
    pc = ns.pc.PrefixCache(page)
    alloc = ns.alloc(4 * n_chains * blocks)
    chains = []
    for c in range(n_chains):
        prompt = np.asarray([100 * c + i for i in range(page * blocks + 1)],
                            np.int32)
        pages = alloc.alloc(("req", c), blocks + 1)
        keys = pc.insert(prompt, np.array(pages, dtype=np.int32), alloc,
                         ("req", c), page, ())
        pc.release(keys)
        alloc.free(("req", c))
        chains.append((prompt, keys))
    return pc, chains


def _advertised_truncation(ns):
    pc, _chains = _chains_cache(ns, 6)
    a = pc.advertised_keys_info(limit=4)
    b = pc.advertised_keys_info(limit=16)
    assert len(a["keys"]) == 4 and a["truncated"] is True
    assert len(b["keys"]) == 6 and b["truncated"] is False
    assert pc.advertised_keys(limit=16) == b["keys"]
    return a, b


def _advertised_deep_touch(ns):
    pc, chains = _chains_cache(ns, 3)
    for c in (1, 2):
        keys, _ = pc.match(chains[c][0])
        pc.acquire(keys)
        pc.release(keys)
    keys0, _ = pc.match(chains[0][0])
    pc.acquire(keys0[1:])
    pc.release(keys0[1:])
    info = pc.advertised_keys_info(limit=1)
    assert info["truncated"] is True
    assert info["keys"] == [chains[0][1][0].hex()]
    return info


def _export_device_and_tier(ns):
    pc, _io = _unit_cache(ns, spill_bytes=1 << 20)
    alloc = ns.alloc(8)
    prompt = np.arange(13, dtype=np.int32)
    keys = pc.chain_keys_for(prompt)
    assert len(keys) == 3 and not pc._entries
    assert list(_seed_chain(pc, alloc, prompt)) == keys
    assert pc.evict_until(alloc, alloc.free_count + 1)
    blobs, missing = pc.export_blobs(list(keys) + [b"\x00" * 8])
    assert set(blobs) == set(keys) and missing == [b"\x00" * 8]
    assert pc.exported_pages == 3
    for b in blobs.values():
        ns.pc.unpack_page_blob(b)
    return _hex(keys), {k.hex(): b for k, b in blobs.items()}


def _expand_heads(ns):
    pc, _io = _unit_cache(ns, spill_bytes=1 << 20)
    alloc = ns.alloc(8)
    prompt = np.arange(13, dtype=np.int32)
    keys = _seed_chain(pc, alloc, prompt)
    assert pc.evict_until(alloc, alloc.num_pages)
    spilled = pc.expand_heads([keys[0]])
    assert set(spilled) == set(keys)
    pc.restore_from_spill(prompt, (), alloc)
    mixed = pc.expand_heads([keys[0]])
    assert set(mixed) == set(keys)
    return _hex(spilled), _hex(mixed)


def _import_crc_and_skip(ns):
    src, _ = _unit_cache(ns, spill_bytes=1 << 20)
    alloc = ns.alloc(8)
    prompt = np.arange(13, dtype=np.int32)
    keys = _seed_chain(src, alloc, prompt)
    src.evict_until(alloc, alloc.num_pages)
    blobs, _ = src.export_blobs(keys)
    dst, _dio = _unit_cache(ns, spill_bytes=1 << 20)
    bad = dict(blobs)
    bad[keys[1]] = bad[keys[1]][:-1] + bytes([bad[keys[1]][-1] ^ 0xFF])
    rep = dst.import_blobs(bad, heads=keys[:1])
    assert rep["imported"] == 2 and rep["corrupt"] == 1
    assert dst.import_corrupt == 1 and rep["bytes"] > 0
    adv = dst.advertised_keys_info()
    assert keys[0].hex() in adv["keys"]
    rkeys, _rpages, info = dst.restore_from_spill(prompt, (),
                                                  ns.alloc(8))
    assert rkeys == keys[:1] and info["fetched"] == 1
    rep2 = dst.import_blobs(blobs)
    assert rep2["skipped"] == 1 and rep2["imported"] == 2
    info = {k: v for k, v in info.items() if k != "ms"}
    return rep, adv, _hex(rkeys), info, rep2


def _import_without_tiers(ns):
    dst, _ = _unit_cache(ns)
    rep = dst.import_blobs({b"k": b"blob"})
    assert rep == {"imported": 0, "corrupt": 0, "skipped": 1,
                   "dropped": 0, "bytes": 0}
    return rep


def _import_too_big(ns):
    src, _ = _unit_cache(ns, spill_bytes=1 << 20)
    alloc = ns.alloc(8)
    prompt = np.arange(13, dtype=np.int32)
    keys = _seed_chain(src, alloc, prompt)
    src.evict_until(alloc, alloc.num_pages)
    blobs, _ = src.export_blobs(keys)
    dst, _ = _unit_cache(ns, spill_bytes=16)
    rep = dst.import_blobs(blobs, heads=keys[:1])
    assert rep["imported"] == 0 and rep["bytes"] == 0
    assert rep["dropped"] == len(blobs)
    assert dst.imported_pages == 0 and not dst._fetched_keys
    adv = dst.advertised_keys_info()
    assert keys[0].hex() not in adv["keys"]
    return rep, adv


CACHE_SCENARIOS = {
    "advertised_truncation": _advertised_truncation,
    "advertised_deep_touch": _advertised_deep_touch,
    "export_device_and_tier": _export_device_and_tier,
    "expand_heads": _expand_heads,
    "import_crc_and_skip": _import_crc_and_skip,
    "import_without_tiers": _import_without_tiers,
    "import_too_big": _import_too_big,
}


@pytest.mark.parametrize("name", sorted(CACHE_SCENARIOS))
def test_cache_fleet_methods_equal_jax(name):
    fn = CACHE_SCENARIOS[name]
    assert fn(PORT) == fn(JAX)


# -- the wire ops ------------------------------------------------------------

def test_fetch_pages_roundtrip_missing_and_cursor(model, monkeypatch):
    srv = _server(model, "prefill")
    try:
        ack = client_request("127.0.0.1", srv.port,
                             {"op": "generate", "prompt": PROMPT,
                              "max_new_tokens": 1, "prefill_only": True},
                             timeout_s=120)
        assert ack.get("prefilled") and len(ack["keys"]) == 2
        assert ack["page_size"] == 8 and ack["role"] == "prefill"
        blobs, missing, nbytes = fetch_page_blobs(
            "127.0.0.1", srv.port, keys=ack["keys"] + ["ab" * 8])
        assert len(blobs) == 2 and nbytes > 0
        assert missing == ["ab" * 8]
        blobs2, _m, _b = fetch_page_blobs("127.0.0.1", srv.port,
                                          heads=[ack["keys"][0]])
        assert blobs2 == blobs
        # a chain longer than the cap pages through next_cursor
        monkeypatch.setattr(ServingServer, "FETCH_PAGES_CAP", 1)
        one = client_request("127.0.0.1", srv.port,
                             {"op": "fetch_pages", "keys": ack["keys"]})
        assert one["count"] == 1 and one["next_cursor"] == 1 and \
            one["truncated"] is True and one["generation"] == 0
        blobs3, missing3, _ = fetch_page_blobs("127.0.0.1", srv.port,
                                               keys=ack["keys"])
        assert blobs3 == blobs and missing3 == []
        h = client_request("127.0.0.1", srv.port, {"op": "health"})
        assert h["role"] == "prefill" and \
            h["prefix_keys"] == [ack["keys"][0]]
        assert h["prefix_keys_truncated"] is False and h["page_size"] == 8
        _leak_ok(srv)
    finally:
        srv.stop()


def test_fetch_pages_bad_request_and_dead_peer(model):
    srv = _server(model, "mixed")
    try:
        for msg in ({"op": "fetch_pages"},
                    {"op": "fetch_pages", "keys": ["zz"]},
                    {"op": "fetch_pages", "keys": ["ab"], "cursor": "x"}):
            r = client_request("127.0.0.1", srv.port, msg)
            assert r["error"] == "BadRequest", (msg, r)
        # a replica without tiers has nowhere to land a prefetch
        r = client_request("127.0.0.1", srv.port,
                           {"op": "prefetch", "port": 1,
                            "heads": ["ab" * 8]})
        assert r["error"] == "PageFetchFailed"
    finally:
        srv.stop()
    with pytest.raises(PageFetchFailed):
        fetch_page_blobs("127.0.0.1", _free_dead_port(),
                         keys=["ab" * 8], timeout_s=2.0)


def test_prefetch_lands_peer_chain_in_tiers(model):
    pf, dec = _server(model, "prefill"), _server(model, "decode")
    try:
        ack = client_request("127.0.0.1", pf.port,
                             {"op": "generate", "prompt": PROMPT,
                              "max_new_tokens": 1, "prefill_only": True},
                             timeout_s=120)
        rep = client_request("127.0.0.1", dec.port,
                             {"op": "prefetch", "host": "127.0.0.1",
                              "port": pf.port, "heads": [ack["keys"][0]]},
                             timeout_s=120)
        assert rep.get("ok") and rep["imported"] == 2, rep
        assert rep["fetch_ms"] >= 0 and rep["missing"] == []
        h = client_request("127.0.0.1", dec.port, {"op": "health"})
        assert ack["keys"][0] in h["prefix_keys"]
        out = client_request("127.0.0.1", dec.port,
                             {"op": "generate", "prompt": PROMPT,
                              "max_new_tokens": MNT}, timeout_s=120)
        assert out["generated"] == _reference(model, {})
        assert out["stats"]["restored_pages"] == 2
        assert out["stats"]["handoff_pages"] == 2
        nop = client_request("127.0.0.1", dec.port,
                             {"op": "prefetch", "heads": ["ab" * 8]})
        assert nop["error"] == "BadRequest"  # no port
        # a stale-generation prefetch is refused typed and counted
        stale = client_request("127.0.0.1", dec.port,
                               {"op": "prefetch", "host": "127.0.0.1",
                                "port": pf.port, "generation": 3,
                                "heads": [ack["keys"][0]]})
        assert stale["error"] == "StaleGeneration"
        assert dec.metrics.counter(
            "cross_generation_skips_total").get() == 1
        dead = client_request("127.0.0.1", dec.port,
                              {"op": "prefetch", "port": _free_dead_port(),
                               "heads": ["ab" * 8]}, timeout_s=120)
        assert dead["error"] == "PageFetchFailed"
        assert dec.metrics.counter("handoff_failures_total").get() == 1
        _leak_ok(pf, dec)
    finally:
        pf.stop()
        dec.stop()


# -- handoff against local, bitwise over the reference's MODES -------------

MODES = {
    "fp": {},
    "int8": {"kv_int8": True},
    "chunked": {"prefill_chunk_tokens": 8},
    "spec": {"speculative": SpeculativeConfig(k=3)},
    "spec_int8_chunked": {"kv_int8": True, "prefill_chunk_tokens": 8,
                          "speculative": SpeculativeConfig(k=3)},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_handoff_matches_local(model, mode):
    mode_kw = MODES[mode]
    ref = _reference(model, mode_kw)
    pf, dec = _server(model, "prefill", mode_kw), \
        _server(model, "decode", mode_kw)
    dec.tracer.sample_rate = 1.0
    try:
        _ack, out = _do_handoff(pf, dec)
        assert out["generated"] == ref, mode
        st = out["stats"]
        assert st["handoff_pages"] == 2 and st["restored_pages"] == 2, st
        assert st["handoff_ms"] > 0
        m = dec.metrics
        assert m.counter("handoff_pages_total").get() == 2
        assert m.counter("handoff_bytes_total").get() > 0
        assert m.counter("handoff_failures_total").get() == 0
        assert m.handoff_ms.snapshot()["count"] == 1
        assert "serving_handoff_ms_bucket" in m.prometheus_text()
        # the restore span reports the fetched split
        tr = client_request("127.0.0.1", dec.port, {"op": "trace"})
        restores = [s for t in tr["traces"] for s in t["spans"]
                    if s["name"] == "restore"]
        assert restores[-1]["args"]["fetched"] == 2
        stats = client_request("127.0.0.1", dec.port, {"op": "stats"})
        assert stats["prefix_cache"]["imported_pages"] == 2
        _leak_ok(pf, dec)
    finally:
        pf.stop()
        dec.stop()


def test_handoff_equal_to_the_jax_pair(model, jax_model):
    """A port pair and a JAX pair on the same carried weights: the same
    greedy tokens through a handoff, both equal to their local paths."""
    pf, dec = _server(model, "prefill"), _server(model, "decode")
    try:
        _ack, port_out = _do_handoff(pf, dec)
    finally:
        pf.stop()
        dec.stop()
    jsrv = [JServingServer(jax_model, role=r,
                           metrics=JServingMetrics(registry=JStatRegistry()),
                           **ENGINE_KW) for r in ("prefill", "decode")]
    for s in jsrv:
        s.start()
    try:
        _ack, jax_out = _do_handoff(*jsrv)
    finally:
        for s in jsrv:
            s.stop()
    assert jax_out["stats"]["handoff_pages"] == 2
    assert port_out["generated"] == jax_out["generated"] == \
        _reference(model, {})


# -- the fallbacks: counted, the same tokens, no leak ----------------------

def test_dead_peer_and_stale_generation_fall_back_local(model):
    ref = _reference(model, {})
    dec = _server(model, "decode", handoff_timeout_s=2.0)
    try:
        out = client_request("127.0.0.1", dec.port,
                             {"op": "generate", "prompt": PROMPT,
                              "max_new_tokens": MNT,
                              "fetch_from": {"host": "127.0.0.1",
                                             "port": _free_dead_port()}},
                             timeout_s=120)
        assert out["generated"] == ref
        assert out["stats"]["handoff_pages"] == 0
        assert dec.metrics.counter("handoff_failures_total").get() == 1
        # a hint of another weight generation: skipped before any wire
        # traffic, counted, served locally
        out = client_request("127.0.0.1", dec.port,
                             {"op": "generate", "prompt": PROMPT[::-1],
                              "max_new_tokens": MNT,
                              "fetch_from": {"port": _free_dead_port(),
                                             "generation": 1}},
                             timeout_s=120)
        assert out["generated"] == _reference(model, {}, PROMPT[::-1])
        assert dec.metrics.counter(
            "cross_generation_skips_total").get() == 1
        assert dec.metrics.counter("handoff_failures_total").get() == 1
        _leak_ok(dec)
    finally:
        dec.stop()


def _wrapped_fetch(monkeypatch, change):
    real = server_mod.fetch_page_blobs

    def wrapped(*a, **kw):
        return change(*real(*a, **kw))

    monkeypatch.setattr(server_mod, "fetch_page_blobs", wrapped)


def test_corrupt_blobs_fall_back_local(model, monkeypatch):
    ref = _reference(model, {})
    pf, dec = _server(model, "prefill"), _server(model, "decode")
    try:
        _wrapped_fetch(monkeypatch, lambda blobs, missing, nb: (
            {k: b[:-1] + bytes([b[-1] ^ 0xFF]) for k, b in blobs.items()},
            missing, nb))
        _ack, out = _do_handoff(pf, dec)
        assert out["generated"] == ref
        st = out["stats"]
        assert st["handoff_pages"] == 0 and st["restored_pages"] == 0
        assert dec.prefix_cache.import_corrupt == 2
        assert dec.metrics.counter("handoff_failures_total").get() == 1
        _leak_ok(pf, dec)
    finally:
        pf.stop()
        dec.stop()


def test_partial_chain_splices_prefix(model, monkeypatch):
    ref = _reference(model, {})
    pf, dec = _server(model, "prefill"), _server(model, "decode")
    try:
        def head_only(blobs, missing, nb):
            kept = dict(list(blobs.items())[:1])
            return kept, missing, sum(len(b) for b in kept.values())

        _wrapped_fetch(monkeypatch, head_only)
        _ack, out = _do_handoff(pf, dec)
        assert out["generated"] == ref
        st = out["stats"]
        assert st["handoff_pages"] == 1 and st["restored_pages"] == 1
        assert dec.metrics.counter("handoff_failures_total").get() == 0
        _leak_ok(pf, dec)
    finally:
        pf.stop()
        dec.stop()


def test_roles_validated(model):
    pf = _server(model, "prefill")
    try:
        assert pf.prefix_cache.tiers  # a non-mixed role defaults a tier
        r = client_request("127.0.0.1", pf.port,
                           {"op": "generate", "prompt": PROMPT,
                            "max_new_tokens": 4}, timeout_s=120)
        assert r["error"] == "WrongRole" and r["retryable"]
    finally:
        pf.stop()
    srv = _server(model, "mixed", prefix_cache=False)
    try:
        r = client_request("127.0.0.1", srv.port,
                           {"op": "generate", "prompt": PROMPT,
                            "max_new_tokens": 1, "prefill_only": True},
                           timeout_s=120)
        assert r["error"] == "BadRequest"
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="role"):
        ServingServer(model, device="cpu", role="verifier", **ENGINE_KW)


def test_mixed_is_the_single_server(model):
    ref = _reference(model, {})
    srv = _server(model, "mixed")
    try:
        assert not srv.prefix_cache.tiers
        h = client_request("127.0.0.1", srv.port, {"op": "health"})
        assert h["role"] == "mixed" and h["prefix_keys_truncated"] is False
        for hint in (None, {"port": _free_dead_port()}):
            msg = {"op": "generate", "prompt": PROMPT,
                   "max_new_tokens": MNT}
            if hint:
                msg["fetch_from"] = hint
            out = client_request("127.0.0.1", srv.port, msg, timeout_s=120)
            assert out["generated"] == ref
        m = srv.metrics
        for name in ("handoff_pages_total", "handoff_failures_total",
                     "handoff_bytes_total"):
            assert m.counter(name).get() == 0
        _leak_ok(srv)
    finally:
        srv.stop()


def test_handoff_flag_and_info_reach_the_request(model):
    """``handoff=True`` marks the job handoff-blocking (the scheduler's
    boost reads it), ``handoff_info`` fills the request's handoff ms, and
    ``flight_summary`` is JSON-safe."""
    from paddle_tpu_torch.serving.scheduler import SLOScheduler
    sched = SLOScheduler()
    eng = create_decode_engine(model, device="cpu", scheduler=sched,
                               **ENGINE_KW)
    done = {}
    eng.set_on_complete(lambda req: done.setdefault(req.req_id, req))
    try:
        rid = eng.submit(np.asarray(PROMPT, np.int32), 2, handoff=True,
                         handoff_info={"ms": 1.5, "bytes": 10})
        plain = eng.submit(np.asarray(PROMPT[::-1], np.int32), 2)
        assert [r.handoff for r in eng.dump_inflight()] == [True, False]
        assert sched.explain(eng.dump_inflight()[0],
                             time.monotonic())["handoff"] is True
        eng.run()
        assert done[rid].stats.handoff_ms == 1.5
        assert done[plain].stats.handoff_ms == 0.0
        summary = eng.flight_summary()
        json.dumps(summary)
        assert summary["num_pages"] == eng.num_pages and \
            summary["mesh"] is None and summary["steps"] == eng.steps
    finally:
        eng.close()


# -- the router with stub supervisors --------------------------------------

class _StubReplica:
    def __init__(self, idx, port=0, role="mixed", keys=(), load=0):
        self.idx = idx
        self.port = port
        self.role = role
        self.ready = True
        self.restarts = 0
        self.page_size = 8
        self.load = load
        self.prefix_keys = frozenset(keys)
        self.prefix_truncated = False
        self.capacity = None
        self.capacity_t = 0.0

    def alive(self):
        return True


class _StubSup:
    def __init__(self, reps, host="127.0.0.1"):
        self.replicas = reps
        self.host = host
        self.probe_interval_s = 0.5

    def live(self):
        return [r for r in self.replicas if r.ready]


def _first_block_key(prompt, page_size=8):
    return tpc_mod._block_hash(None, np.asarray(prompt[:page_size],
                                                np.int32)).hex()


_NOTRACE = lambda ev, **kw: None  # noqa: E731


def test_rendezvous_owner_equal_to_jax():
    reps = [_StubReplica(i) for i in range(5)]
    keys = [_first_block_key(list(range(i, i + 20))) for i in range(32)]
    port = [tsup.rendezvous_owner(k, reps).idx for k in keys]
    assert port == [jsup.rendezvous_owner(k, reps).idx for k in keys]
    assert len(set(port)) >= 2
    # the router's affinity key is the JAX package's chain key
    router = tsup.FailoverRouter(_StubSup(reps))
    assert router._affinity_key({"prompt": PROMPT, "key": "k"}) == \
        jsup.FailoverRouter(_StubSup(reps))._affinity_key(
            {"prompt": PROMPT, "key": "k"}) == _first_block_key(PROMPT)


def test_pick_excludes_prefill_and_plans_handoffs():
    reps = [_StubReplica(0, role="prefill"), _StubReplica(1, role="decode")]
    router = tsup.FailoverRouter(_StubSup(reps))
    for _ in range(4):
        assert router._pick(set(), exclude_prefill=True).idx == 1
    reps[1].ready = False
    assert router._pick(set(), exclude_prefill=True) is None

    key = _first_block_key(PROMPT)
    msg = {"prompt": PROMPT, "key": "k"}
    mixed = tsup.FailoverRouter(_StubSup([_StubReplica(0),
                                          _StubReplica(1)]))
    assert mixed._plan_handoff(msg, key, None, _NOTRACE) is None
    resident = tsup.FailoverRouter(_StubSup(
        [_StubReplica(0, role="prefill", port=1),
         _StubReplica(1, role="decode", keys=[key])]))
    assert resident._plan_handoff(msg, key, None, _NOTRACE) is None
    holder = tsup.FailoverRouter(_StubSup(
        [_StubReplica(0, role="prefill", port=7777, keys=[key]),
         _StubReplica(1, role="decode")]))
    assert holder._plan_handoff(msg, key, None, _NOTRACE) == \
        {"host": "127.0.0.1", "port": 7777}
    assert holder.handoffs_total == 1

    dead = [_StubReplica(0, role="prefill", port=_free_dead_port()),
            _StubReplica(1, role="decode")]
    failing = tsup.FailoverRouter(_StubSup(dead), backend_timeout_s=2.0)
    assert failing._plan_handoff(msg, key, None, _NOTRACE) is None
    assert failing.handoff_prefill_failures_total == 1
    spent = tsup.FailoverRouter(_StubSup(dead), backend_timeout_s=2.0)
    t0 = time.monotonic()
    assert spent._plan_handoff(msg, key, None, _NOTRACE, budget_ms=50.0,
                               arrival=time.monotonic() - 1.0) is None
    assert time.monotonic() - t0 < 1.0
    assert spent.handoff_prefill_failures_total == 0


def test_fleet_cache_hint_and_forecast_placement():
    key = "ab" * 16
    reps = [_StubReplica(0, port=7001),
            _StubReplica(1, port=7002, keys=[key], load=3),
            _StubReplica(2, port=7003, keys=[key], load=1)]
    router = tsup.FailoverRouter(_StubSup(reps))
    assert router._fleet_cache_hint(reps[0], key) == \
        {"host": "127.0.0.1", "port": 7003}
    assert router.fleet_cache_hints_total == 1
    assert router._fleet_cache_hint(reps[1], key) is None
    assert router._fleet_cache_hint(reps[0], None) is None
    off = tsup.FailoverRouter(_StubSup(reps), fleet_cache=False)
    assert off._fleet_cache_hint(reps[0], key) is None

    two = [_StubReplica(0, port=7001), _StubReplica(1, port=7002)]
    placed = tsup.FailoverRouter(_StubSup(two), forecast_placement=True)
    two[0].capacity = {"forecast": {"tte_s": 1.0}}
    two[0].capacity_t = time.monotonic()
    assert placed._forecast_pressed(two[0])
    assert all(placed._pick(set()).idx == 1 for _ in range(4))
    assert placed.forecast_steers_total == 4
    two[0].capacity_t = time.monotonic() - 3600.0
    assert not placed._forecast_pressed(two[0])


def test_router_prefill_first_dispatch_e2e(model):
    ref = _reference(model, {})
    pf, dec = _server(model, "prefill"), _server(model, "decode")
    reps = [_StubReplica(0, port=pf.port, role="prefill"),
            _StubReplica(1, port=dec.port, role="decode")]
    router = tsup.FailoverRouter(_StubSup(reps))
    port = router.start()
    try:
        out = client_request("127.0.0.1", port,
                             {"op": "generate", "prompt": PROMPT,
                              "max_new_tokens": MNT, "key": "k"},
                             timeout_s=120)
        assert out["generated"] == ref
        assert out["stats"]["handoff_pages"] == 2
        st = client_request("127.0.0.1", port, {"op": "health"})
        assert st["handoffs_total"] == 1 and st["disaggregate"] is True
        assert {r["idx"]: r["role"] for r in st["replicas"]} == \
            {0: "prefill", 1: "decode"}
        _leak_ok(pf, dec)
    finally:
        router.stop()
        pf.stop()
        dec.stop()


def test_handoff_chains_ships_to_survivors(model):
    ref = _reference(model, {})
    victim = _server(model, "mixed", spill_bytes=1 << 20)
    survivor = _server(model, "mixed", spill_bytes=1 << 20)
    try:
        out = client_request("127.0.0.1", victim.port,
                             {"op": "generate", "prompt": PROMPT,
                              "max_new_tokens": MNT}, timeout_s=120)
        assert out["generated"] == ref
        heads = client_request("127.0.0.1", victim.port,
                               {"op": "health"})["prefix_keys"]
        rep = tsup.handoff_chains("127.0.0.1", victim.port, heads,
                                  [_StubReplica(1, port=survivor.port)])
        assert rep["failures"] == [] and rep["imported_pages"] == 2
        client_request("127.0.0.1", victim.port, {"op": "drain"})
        out = client_request("127.0.0.1", survivor.port,
                             {"op": "generate", "prompt": PROMPT,
                              "max_new_tokens": MNT}, timeout_s=120)
        assert out["generated"] == ref
        assert out["stats"]["handoff_pages"] == 2
        _leak_ok(survivor)
    finally:
        victim.stop()
        survivor.stop()
    dead = tsup.handoff_chains("127.0.0.1", _free_dead_port(), ["ab" * 8],
                               [_StubReplica(0, port=_free_dead_port())],
                               timeout_s=2.0)
    assert dead["imported_pages"] == 0 and len(dead["failures"]) == 1


class _FakeReplicaServer:
    """A backend that streams tokens 100, 101, ... and can die after
    ``die_after`` of them (``tests/test_crash_safe_serving.py``)."""

    def __init__(self, n_tokens=6, die_after=None):
        self.n_tokens = n_tokens
        self.die_after = die_after
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self.served = 0
        self.msgs = []
        self._stop = False
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while not self._stop:
            try:
                self._sock.settimeout(0.2)
                conn, _ = self._sock.accept()
            except OSError:
                continue
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        f = conn.makefile("rw", encoding="utf-8")
        try:
            msg = json.loads(f.readline())
            self.served += 1
            self.msgs.append(msg)
            for j in range(self.n_tokens):
                if self.die_after is not None and j >= self.die_after:
                    conn.close()
                    return
                f.write(json.dumps({"rid": 0, "token": 100 + j,
                                    "done": j == self.n_tokens - 1})
                        + "\n")
                f.flush()
            gen = [100 + j for j in range(self.n_tokens)]
            f.write(json.dumps({"rid": 0, "done": True,
                                "tokens": list(msg["prompt"]) + gen,
                                "generated": gen, "stats": {}}) + "\n")
            f.flush()
        except (OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self):
        self._stop = True
        try:
            self._sock.close()
        except OSError:
            pass


def _fake_sup(servers):
    return _StubSup([_StubReplica(i, port=s.port)
                     for i, s in enumerate(servers)])


def test_keyed_failover_dedupes_the_stream_and_carries_the_deadline():
    dying = _FakeReplicaServer(n_tokens=6, die_after=3)
    healthy = _FakeReplicaServer(n_tokens=6)
    router = tsup.FailoverRouter(_fake_sup([dying, healthy]),
                                 max_failover=3, backend_timeout_s=10)
    port = router.start()
    try:
        for _ in range(6):
            toks = []
            rep = client_request("127.0.0.1", port,
                                 {"op": "generate", "prompt": [1, 2],
                                  "max_new_tokens": 6, "stream": True,
                                  "key": "k1", "deadline_ms": 60_000},
                                 timeout_s=30, on_token=toks.append)
            assert "error" not in rep, rep
            assert toks == rep["generated"] == [100 + j for j in range(6)]
            if router.failovers_total:
                break
        assert router.failovers_total >= 1
        budgets = [m.get("deadline_ms") for s in (dying, healthy)
                   for m in s.msgs]
        assert budgets and all(0 < b < 60_000 for b in budgets), budgets
    finally:
        router.stop()
        dying.close()
        healthy.close()


def test_unkeyed_failure_is_typed_and_a_dead_client_is_no_dead_replica():
    dying = _FakeReplicaServer(n_tokens=6, die_after=2)
    router = tsup.FailoverRouter(_fake_sup([dying]), backend_timeout_s=10)
    port = router.start()
    try:
        rep = client_request("127.0.0.1", port,
                             {"op": "generate", "prompt": [1],
                              "max_new_tokens": 6, "stream": True},
                             timeout_s=30)
        assert rep.get("error") == "ReplicaFailed" and rep["retryable"]
    finally:
        router.stop()
        dying.close()
    healthy = _FakeReplicaServer(n_tokens=4)
    router = tsup.FailoverRouter(_fake_sup([healthy]), backend_timeout_s=10)
    sent = []

    def dying_send(obj):
        sent.append(obj)
        if len(sent) >= 2:
            raise BrokenPipeError("client hung up")

    try:
        router._route_generate({"op": "generate", "prompt": [1, 2],
                                "max_new_tokens": 4, "stream": True,
                                "key": "k3"}, dying_send)
        assert router.failovers_total == 0
        assert router.replica_failures_total == 0
        assert healthy.served == 1
    finally:
        router.stop()
        healthy.close()


def test_router_net_recv_fault_triggers_failover():
    a, b = _FakeReplicaServer(n_tokens=4), _FakeReplicaServer(n_tokens=4)
    router = tsup.FailoverRouter(_fake_sup([a, b]), backend_timeout_s=10)
    port = router.start()
    fi.get_injector().arm("net.recv", at_calls=[2])
    try:
        rep = client_request("127.0.0.1", port,
                             {"op": "generate", "prompt": [7],
                              "max_new_tokens": 4, "key": "k2",
                              "stream": True}, timeout_s=30)
        assert rep["generated"] == [100, 101, 102, 103]
        assert router.failovers_total >= 1
    finally:
        router.stop()
        a.close()
        b.close()
