"""The PyTorch port's prefix cache (``paddle_tpu_torch/serving/
prefix_cache.py``) on the host, no model: its chain keys, blob bytes and
KV scale math against the JAX package's on the same arrays, then the
unit cycles of the JAX package's cache tests (match / insert / refcount /
evict, the spill tiers, spill and restore over a fake device, corrupt
and torn blobs) on the port's cache. Fault sites and retry dispositions
against the JAX registry.
"""

import _torch_threads  # noqa: F401

import dataclasses
import os

import numpy as np
import pytest

from paddle_tpu.distributed import fault_inject as jfi
from paddle_tpu.distributed import resilience as jres
from paddle_tpu.quantization import quant as jquant
from paddle_tpu.serving import prefix_cache as jpc

from paddle_tpu_torch.distributed import fault_inject as fi
from paddle_tpu_torch.distributed import resilience as res
from paddle_tpu_torch.inference import PageAllocator
from paddle_tpu_torch.quantization import quant
from paddle_tpu_torch.serving import prefix_cache as tpc
from paddle_tpu_torch.serving.prefix_cache import (DiskSpillTier,
                                                   HostSpillTier,
                                                   PrefixCache, SpillCorrupt,
                                                   pack_page_blob,
                                                   unpack_page_blob)


@pytest.fixture(autouse=True)
def _clean_injector():
    fi.reset()
    yield
    fi.reset()


def _layers(int8=False, nl=3, shape=(8, 2, 4), seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nl):
        if int8:
            k = rng.integers(-128, 127, shape).astype(np.int8)
            v = rng.integers(-128, 127, shape).astype(np.int8)
            ks = rng.random(shape[:2]).astype(np.float32)
            vs = rng.random(shape[:2]).astype(np.float32)
        else:
            k = rng.standard_normal(shape).astype(np.float32)
            v = rng.standard_normal(shape).astype(np.float32)
            ks = vs = None
        out.append((k, v, ks, vs))
    return out


# -- against the JAX package --------------------------------------------------

@pytest.mark.parametrize("generation", [0, 3])
@pytest.mark.parametrize("page", [4, 8])
def test_chain_keys_byte_equal_to_jax(generation, page):
    rng = np.random.default_rng(page + generation)
    for n in (1, page, page + 1, 5 * page + 3):
        prompt = rng.integers(0, 50304, n).astype(np.int32)
        want = jpc.PrefixCache(page, generation=generation)
        got = tpc.PrefixCache(page, generation=generation)
        assert got.chain_keys_for(prompt) == want.chain_keys_for(prompt)
        assert [k for k, _p, _b in got._chain_keys(prompt)] == \
            [k for k, _p, _b in want._chain_keys(prompt)]
        block = prompt[:page]
        assert tpc._block_hash(None, block, generation) == \
            jpc._block_hash(None, block, generation)


@pytest.mark.parametrize("fmt", ["raw", "int8", "int4"])
@pytest.mark.parametrize("int8_pool", [False, True])
def test_blob_bytes_equal_to_jax(fmt, int8_pool):
    layers = _layers(int8=int8_pool, shape=(8, 2, 5))
    stats_t, stats_j = {}, {}
    blob = pack_page_blob(layers, fmt=fmt, stats=stats_t)
    assert blob == jpc.pack_page_blob(layers, fmt=fmt, stats=stats_j)
    assert stats_t == stats_j
    assert tpc.blob_logical_bytes(blob) == jpc.blob_logical_bytes(blob)
    for a, b in zip(unpack_page_blob(blob), jpc.unpack_page_blob(blob)):
        for x, y in zip(a, b):
            if x is None:
                assert y is None
                continue
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("fmt", ["raw", "int8", "int4"])
def test_bf16_blob_bytes_equal_to_jax(fmt):
    """A bf16 page travels as its 2-byte patterns (``BF16``): the blob
    names "bfloat16" and holds the JAX package's bytes (ml_dtypes
    arrays of the same bits); decoding gives the same bits back."""
    import ml_dtypes
    rng = np.random.default_rng(3)
    port, ref = [], []
    for _ in range(3):
        k, v = (rng.standard_normal((8, 2, 5)).astype(np.float32)
                .astype(ml_dtypes.bfloat16) for _ in range(2))
        ref.append((k, v, None, None))
        port.append((k.view(np.uint16).view(tpc.BF16),
                     v.view(np.uint16).view(tpc.BF16), None, None))
    stats_t, stats_j = {}, {}
    blob = pack_page_blob(port, fmt=fmt, stats=stats_t)
    assert blob == jpc.pack_page_blob(ref, fmt=fmt, stats=stats_j)
    assert stats_t == stats_j
    assert tpc.blob_logical_bytes(blob) == jpc.blob_logical_bytes(blob) \
        == 3 * 2 * 8 * 2 * 5 * 2
    for a, b in zip(unpack_page_blob(blob), jpc.unpack_page_blob(blob)):
        for x, y in zip(a[:2], b[:2]):
            assert x.dtype == tpc.BF16 and y.dtype == ml_dtypes.bfloat16
            assert x.tobytes() == y.tobytes()
    if fmt == "raw":
        assert unpack_page_blob(blob)[0][0].tobytes() == \
            port[0][0].tobytes()


@pytest.mark.parametrize("shape", [(8, 2, 4), (3, 16, 7), (64, 16, 128)])
def test_kv_scale_math_bitwise_jax(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row takes the eps scale
    assert quant.KV_QMAX_INT8 == jquant.KV_QMAX_INT8
    assert quant.KV_QMAX_INT4 == jquant.KV_QMAX_INT4
    for fn in ("quantize_kv_np", "quantize_kv_int4_np"):
        got, want = getattr(quant, fn)(x), getattr(jquant, fn)(x)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    q, s = quant.quantize_kv_np(x)
    assert quant.dequantize_kv_np(q, s).tobytes() == \
        jquant.dequantize_kv_np(q, s).tobytes()
    p4, s4 = quant.quantize_kv_int4_np(x)
    assert quant.dequantize_kv_int4_np(p4, s4, shape[-1]).tobytes() == \
        jquant.dequantize_kv_int4_np(p4, s4, shape[-1]).tobytes()


def test_fault_sites_and_dispositions_match_jax():
    assert set(fi.FAULT_SITES) == {"engine.step", "serving.prefill",
                                   "serving.verify", "alloc.page",
                                   "cache.spill", "serving.request",
                                   "net.recv", "checkpoint.write",
                                   "checkpoint.read", "checkpoint.load",
                                   "swap.apply", "dataloader.fetch"}
    for site in fi.FAULT_SITES:
        assert site in jfi.FAULT_SITES
        assert (site in res.NO_RETRY_SITES) == \
            (site in jres.NO_RETRY_SITES)
        assert (site in res._BUILTIN_SITE_POLICIES) == \
            (site in jres._BUILTIN_SITE_POLICIES)
        assert dataclasses.astuple(res.get_retry_policy(site)) == \
            dataclasses.astuple(jres.get_retry_policy(site))


def test_injector_schedule_and_env_match_jax():
    env = {"PT_FAULT_INJECT": "engine.step:at=2|4;cache.spill:p=0.5,"
                              "max=3,seed=7,mode=torn"}
    fired = []
    for mod in (fi, jfi):
        inj = mod.FaultInjector().configure_from_env(env)
        seq = []
        for _ in range(12):
            for site in ("engine.step", "cache.spill"):
                try:
                    seq.append(inj.fire(site, modes=("abort", "torn")))
                except mod.InjectedFault as e:
                    seq.append(("raised", e.site, e.index))
        fired.append(seq)
        mod.reset()
    assert fired[0] == fired[1]


def test_retry_policy_matches_jax():
    spec = "attempts=4,base=0.001,max_delay=0.002,jitter=0.5,seed=3"
    got, want = res.RetryPolicy.from_spec(spec), \
        jres.RetryPolicy.from_spec(spec)
    assert got.preview_delays() == want.preview_delays()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise fi.InjectedFault("serving.prefill", len(calls))
        return "ok"

    assert got.call(flaky, site="serving.prefill") == "ok"
    assert len(calls) == 3
    with pytest.raises(res.RetryExhausted):
        res.RetryPolicy(max_attempts=2, base_delay_s=0.0).call(
            lambda: (_ for _ in ()).throw(ConnectionError("x")))
    with pytest.raises(KeyError):  # not transient: no retry
        got.call(lambda: {}["x"])


# -- the cache's unit cycles ----------------------------------------------------

def test_shareable_blocks_never_cover_whole_prompt():
    pc = PrefixCache(8)
    assert pc._shareable_blocks(np.arange(16)) == 1
    assert pc._shareable_blocks(np.arange(17)) == 2
    assert pc._shareable_blocks(np.arange(8)) == 0
    assert pc._shareable_blocks(np.arange(9)) == 1


def test_match_insert_refcount_evict_cycle():
    pc = PrefixCache(4)
    alloc = PageAllocator(8)
    prompt = np.arange(11, dtype=np.int32)  # 2 shareable blocks
    assert pc.match(prompt) == ((), [])
    pages = alloc.alloc("req0", 3)
    row = np.array(pages + [99], dtype=np.int32)
    keys = pc.insert(prompt, row, alloc, "req0", 4, ())
    assert len(keys) == 2 and pc.total_pages() == 2
    assert len(alloc.owners()["req0"]) == 1
    mk, mp = pc.match(prompt)
    assert mk == keys and mp == [int(row[0]), int(row[1])]
    assert pc.evictable_pages() == 0
    assert not pc.evict_until(alloc, alloc.num_pages)
    pc.release(keys)
    assert pc.evictable_pages() == 2
    assert pc.evictable_pages(excluding=keys[:1]) == 1
    assert pc.evict_until(alloc, alloc.free_count + 2)
    assert pc.total_pages() == 0
    alloc.free("req0")
    alloc.check_no_leak()
    with pytest.raises(RuntimeError, match="underflow"):
        pc.insert(prompt, np.array(alloc.alloc("r", 3) + [0], np.int32),
                  alloc, "r", 4, ())
        pc.release(pc.match(prompt)[0])
        pc.release(pc.match(prompt)[0])


def test_divergent_prompt_shares_only_common_blocks():
    pc = PrefixCache(4)
    alloc = PageAllocator(8)
    a = np.arange(11, dtype=np.int32)
    b = np.concatenate([a[:4], a[4:] + 50])
    row = np.array(alloc.alloc("a", 3) + [99], dtype=np.int32)
    keys = pc.insert(a, row, alloc, "a", 4, ())
    mk, mp = pc.match(b)
    assert len(mk) == 1 and mp == [int(row[0])]
    pc.release(keys)
    pc.clear(alloc)
    alloc.free("a")
    alloc.check_no_leak()


def test_clear_refuses_referenced_entries_and_page_size_checked():
    pc = PrefixCache(4)
    alloc = PageAllocator(4)
    row = np.array(alloc.alloc("a", 2) + [0, 0], dtype=np.int32)
    with pytest.raises(ValueError, match="page_size"):
        pc.insert(np.arange(9, dtype=np.int32), row, alloc, "a", 8, ())
    pc.insert(np.arange(9, dtype=np.int32), row, alloc, "a", 4, ())
    with pytest.raises(RuntimeError, match="still referenced"):
        pc.clear(alloc)


def test_concurrent_insert_takes_a_reference_on_the_resident_page():
    """A sibling inserted the same chain between this request's match
    and its insert: with ``dedup=False`` the request takes a reference on
    the resident entry and keeps its private copy, freed with the
    request (the JAX cache's escape hatch; the fold is the default)."""
    pc = PrefixCache(4, dedup=False)
    alloc = PageAllocator(8)
    prompt = np.arange(9, dtype=np.int32)
    ra = np.array(alloc.alloc(1, 3), np.int32)
    rb = np.array(alloc.alloc(2, 3), np.int32)
    before = rb.copy()
    ka = pc.insert(prompt, ra, alloc, 1, 4, ())
    kb = pc.insert(prompt, rb, alloc, 2, 4, ())  # no match() between
    assert ka == kb and pc.total_pages() == 2
    assert [e.refcount for e in pc._entries.values()] == [2, 2]
    assert list(rb) == list(before)  # row untouched
    assert alloc.owners()[2] == tuple(int(p) for p in rb)
    occ = alloc.occupancy()
    assert occ["prefix_device"] == 2 and occ["inflight"] == 4
    assert occ["dedup"] == 0 and pc.dedup_hits == 0
    assert pc.tier_stats()["device"]["dedup_pages"] == 0
    pc.release(ka)
    pc.release(kb)
    alloc.free(1)
    alloc.free(2)
    pc.check_consistent(alloc)
    pc.clear(alloc)
    alloc.check_no_leak()


def test_check_consistent_catches_a_leaked_owner():
    pc = PrefixCache(4)
    alloc = PageAllocator(4)
    alloc.alloc("stray", 1)
    with pytest.raises(RuntimeError, match="page leak past drain"):
        pc.check_consistent(alloc)


# -- blobs and tiers ------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
def test_blob_roundtrip_byte_exact(int8):
    layers = _layers(int8=int8)
    back = unpack_page_blob(pack_page_blob(layers))
    assert len(back) == len(layers)
    for a, b in zip(layers, back):
        for x, y in zip(a, b):
            if x is None:
                assert y is None
                continue
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


def test_blob_corruption_is_typed():
    blob = pack_page_blob(_layers())
    for bad in (blob[:-1] + bytes([blob[-1] ^ 0xFF]), blob[:len(blob) // 2],
                b"XXXX" + blob[4:], b""):
        with pytest.raises(SpillCorrupt):
            unpack_page_blob(bad)
    with pytest.raises(ValueError, match="blob format"):
        pack_page_blob(_layers(), fmt="fp8")


def test_host_lru_byte_budget_eviction_order():
    t = HostSpillTier(100)
    t.put(b"a", b"x" * 40)
    t.put(b"b", b"y" * 40)
    assert t.get(b"a") is not None  # refresh a: b becomes LRU
    t.put(b"c", b"z" * 40)
    assert t.contains(b"a") and t.contains(b"c")
    assert not t.contains(b"b")
    assert t.dropped_blobs == 1 and t.occupancy_bytes == 80
    t.check_consistent()


def test_host_demotes_into_disk(tmp_path):
    disk = DiskSpillTier(str(tmp_path), 1000)
    host = HostSpillTier(50, next_tier=disk)
    host.put(b"a", b"x" * 40)
    host.put(b"b", b"y" * 40)  # a demoted to disk, not dropped
    assert not host.contains(b"a") and disk.contains(b"a")
    assert host.demoted_blobs == 1 and host.dropped_blobs == 0
    assert disk.get(b"a") == b"x" * 40
    host.put(b"c", b"z" * 80)  # oversize: skips the host tier
    assert not host.contains(b"c") and disk.contains(b"c")
    for t in (host, disk):
        t.check_consistent()
    disk.clear()
    assert disk.blob_count == 0
    assert not any(f.endswith(".kvblob") for f in os.listdir(tmp_path))


def test_disk_scrubs_stale_blobs_and_audits_dangling(tmp_path):
    (tmp_path / "deadbeef.kvblob").write_bytes(b"stale")
    (tmp_path / "cafe.kvblob.tmp").write_bytes(b"torn")
    disk = DiskSpillTier(str(tmp_path), 1000)
    assert disk.blob_count == 0
    assert not (tmp_path / "deadbeef.kvblob").exists()
    assert not (tmp_path / "cafe.kvblob.tmp").exists()
    disk.put(b"k", b"blob")
    disk.check_consistent()
    (tmp_path / "dangling.kvblob").write_bytes(b"x")
    with pytest.raises(RuntimeError, match="dangling"):
        disk.check_consistent()


def test_disk_vanished_file_degrades_to_miss(tmp_path):
    disk = DiskSpillTier(str(tmp_path), 1000)
    disk.put(b"k", b"blob")
    os.unlink(disk._path(b"k"))
    assert disk.get(b"k") is None
    assert not disk.contains(b"k")


def test_last_tier_eviction_survives_vanished_file(tmp_path):
    disk = DiskSpillTier(str(tmp_path), 100)
    disk.put(b"a", b"x" * 60)
    os.unlink(disk._path(b"a"))
    disk.put(b"b", b"y" * 60)
    assert disk.contains(b"b") and not disk.contains(b"a")
    assert disk.occupancy_bytes == 60
    disk.check_consistent()


# -- spill and restore over a fake device ----------------------------------------

class _FakeIO:
    """Page p, layer l holds the constant p*10+l: enough to see which
    blob lands where without a model."""

    def __init__(self):
        self.reads = 0
        self.calls = 0
        self.spliced = {}

    def read_page(self, page):
        self.reads += 1
        return [(np.full((4, 2, 3), page * 10 + l, np.float32),
                 np.full((4, 2, 3), page * 10 + l, np.float32),
                 None, None) for l in range(2)]

    def splice_page(self, pages, layers_list):
        self.calls += 1
        for p, layers in zip(pages, layers_list):
            self.spliced[p] = float(layers[0][0].flat[0])


def _unit_cache(**kw):
    pc = PrefixCache(4, **kw)
    io = _FakeIO()
    pc.attach_device_io(io.read_page, io.splice_page)
    return pc, io


def _seed(pc, alloc, prompt):
    """Insert the prompt's chain, release it, evict all (spill); returns
    (chain keys, the original row)."""
    n = pc._shareable_blocks(prompt)
    row = np.array(alloc.alloc("req", n + 1), dtype=np.int32)
    keys = pc.insert(prompt, row, alloc, "req", 4, ())
    pc.release(keys)
    alloc.free("req")
    assert pc.evict_until(alloc, alloc.num_pages)
    return keys, row


def test_evict_spills_then_restore_reallocates():
    pc, io = _unit_cache(spill_bytes=1 << 20)
    alloc = PageAllocator(8)
    prompt = np.arange(13, dtype=np.int32)  # 3 shareable blocks
    keys, row = _seed(pc, alloc, prompt)
    assert pc.spilled_pages == 3 and pc.tiers[0].blob_count == 3
    mk, _mp = pc.match(prompt)
    assert mk == ()
    rkeys, rpages, info = pc.restore_from_spill(prompt, mk, alloc)
    assert rkeys == keys and len(rpages) == 3
    assert info["host"] == 3 and info["ms"] > 0
    assert pc.tier_hit_pages["host"] == 3
    assert [io.spliced[p] for p in rpages] == \
        [float(row[i] * 10) for i in range(3)]
    assert io.calls == 1  # one batched splice for the run
    mk2, mp2 = pc.match(prompt)
    assert mk2 == keys and mp2 == rpages
    assert pc.hit_rate() == 0.5  # 3 restored over the seed's 3 misses
    pc.clear(alloc)
    alloc.check_no_leak()
    assert pc.tiers[0].blob_count == 0


def test_mid_chain_tier_miss_stops_restore():
    pc, _io = _unit_cache(spill_bytes=1 << 20)
    alloc = PageAllocator(8)
    prompt = np.arange(13, dtype=np.int32)
    keys, _ = _seed(pc, alloc, prompt)
    pc.tiers[0].remove(keys[1])
    rkeys, _, _ = pc.restore_from_spill(prompt, (), alloc)
    assert rkeys == keys[:1]
    pc.clear(alloc)
    alloc.check_no_leak()


def test_corrupt_blob_is_typed_counted_and_removed():
    pc, io = _unit_cache(spill_bytes=1 << 20)
    alloc = PageAllocator(8)
    prompt = np.arange(13, dtype=np.int32)
    keys, _ = _seed(pc, alloc, prompt)
    t = pc.tiers[0]
    blob = t._load(keys[0])
    t._blobs[keys[0]] = blob[:-1] + bytes([blob[-1] ^ 0xFF])
    rkeys, _, info = pc.restore_from_spill(prompt, (), alloc)
    assert rkeys == () and info["corrupt"] == 1
    assert pc.restore_corrupt == 1 and not t.contains(keys[0])
    assert not io.spliced
    pc.clear(alloc)
    alloc.check_no_leak()


def test_cache_spill_fault_write_and_read_sides():
    pc, _io = _unit_cache(spill_bytes=1 << 20)
    alloc = PageAllocator(8)
    prompt = np.arange(13, dtype=np.int32)
    fi.get_injector().arm("cache.spill", at_calls=[1])
    _seed(pc, alloc, prompt)
    assert pc.spill_failed == 1 and pc.tiers[0].blob_count == 2
    fi.reset()
    fi.get_injector().arm("cache.spill", probability=1.0)
    rkeys, _, _ = pc.restore_from_spill(prompt, (), alloc)
    assert rkeys == () and pc.spill_failed == 2
    fi.reset()
    pc.clear(alloc)
    alloc.check_no_leak()


def test_torn_spill_write_caught_by_crc_on_restore():
    pc, _io = _unit_cache(spill_bytes=1 << 20)
    alloc = PageAllocator(8)
    prompt = np.arange(13, dtype=np.int32)
    fi.get_injector().arm("cache.spill", at_calls=[1], mode="torn")
    keys, _ = _seed(pc, alloc, prompt)
    assert pc.tiers[0].blob_count == 3  # the torn blob WAS stored
    fi.reset()
    rkeys, _, info = pc.restore_from_spill(prompt, (), alloc)
    # leaf-first eviction: the torn first spill is the chain's tail
    assert rkeys == keys[:2] and info["corrupt"] == 1
    pc.clear(alloc)
    alloc.check_no_leak()


def test_reeviction_of_restored_page_is_a_touch_not_a_reread():
    pc, io = _unit_cache(spill_bytes=1 << 20)
    alloc = PageAllocator(8)
    prompt = np.arange(9, dtype=np.int32)
    _seed(pc, alloc, prompt)
    reads = io.reads
    rkeys, _, _ = pc.restore_from_spill(prompt, (), alloc)
    assert len(rkeys) == 2
    pc.evict_until(alloc, alloc.num_pages)
    assert io.reads == reads and pc.tiers[0].blob_count == 2
    pc.clear(alloc)
    alloc.check_no_leak()


def test_restore_under_pool_pressure_evicts_cold_chains():
    pc, _io = _unit_cache(spill_bytes=1 << 20)
    alloc = PageAllocator(4)
    a = np.arange(13, dtype=np.int32)
    keys, _ = _seed(pc, alloc, a)
    b = np.arange(100, 113, dtype=np.int32)
    rb = np.array(alloc.alloc("b", 4), np.int32)
    kb = pc.insert(b, rb, alloc, "b", 4, ())
    pc.release(kb)
    alloc.free("b")
    assert alloc.free_count == 1  # b's chain holds 3 of 4 pages
    rkeys, _, _ = pc.restore_from_spill(a, (), alloc)
    assert rkeys == keys and pc.evicted_pages >= 5
    pc.check_consistent(alloc)
    pc.clear(alloc)
    alloc.check_no_leak()


def test_tier_stats_and_disk_chain(tmp_path):
    pc, _io = _unit_cache(spill_bytes=500, spill_dir=str(tmp_path),
                          disk_bytes=1 << 20)
    alloc = PageAllocator(8)
    prompt = np.arange(13, dtype=np.int32)
    keys, _ = _seed(pc, alloc, prompt)
    host, disk = pc.tiers
    assert disk.blob_count > 0  # a blob is 430 B: the host holds one
    rkeys, _, info = pc.restore_from_spill(prompt, (), alloc)
    assert rkeys == keys and info["host"] + info["disk"] == 3
    ts = pc.tier_stats()
    assert set(ts) == {"device", "host", "disk"}
    assert ts["host"]["hit_pages"] + ts["disk"]["hit_pages"] == 3
    pc.check_consistent(alloc)
    pc.clear(alloc)
    alloc.check_no_leak()
    assert not any(f.endswith(".kvblob") for f in os.listdir(tmp_path))


# -- the dedup fold (``tests/test_kv_substrate.py:261-360``) ---------------------

def _two_requests(pc_cls, alloc_cls, dedup=True, ledger=None):
    """Two unrelated requests with the same 2-block prompt, both
    prefilled privately: the second insert meets the first's entries."""
    pc = pc_cls(4, dedup=dedup)
    alloc = alloc_cls(10, ledger=ledger)
    prompt = np.arange(9, dtype=np.int32)  # 2 full blocks + 1
    rows, keys = {}, {}
    for rid in (1, 2):
        rows[rid] = np.array(alloc.alloc(rid, 3), dtype=np.int32)
        keys[rid] = pc.insert(prompt, rows[rid], alloc, rid, 4, ())
    return pc, alloc, rows, keys


def _both(dedup=True, ledger=False):
    from paddle_tpu.inference import PageAllocator as JaxAllocator
    from paddle_tpu.inference.page_ledger import PageLedger as JaxLedger
    from paddle_tpu_torch.inference import PageLedger
    port = _two_requests(PrefixCache, PageAllocator, dedup,
                         PageLedger() if ledger else None)
    ref = _two_requests(jpc.PrefixCache, JaxAllocator, dedup,
                        JaxLedger() if ledger else None)
    return port, ref


@pytest.mark.parametrize("dedup", [True, False])
def test_dedup_rows_books_and_occupancy_match_jax(dedup):
    (pc, alloc, rows, keys), (jc, ja, jrows, jkeys) = _both(dedup)
    assert keys == jkeys
    assert {r: v.tolist() for r, v in rows.items()} == \
        {r: v.tolist() for r, v in jrows.items()}
    assert alloc.owners() == ja.owners()
    assert alloc.occupancy() == ja.occupancy()
    assert pc.dedup_hits == jc.dedup_hits == (2 if dedup else 0)
    assert pc.tier_stats()["device"] == jc.tier_stats()["device"]
    assert [(e.refcount, e.dedup) for e in pc._entries.values()] == \
        [(e.refcount, e.dedup) for e in jc._entries.values()]


def test_dedup_fold_refcounts_and_frees_duplicates():
    pc, alloc, rows, keys = _two_requests(PrefixCache, PageAllocator)
    assert keys[2] == keys[1] and pc.dedup_hits == 2
    # request 2's row now points at the shared pages
    assert list(rows[2][:2]) == list(rows[1][:2])
    # the duplicates went back: 2 shared + 1 tail each = 4 held of 10
    assert alloc.free_count == 6
    owners = alloc.owners()
    for k in keys[1]:
        assert ("dedup", k) in owners and ("prefix", k) not in owners
    assert all(e.refcount == 2 and e.dedup for e in pc._entries.values())
    pc.release(keys[1])
    pc.release(keys[2])
    alloc.free(1)
    alloc.free(2)
    pc.check_consistent(alloc)


def test_dedup_eviction_at_refcount_zero_only():
    pc, alloc, rows, keys = _two_requests(PrefixCache, PageAllocator)
    alloc.free(1)
    alloc.free(2)
    assert not pc.evict_until(alloc, alloc.num_pages)
    pc.release(keys[1])
    assert not pc.evict_until(alloc, alloc.num_pages)
    pc.release(keys[2])
    assert all(e.refcount == 0 and e.dedup for e in pc._entries.values())
    assert pc.evict_until(alloc, alloc.num_pages)  # dedup owners free
    assert not pc._entries
    alloc.check_no_leak()


def test_dedup_ledger_reconciles_with_the_dedup_hit_reason():
    (pc, alloc, rows, keys), (_jc, ja, _jr, _jk) = _both(ledger=True)
    rec = alloc.ledger.reconcile(alloc)
    assert rec["ok"], rec
    assert rec == ja.ledger.reconcile(ja)
    reasons = [e.get("reason") for e in alloc.ledger.tail(16)]
    assert "dedup_hit" in reasons
    assert reasons == [e.get("reason") for e in ja.ledger.tail(16)]
    pc.release(keys[1])
    pc.release(keys[2])
    alloc.free(1)
    alloc.free(2)
    pc.clear(alloc)
    alloc.check_no_leak()
    rec = alloc.ledger.reconcile(alloc)
    assert rec["ok"] and rec["live_owners"] == 0


def test_check_consistent_catches_diverging_dedup_books():
    pc, alloc, rows, keys = _two_requests(PrefixCache, PageAllocator)
    pc.release(keys[1])
    pc.release(keys[2])
    alloc.free(1)
    alloc.free(2)
    next(iter(pc._entries.values())).dedup = False
    with pytest.raises(RuntimeError, match="dedup books diverge"):
        pc.check_consistent(alloc)
