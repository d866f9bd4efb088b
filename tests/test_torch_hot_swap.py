"""Weight hot-swap in the PyTorch port, on the CPU at gpt_tiny with the JAX
model's weights, mirroring ``tests/test_hot_swap.py`` (``TestChainKeySalt``,
``TestEngineSwap``, ``TestServerSwapOp``):

- ``ResilientCheckpointManager`` writes the JAX package's layout: a
  directory written by either package restores in the other, a torn write
  is skipped in both alike;
- the generation-salted chain keys are byte-equal to the JAX package's,
  and ``set_generation`` clears the cache and salts later roots;
- ``swap_weights`` validates before it touches a tensor: a structure,
  shape or dtype mismatch, the serving generation, a busy engine and an
  armed ``swap.apply`` are typed ``SwapFailed`` refusals with the old
  weights serving; a swap bumps the generation and serves exactly the new
  weights (bitwise a fresh port engine on them, and the JAX engine after
  its own swap of the same state), also under ``multi_step=4``; it copies
  in place and refuses weights that moved since a graph capture;
- the server's ``swap`` op end to end (a keyed reissue, a corrupt
  checkpoint), ``--checkpoint`` boot, ``--weight-generation``, and a
  resurrection after a swap keeps the generation.
"""

import _torch_threads  # noqa: F401

import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed import fault_inject as jfi
from paddle_tpu.distributed.resilience import (
    ResilientCheckpointManager as JaxManager)
from paddle_tpu.inference import create_decode_engine as jax_engine
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving.prefix_cache import PrefixCache as JaxPrefixCache
from paddle_tpu.serving.prefix_cache import _block_hash as jax_block_hash

from paddle_tpu_torch.core.monitor import StatRegistry
from paddle_tpu_torch.distributed import fault_inject as fi
from paddle_tpu_torch.distributed.resilience import (
    ResilientCheckpointManager)
from paddle_tpu_torch.inference import SwapFailed, create_decode_engine
from paddle_tpu_torch.inference.continuous_batching import PageAllocator
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn.layer import numpy_dtype
from paddle_tpu_torch.serving import (ServingMetrics, ServingServer,
                                      client_request)
from paddle_tpu_torch.serving import server as srv
from paddle_tpu_torch.serving.prefix_cache import BF16, PrefixCache
from paddle_tpu_torch.serving.prefix_cache import _block_hash

ENGINE_KW = dict(num_slots=2, page_size=8, max_seq_len=96, num_pages=12)
PROMPT = list(range(1, 20))


@pytest.fixture(scope="module", autouse=True)
def _single_device_jax():
    """The JAX models of this file on one device, whatever ran before in
    the worker (``tests/test_torch_train_surface.py``'s guard, held for
    the module so the module fixtures' JAX models are built under it)."""
    from paddle_tpu.distributed.topology import (
        get_hybrid_communicate_group, set_hybrid_communicate_group)
    prev = get_hybrid_communicate_group()
    set_hybrid_communicate_group(None)
    try:
        yield
    finally:
        set_hybrid_communicate_group(prev)


@pytest.fixture(autouse=True)
def _clean_injectors():
    fi.reset()
    jfi.reset()
    yield
    fi.reset()
    jfi.reset()


@pytest.fixture(scope="module")
def states():
    """(A, B): the JAX seed-0 gpt_tiny weights and a perturbed copy, as
    host numpy."""
    pt.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    a = jgpt.checkpoint_state(jm)
    return a, jgpt.perturbed_state(a, scale=1e-2, seed=1)


def _model(state):
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    tgpt.load_jax_state(tm, state)
    return tm


def _engine(m, **kw):
    return create_decode_engine(m, device="cpu", **dict(ENGINE_KW, **kw))


def _run(eng, prompt=PROMPT, max_new=6):
    rid = eng.submit(np.asarray(prompt, np.int32), max_new)
    return [int(t) for t in eng.run()[rid][len(prompt):]]


def _greedy(state, **kw):
    eng = _engine(_model(state), **kw)
    out = _run(eng)
    eng.close()
    return out


@pytest.fixture(scope="module")
def ref(states):
    """Greedy tokens of fresh port engines on A and on B."""
    a, b = states
    out = _greedy(a), _greedy(b)
    assert out[0] != out[1], "B must be observable against A"
    return out


def _tree(states):
    a, _ = states
    names = sorted(a)[:3]
    return {"weights": {n: a[n] for n in names}, "step": 7,
            "tags": ["a", 2, None], "pair": (np.arange(3), 1.5)}


def _assert_tree_equal(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert got == want


# ---------------------------------------------------------------------------
# ResilientCheckpointManager: the JAX package's layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_across_packages(states, tmp_path, writer):
    tree = _tree(states)
    w, r = ((JaxManager, ResilientCheckpointManager) if writer == "jax"
            else (ResilientCheckpointManager, JaxManager))
    w(str(tmp_path)).save(3, tree)
    step_dir = tmp_path / "step_00000003"
    assert sorted(os.listdir(step_dir)) == [
        "arr_0000.npy", "arr_0001.npy", "arr_0002.npy", "arr_0003.npy",
        "manifest.json"]
    step, got = r(str(tmp_path)).restore_latest_valid()
    assert step == 3
    _assert_tree_equal(got, tree)


def test_torn_write_is_skipped_like_jax(states, tmp_path):
    tree = _tree(states)
    skipped = []
    for mgr_cls, inj in ((ResilientCheckpointManager, fi),
                         (JaxManager, jfi)):
        d = tmp_path / mgr_cls.__module__.split(".")[0]
        mgr = mgr_cls(str(d))
        mgr.save(1, tree)
        inj.get_injector().arm("checkpoint.write", at_calls=[1],
                               mode="torn")
        mgr.save(2, tree)  # acknowledged, but one shard landed torn
        inj.reset()
        assert not mgr.validate(2) and mgr.validate(1)
        step, got = mgr.restore_latest_valid()
        assert step == 1
        _assert_tree_equal(got, tree)
        skipped.append(list(mgr.last_skipped))
    assert skipped[0] == skipped[1] == [2]


def test_rotation_keeps_n_and_scrubs_stale_tmp_like_jax(states, tmp_path):
    tree = _tree(states)
    kept = []
    for mgr_cls in (ResilientCheckpointManager, JaxManager):
        d = tmp_path / mgr_cls.__module__.split(".")[0]
        os.makedirs(d / ".tmp-step_00000009-1-1")  # a crashed writer's
        mgr = mgr_cls(str(d), keep_n=2)
        for step in range(1, 6):
            mgr.save(step, tree)
        kept.append((mgr.all_steps(), sorted(os.listdir(d))))
    assert kept[0] == kept[1]
    assert kept[0][0] == [4, 5]


# ---------------------------------------------------------------------------
# Generation-salted chain keys
# ---------------------------------------------------------------------------

def test_root_salt_versions_the_whole_chain():
    blk = np.arange(8, dtype=np.int32)
    child = np.arange(8, 16, dtype=np.int32)
    for gen in (0, 1, 2, 2 ** 40):
        assert _block_hash(None, blk, generation=gen) == \
            jax_block_hash(None, blk, generation=gen)
    base = _block_hash(None, blk)
    g1 = _block_hash(None, blk, generation=1)
    assert base == _block_hash(None, blk, generation=0) and base != g1
    # children inherit the salt through the parent digest only
    assert _block_hash(base, child) != _block_hash(g1, child)
    assert _block_hash(g1, child, generation=7) == _block_hash(g1, child)
    assert _block_hash(g1, child) == jax_block_hash(g1, child)


def test_set_generation_clears_and_salts_like_jax(tmp_path):
    prompt = np.arange(1, 30, dtype=np.int32)
    keys = []
    for cache_cls, alloc in ((PrefixCache, PageAllocator(16)),
                             (JaxPrefixCache, None)):
        if alloc is None:
            from paddle_tpu.inference.continuous_batching import (
                PageAllocator as JaxAllocator)
            alloc = JaxAllocator(16)
        pc = cache_cls(8, spill_bytes=1 << 20)
        row = np.asarray(alloc.alloc(0, 4), np.int32)
        pc.release(pc.insert(prompt, row, alloc, 0, 8, ()))
        alloc.free(0)
        before = pc.chain_keys_for(prompt)
        assert pc.total_pages() == 3
        pc.set_generation(1, alloc)
        assert pc.total_pages() == 0 and pc.generation == 1
        assert alloc.free_count == 16  # every cached page returned
        assert all(t.blob_count == 0 for t in pc.tiers)
        pc.set_generation(1, alloc)  # the same generation: a no-op
        after = pc.chain_keys_for(prompt)
        assert after != before and len(after) == len(before)
        keys.append((before, after))
    assert keys[0] == keys[1]


# ---------------------------------------------------------------------------
# Engine swap_weights
# ---------------------------------------------------------------------------

def test_checkpoint_state_is_a_snapshot(states):
    """On the CPU ``.cpu()`` returns the tensor itself: the snapshot must
    copy, or loading other weights would rewrite it (the JAX package's
    ``checkpoint_state`` gives immutable values)."""
    a, b = states
    tm = _model(a)
    snap = tgpt.checkpoint_state(tm)
    tgpt.load_jax_state(tm, b)
    assert all(np.array_equal(snap[k], a[k]) for k in a)


def test_identity_swap_is_bitwise_and_bumps_generation(states, ref):
    a, _ = states
    tm = _model(a)
    eng = _engine(tm)
    assert _run(eng) == ref[0]
    ptrs = {n: t.data_ptr() for n, t in tm.state_dict().items()}
    info = eng.swap_weights(tgpt.checkpoint_state(tm))
    assert info["generation"] == 1 and info["leaves"] == len(a)
    assert info["swap_ms"] >= 0
    assert eng.weight_generation == 1 and eng.weight_swaps == 1
    # applied in place: every tensor keeps its storage
    assert ptrs == {n: t.data_ptr() for n, t in tm.state_dict().items()}
    assert _run(eng) == ref[0]
    eng.close()


def test_perturbed_swap_serves_exactly_the_new_weights(states, ref):
    a, b = states
    eng = _engine(_model(a), prefix_cache=PrefixCache(8))
    assert _run(eng) == ref[0]
    eng.swap_weights(b, generation=5)
    assert eng.weight_generation == 5
    assert eng._prefix_cache.generation == 5
    got = _run(eng)
    assert got == ref[1]
    eng.close()
    # the JAX engine after its own swap of the same state
    pt.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    jm.eval()
    jeng = jax_engine(jm, **ENGINE_KW)
    jeng.swap_weights(b, generation=5)
    rid = jeng.submit(np.asarray(PROMPT, np.int32), 6)
    want = [int(t) for t in jeng.run()[rid][len(PROMPT):]]
    jeng.close()
    assert got == want


def _mismatch(state, kind):
    bad = dict(state)
    name = sorted(bad)[0]
    if kind == "missing":
        del bad[name]
    elif kind == "extra":
        bad["not_a_real_leaf"] = np.zeros(3, np.float32)
    elif kind == "shape":
        bad[name] = np.zeros(tuple(s + 1 for s in bad[name].shape),
                             bad[name].dtype)
    else:
        bad[name] = bad[name].astype(np.float64)
    return bad


@pytest.mark.parametrize("kind,match", [
    ("missing", "structure mismatch"), ("extra", "structure mismatch"),
    ("shape", "tree mismatch"), ("dtype", "tree mismatch")])
def test_mismatch_refused_typed_old_weights_serve(states, ref, kind,
                                                  match):
    a, b = states
    tm = _model(a)
    eng = _engine(tm)
    with pytest.raises(SwapFailed, match=match):
        eng.swap_weights(_mismatch(b, kind))
    assert eng.weight_generation == 0 and eng.weight_swaps == 0
    assert all(np.array_equal(t.numpy(), a[n])
               for n, t in tm.state_dict().items())
    assert _run(eng) == ref[0]
    eng.close()


def test_same_generation_and_busy_engine_refused(states):
    a, b = states
    eng = _engine(_model(a))
    with pytest.raises(SwapFailed, match="already serving"):
        eng.swap_weights(b, generation=0)
    eng.submit(np.asarray(PROMPT, np.int32), 4)
    eng.step()  # admits: an active slot pins the old weights
    assert eng.num_active > 0
    with pytest.raises(SwapFailed, match="busy"):
        eng.swap_weights(b)
    eng.run()
    eng.close()


def test_armed_swap_apply_leaves_every_tensor_untouched(states, ref):
    a, b = states
    tm = _model(a)
    eng = _engine(tm)
    fi.get_injector().arm("swap.apply", at_calls=[1])
    with pytest.raises(fi.InjectedFault):
        eng.swap_weights(b)
    assert eng.weight_generation == 0
    assert all(np.array_equal(t.numpy(), a[n])
               for n, t in tm.state_dict().items())
    assert _run(eng) == ref[0]
    eng.close()


def test_swap_under_multi_step_keeps_the_launch_path(states, ref):
    a, b = states
    eng = _engine(_model(a), multi_step=4)
    assert _run(eng) == ref[0]
    eng.swap_weights(b)
    assert _run(eng) == ref[1]
    assert eng.programs_launched["decode_multi"] >= 2
    eng.close()


def test_weights_moved_since_capture_are_refused(states):
    """A captured graph reads each weight at its capture address; a swap
    into a model whose Parameter was replaced since would leave the graph
    on the old storage, so it is refused before any copy."""
    a, b = states
    tm = _model(a)
    eng = _engine(tm)
    # what the first graph capture records (on the card)
    eng._graph_weight_ptrs = {n: t.data_ptr()
                              for n, t in tm.state_dict().items()}
    tm.gpt.wpe.weight = torch.nn.Parameter(tm.gpt.wpe.weight.clone())
    with pytest.raises(SwapFailed, match="moved since the iteration"):
        eng.swap_weights(b)
    assert eng.weight_generation == 0
    eng.close()


def test_bf16_model_swaps_bf16_bit_patterns(states):
    a, b = states
    tm = _model(a).to(torch.bfloat16)
    eng = _engine(tm)
    want = tgpt.checkpoint_state(_model(b).to(torch.bfloat16))
    assert all(v.dtype == BF16 for v in want.values()
               if v.dtype.kind == "V")
    assert numpy_dtype(torch.bfloat16) == BF16
    with pytest.raises(SwapFailed, match="dtype float32 vs torch.bfloat16"):
        eng.swap_weights(b)  # fp32 arrays into a bf16 model
    eng.swap_weights(want)
    got = tgpt.checkpoint_state(tm)
    assert all(got[k].tobytes() == want[k].tobytes() for k in want)
    ref_eng = _engine(_model(b).to(torch.bfloat16))
    assert _run(eng) == _run(ref_eng)
    eng.close()
    ref_eng.close()


# ---------------------------------------------------------------------------
# Server swap op, boot checkpoint, resurrection
# ---------------------------------------------------------------------------

def _serve(m, **kw):
    merged = dict(ENGINE_KW)
    merged.update(kw)
    merged.setdefault("metrics", ServingMetrics(registry=StatRegistry()))
    return ServingServer(m, device="cpu", **merged)


def _gen(port, **extra):
    return client_request("127.0.0.1", port,
                          dict({"op": "generate", "prompt": PROMPT,
                                "max_new_tokens": 6}, **extra),
                          timeout_s=120)


def test_swap_op_end_to_end_keyed_reissue_serves_new_weights(
        states, ref, tmp_path):
    a, b = states
    ResilientCheckpointManager(str(tmp_path / "ck")).save(1, b)
    s = _serve(_model(a))
    port = s.start()
    try:
        r0 = _gen(port, key="swap-k0")
        assert r0["generated"] == ref[0]
        rep = client_request("127.0.0.1", port,
                             {"op": "swap", "checkpoint": str(tmp_path / "ck"),
                              "generation": 1}, timeout_s=120)
        assert rep["ok"] and rep["generation"] == 1, rep
        assert rep["outcome"] == "committed" and rep["swap_ms"] >= 0
        st = client_request("127.0.0.1", port, {"op": "stats"})
        assert st["weight_generation"] == 1 and st["weight_swaps"] == 1
        health = client_request("127.0.0.1", port, {"op": "health"})
        assert health["weight_generation"] == 1
        # the same prompt after the swap misses the old generation's
        # pages: the reply is the new weights', never spliced old KV
        hits = s.prefix_cache.hit_pages
        r1 = _gen(port, key="swap-k0")
        assert r1["generated"] == ref[1]
        assert s.prefix_cache.hit_pages == hits
        text = client_request("127.0.0.1", port, {"op": "metrics"})["text"]
        assert "serving_weight_generation 1" in text
        assert 'weight_swaps_total{outcome="committed"} 1' in text
        assert "serving_swap_ms_count 1" in text
    finally:
        s.stop()
    s.engine.allocator.check_no_leak()


def test_corrupt_checkpoint_refused_old_weights_keep_serving(
        states, ref, tmp_path):
    a, b = states
    ck = tmp_path / "ck-bad"
    ResilientCheckpointManager(str(ck)).save(1, b)
    step_dir = ck / "step_00000001"
    shard = sorted(f for f in os.listdir(step_dir) if f.endswith(".npy"))[0]
    with open(step_dir / shard, "r+b") as f:
        f.seek(os.path.getsize(step_dir / shard) // 2)
        f.write(b"\xff" * 16)
    s = _serve(_model(a))
    port = s.start()
    try:
        assert _gen(port)["generated"] == ref[0]
        rep = client_request("127.0.0.1", port,
                             {"op": "swap", "checkpoint": str(ck)})
        assert rep["error"] == "SwapFailed"
        assert "no valid checkpoint" in rep["reason"]
        rep = client_request("127.0.0.1", port,
                             {"op": "swap",
                              "checkpoint": str(tmp_path / "nope")})
        assert rep["error"] == "SwapFailed"
        for bad in ({"op": "swap"},
                    {"op": "swap", "checkpoint": str(ck), "generation": -1},
                    {"op": "swap", "checkpoint": str(ck), "timeout_s": 0}):
            assert client_request("127.0.0.1", port,
                                  bad)["error"] == "BadRequest"
        st = client_request("127.0.0.1", port, {"op": "stats"})
        assert st["weight_generation"] == 0
        assert st["stats"]["counters"]["weight_swaps_failed_total"] == 2
        assert _gen(port)["generated"] == ref[0]
    finally:
        s.stop()
    s.engine.allocator.check_no_leak()


def test_boot_checkpoint_and_weight_generation(states, ref, tmp_path):
    a, b = states
    ResilientCheckpointManager(str(tmp_path / "ck")).save(4, b)
    s = _serve(_model(a), checkpoint=str(tmp_path / "ck"),
               weight_generation=3)
    assert s.engine.weight_generation == 3
    assert s.prefix_cache.generation == 3
    port = s.start()
    try:
        assert _gen(port)["generated"] == ref[1]
        health = client_request("127.0.0.1", port, {"op": "health"})
        assert health["weight_generation"] == 3
        assert health["weight_swaps"] == 0
    finally:
        s.stop()
    # a missing or corrupt boot checkpoint fails construction typed
    with pytest.raises(SwapFailed, match="no valid checkpoint"):
        _serve(_model(a), checkpoint=str(tmp_path / "missing"))
    JaxManager(str(tmp_path / "short")).save(1, {"gpt.wte.weight":
                                                 a["gpt.wte.weight"]})
    with pytest.raises(ValueError, match="does not match the model"):
        _serve(_model(a), checkpoint=str(tmp_path / "short"))


def test_cli_checkpoint_generation_forecast_and_ledger_flags(monkeypatch):
    made = {}

    class Stop(Exception):
        pass

    class Fake:
        def __init__(self, model, **kw):
            made.update(kw)
            raise Stop

    monkeypatch.setattr(srv, "ServingServer", Fake)
    monkeypatch.setattr(srv, "build_model", lambda name, dev: None)
    with pytest.raises(Stop):
        srv.main(["--device", "cpu", "--checkpoint", "/ck",
                  "--weight-generation", "7", "--forecast-admission",
                  "--no-page-ledger"])
    assert made["checkpoint"] == "/ck" and made["weight_generation"] == 7
    assert made["forecast_admission"] is True
    assert made["page_ledger"] is False
    made.clear()
    with pytest.raises(Stop):
        srv.main(["--device", "cpu"])
    assert made["checkpoint"] is None and made["weight_generation"] == 0
    assert "forecast_admission" not in made and "page_ledger" not in made


def test_resurrection_after_swap_keeps_the_generation(states, ref,
                                                      tmp_path):
    """The recipe a resurrected engine is rebuilt from carries the
    generation the swap moved to; the model already holds the swapped
    weights, so the rebuilt engine serves them."""
    a, b = states
    ResilientCheckpointManager(str(tmp_path / "ck")).save(1, b)
    s = _serve(_model(a), max_engine_errors=1)
    port = s.start()
    try:
        rep = client_request("127.0.0.1", port,
                             {"op": "swap", "checkpoint": str(tmp_path / "ck"),
                              "generation": 2}, timeout_s=120)
        assert rep["generation"] == 2
        old = s.engine
        fi.get_injector().arm("engine.step", at_calls=[1])
        assert _gen(port)["generated"] == ref[1]
        assert s.engine is not old
        health = client_request("127.0.0.1", port, {"op": "health"})
        assert health["engine_restarts"] == 1
        assert health["weight_generation"] == 2
        assert s.engine.weight_generation == 2
        assert s.prefix_cache.generation == 2
    finally:
        s.stop()
