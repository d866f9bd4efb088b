"""``GPTForCausalLM.generate`` and weight-only int8 in the PyTorch port, on
the CPU at gpt_tiny with the JAX model's weights (``load_jax_state``),
mirroring ``tests/test_paged_attention.py:183-270`` and
``tests/test_quant_sparsity_text.py:157-194``:

- greedy tokens equal the JAX package's same call: the eager loop, the
  one-launch mode over static, paged and int8-paged caches, and the
  chunked mode (the JAX paged modes run their dense-gather reference on
  the CPU, as its own tests do);
- the static cache's logits after a prefill and decode steps against
  JAX's ``forward(ids, caches=StaticKVCache...)``;
- the port's own pins, bitwise: paged equals static over 64 steps,
  chunked equals whole before and after a conversion (whose new state
  adds a second ``_chunked_jit_cache`` entry), int8 pages agree;
- ``generate``'s ``ValueError``s, and sampling: a seed gives one
  stream, ``top_k=1`` is greedy, every token lies in its step's top k
  (torch generators and JAX keys draw differently, so sampled streams
  are not compared across the packages);
- ``WeightOnlyInt8Linear`` / ``convert_to_weight_only_int8`` against
  JAX's: int8 weights and scales byte-equal, outputs, counts, logits,
  tokens, a converted JAX state through ``load_jax_state``, the head and
  out-projection gates declining a converted layer, and the engine
  serving a converted model equal to the JAX engine.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.inference import create_decode_engine as jax_engine
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.quantization import quant as jquant

from paddle_tpu_torch.inference import create_decode_engine
from paddle_tpu_torch.inference.graphs import WeightWatch
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.quantization import quant as tquant

# (name, prompt) pairs: B = 1 and 2, prompts of 9 and 6 tokens
PROMPTS = {
    "b1s9": (np.arange(9, dtype=np.int32) * 5 % 100)[None],
    "b2s6": np.stack([np.arange(6, dtype=np.int32) * 7 % 100,
                      np.arange(6, dtype=np.int32) * 3 % 100 + 1]),
}
# new tokens by mode: 64 for the one-launch modes (test_paged_attention);
# JAX's eager loop compiles every op anew for each prompt shape (~8 s a
# call here) and its chunked mode launches a program a layer and token,
# so those two take fewer
NEW = {"eager": 3, "chunked": 10}
DEFAULT_NEW = 64
MODES = {
    "eager": {},
    "static": dict(use_jit=True),
    "paged": dict(use_jit=True, kv_cache="paged", page_size=8),
    "paged_int8": dict(use_jit=True, kv_cache="paged_int8", page_size=8),
    "chunked": dict(use_jit=True, compile_mode="chunked"),
}
ENGINE_KW = dict(num_slots=2, page_size=8, max_seq_len=64, num_pages=12)


@pytest.fixture(scope="module", autouse=True)
def _single_device_jax():
    """The JAX models of this file on one device, whatever ran before in
    the worker (``tests/test_torch_hot_swap.py``'s guard)."""
    from paddle_tpu.distributed.topology import (
        get_hybrid_communicate_group, set_hybrid_communicate_group)
    prev = get_hybrid_communicate_group()
    set_hybrid_communicate_group(None)
    try:
        yield
    finally:
        set_hybrid_communicate_group(prev)


def _jax_model(**cfg_kw):
    pt.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny(**cfg_kw))
    jm.eval()
    return jm


def _port_model(state, **cfg_kw):
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(**cfg_kw), device="cpu")
    tgpt.load_jax_state(tm, state)
    return tm


@pytest.fixture(scope="module")
def jm():
    return _jax_model()


@pytest.fixture(scope="module")
def state(jm):
    return jgpt.checkpoint_state(jm)


@pytest.fixture(scope="module")
def tm(state):
    return _port_model(state)


@pytest.fixture(scope="module")
def jax_tokens(jm):
    """JAX's greedy tokens by (mode, prompt), computed once a key."""
    memo = {}

    def get(mode, name):
        if (mode, name) not in memo:
            out = jm.generate(pt.Tensor(PROMPTS[name]),
                              max_new_tokens=NEW.get(mode, DEFAULT_NEW),
                              temperature=0.0, **MODES[mode])
            memo[mode, name] = np.asarray(out.value)
        return memo[mode, name]

    return get


def _greedy(model, name, mode, n=None):
    if n is None:
        n = NEW.get(mode, DEFAULT_NEW)
    return model.generate(PROMPTS[name], max_new_tokens=n, temperature=0.0,
                          **MODES[mode]).numpy()


# ---------------------------------------------------------------------------
# Greedy tokens against JAX
# ---------------------------------------------------------------------------

# the eager loop at B=2 only: test_eager_equals_one_launch holds it at B=1
@pytest.mark.parametrize("mode,name", [
    (mode, name) for mode in sorted(MODES) for name in sorted(PROMPTS)
    if (mode, name) != ("eager", "b1s9")])
def test_greedy_tokens_match_jax(tm, jax_tokens, mode, name):
    got = _greedy(tm, name, mode)
    want = jax_tokens(mode, name)
    b, s = PROMPTS[name].shape
    assert got.shape == want.shape == (b, s + NEW.get(mode, DEFAULT_NEW))
    np.testing.assert_array_equal(got, want)


def test_static_cache_logits_match_jax(jm, tm):
    """A prefill and three decode steps through ``StaticKVCache`` in both
    packages: the logits within 1e-5 relative, ``pos`` advanced."""
    ids = PROMPTS["b2s6"]
    b, s = ids.shape
    cfg = tm.config
    total = s + 4
    shape = (b, total, cfg.num_heads, cfg.head_dim)
    jc = [jgpt.StaticKVCache(jnp.zeros(shape, jnp.float32),
                             jnp.zeros(shape, jnp.float32),
                             jnp.asarray(0, jnp.int32))
          for _ in range(cfg.num_layers)]
    tc = [tgpt.static_cache_create(b, total, cfg.num_heads, cfg.head_dim,
                                   torch.float32, device="cpu")
          for _ in range(cfg.num_layers)]
    x = ids
    with torch.no_grad():
        for step in range(4):
            jl, jc = jm(pt.Tensor(x), caches=jc)
            tl, tc = tm(torch.as_tensor(x).long(), caches=tc)
            want = np.asarray(jl.value)
            got = tl.numpy()
            rel = np.abs(got - want).max() / np.abs(want).max()
            assert rel < 1e-5, (step, rel)
            assert int(tc[0].pos) == s + step == int(jc[0].pos)
            x = want[:, -1].argmax(-1).astype(np.int32)[:, None]


# ---------------------------------------------------------------------------
# The port's own pins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PROMPTS))
def test_eager_equals_one_launch(tm, name):
    np.testing.assert_array_equal(_greedy(tm, name, "eager", 16),
                                  _greedy(tm, name, "static", 16))


def test_paged_equals_static_64_steps(tm):
    np.testing.assert_array_equal(_greedy(tm, "b1s9", "paged"),
                                  _greedy(tm, "b1s9", "static"))


def test_chunked_equals_whole(tm):
    np.testing.assert_array_equal(_greedy(tm, "b2s6", "chunked", 10),
                                  _greedy(tm, "b2s6", "static", 10))


def test_paged_int8_agrees_with_paged(tm, jax_tokens):
    q = _greedy(tm, "b1s9", "paged_int8", 32)
    f = _greedy(tm, "b1s9", "paged", 32)
    assert (q == f).mean() > 0.8
    np.testing.assert_array_equal(q, jax_tokens("paged_int8", "b1s9")[:,
                                                                     :41])


def test_chunked_after_int8_conversion(state):
    """Chunked on the float model, convert in place, chunked again:
    bitwise the whole mode on the converted model, and the structure
    change adds a second callables entry (each block's int8 buffers are
    bound per layer)."""
    m = _port_model(state)
    fp = _greedy(m, "b1s9", "chunked", 6)
    assert tquant.convert_to_weight_only_int8(m) == 8
    got = _greedy(m, "b1s9", "chunked", 6)
    np.testing.assert_array_equal(got, _greedy(m, "b1s9", "static", 6))
    assert len(m._chunked_jit_cache) == 2
    assert fp.shape == got.shape


def test_conversion_rebuilds_the_one_launch_program(state):
    """A program built before a conversion reads the old weights: the
    ``WeightWatch`` sees the swapped layers and the next call builds a
    new program, whose tokens are the converted model's."""
    m = _port_model(state)
    _greedy(m, "b1s9", "static", 6)
    (old,) = m._gen_programs.values()
    assert not old.watch.moved()
    tquant.convert_to_weight_only_int8(m)
    assert old.watch.moved()
    got = _greedy(m, "b1s9", "static", 6)
    (new,) = m._gen_programs.values()
    assert new is not old and old.caches == []
    np.testing.assert_array_equal(got, _greedy(m, "b1s9", "chunked", 6))


def test_generate_keeps_one_program_a_cache_kind(state):
    """A sweep over four signatures of each cache kind leaves one live
    program a kind, the newest; every program it dropped is closed (no
    caches, no graph), and a program built again for an old signature
    gives the tokens it gave before."""
    m = _port_model(state)
    kinds = ("static", "paged", "paged_int8")
    first = {}
    built = []
    for mode in kinds:
        for name, n in (("b1s9", 4), ("b1s9", 6), ("b2s6", 4),
                        ("b2s6", 6)):
            toks = _greedy(m, name, mode, n)
            first.setdefault(mode, toks)
            live = list(m._gen_programs.values())
            built.extend(p for p in live if p not in built)
            assert sorted(p.kv_cache for p in live) == sorted(
                kinds[:kinds.index(mode) + 1])
    assert len(built) == 12
    live = list(m._gen_programs.values())
    assert len(live) == 3
    for p in built:
        if p not in live:
            assert p.caches == [] and p.graphs is None
    for mode in kinds:
        np.testing.assert_array_equal(_greedy(m, "b1s9", mode, 4),
                                      first[mode])
    assert len(m._gen_programs) == 3
    m.clear_generate_cache()
    assert not getattr(m, "_gen_programs", {})


def test_weight_watch_moves_on_replacement_not_on_copy(state):
    m = _port_model(state)
    watch = WeightWatch(m)
    tgpt.load_jax_state(m, state)  # in place: the same storage
    assert not watch.moved()
    w = m.gpt.h[1].mlp.fc_in.weight
    w.data = w.data.clone()  # the same Parameter, other storage
    assert watch.moved()


@pytest.mark.parametrize("kwargs,words", [
    (dict(kv_cache="dense"), "unknown kv_cache"),
    (dict(compile_mode="scan"), "unknown compile_mode"),
    (dict(kv_cache="paged"), "requires use_jit"),
    (dict(compile_mode="chunked"), "requires use_jit"),
    (dict(use_jit=True, kv_cache="paged_int8", compile_mode="chunked"),
     "StaticKVCache only"),
])
def test_generate_argument_errors(tm, jm, kwargs, words):
    ids = PROMPTS["b1s9"]
    with pytest.raises(ValueError, match=words):
        jm.generate(pt.Tensor(ids), max_new_tokens=2, **kwargs)
    with pytest.raises(ValueError, match=words):
        tm.generate(ids, max_new_tokens=2, **kwargs)


def test_zero_new_tokens_returns_the_prompt(tm):
    ids = PROMPTS["b2s6"]
    assert tm.generate(ids, max_new_tokens=0) is ids


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _sampled(tm, mode, seed, temperature=0.8, top_k=40, n=12):
    gen = torch.Generator().manual_seed(seed)
    return tm.generate(PROMPTS["b2s6"], max_new_tokens=n,
                       temperature=temperature, top_k=top_k, generator=gen,
                       **MODES[mode]).numpy()


@pytest.mark.parametrize("mode", ["eager", "static", "paged"])
def test_sampling_seed_gives_one_stream(tm, mode):
    a, b = _sampled(tm, mode, 7), _sampled(tm, mode, 7)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, _sampled(tm, mode, 8))


@pytest.mark.parametrize("mode", ["eager", "static"])
def test_top_k_1_is_greedy(tm, mode):
    np.testing.assert_array_equal(
        _sampled(tm, mode, 3, temperature=1.0, top_k=1),
        _greedy(tm, "b2s6", mode, 12))


@pytest.mark.parametrize("mode", ["eager", "static", "paged"])
def test_sampled_tokens_lie_in_the_top_k(tm, mode):
    """One forward over the generated sequence scores every step: each
    sampled token is among the top k of its step's logits."""
    k = 5
    out = _sampled(tm, mode, 11, temperature=1.5, top_k=k)
    s = PROMPTS["b2s6"].shape[1]
    with torch.no_grad():
        logits = tm(torch.as_tensor(out))
    kth = torch.topk(logits[:, s - 1:-1], k, dim=-1).values[..., -1]
    picked = torch.gather(logits[:, s - 1:-1], -1,
                          torch.as_tensor(out[:, s:])[..., None])[..., 0]
    assert bool((picked >= kth).all())


# ---------------------------------------------------------------------------
# Weight-only int8 against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def converted(state):
    """(JAX model, port model) both converted, and the two counts."""
    jc = _jax_model()
    n_jax = jquant.convert_to_weight_only_int8(jc)
    tc = _port_model(state)
    n_port = tquant.convert_to_weight_only_int8(tc)
    return jc, tc, n_jax, n_port


def test_conversion_counts_match_jax(converted):
    _, _, n_jax, n_port = converted
    assert n_port == n_jax == 4 * 2


def test_int8_buffers_byte_equal_jax(converted):
    jc, tc, _, _ = converted
    want = jgpt.checkpoint_state(jc)
    got = tc.state_dict()
    assert sorted(got) == sorted(want)
    for name in want:
        if name.endswith(("weight_int8", "weight_scale")):
            g = got[name].numpy()
            assert g.dtype == want[name].dtype, name
            assert g.tobytes() == np.asarray(want[name]).tobytes(), name


def test_converted_layer_output_matches_jax(converted):
    jc, tc, _, _ = converted
    x = np.random.default_rng(0).standard_normal((3, 5, 128)).astype(
        np.float32)
    want = np.asarray(jc.gpt.h[0].mlp.fc_in(pt.Tensor(x)).value)
    with torch.no_grad():
        got = tc.gpt.h[0].mlp.fc_in(torch.from_numpy(x)).numpy()
    assert isinstance(tc.gpt.h[0].mlp.fc_in, tquant.WeightOnlyInt8Linear)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_converted_logits_match_jax(converted, jm, tm):
    """The converted model within 1e-5 relative of the converted JAX
    model, and within 0.05 of the float model (the JAX test's bound)."""
    jc, tc, _, _ = converted
    ids = np.arange(2 * 16, dtype=np.int32).reshape(2, 16) % 1000
    want = np.asarray(jc(pt.Tensor(ids)).value)
    with torch.no_grad():
        got = tc(torch.as_tensor(ids).long()).numpy()
        fp = tm(torch.as_tensor(ids).long()).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
    assert np.abs(fp - got).max() / np.abs(fp).max() < 0.05


@pytest.mark.parametrize("mode", ["static", "paged"])
def test_converted_greedy_tokens_match_jax(converted, mode):
    """The converted out-projection fails the epilogue gate, so the paged
    mode takes the unfused composition, and the tokens are JAX's."""
    jc, tc, _, _ = converted
    assert tc.gpt.h[0].attn._fused_epilogue_params() is None
    want = np.asarray(jc.generate(
        pt.Tensor(PROMPTS["b1s9"]), max_new_tokens=16, temperature=0.0,
        **MODES[mode]).value)
    np.testing.assert_array_equal(_greedy(tc, "b1s9", mode, 16), want)


def test_load_jax_state_loads_a_converted_state(converted, state):
    """A float port model takes a converted JAX model's state: the
    matching layers convert first, then every byte loads."""
    jc, _, _, _ = converted
    want = jgpt.checkpoint_state(jc)
    m = _port_model(state)
    tgpt.load_jax_state(m, want)
    assert isinstance(m.gpt.h[1].attn.out_proj, tquant.WeightOnlyInt8Linear)
    for name, t in m.state_dict().items():
        assert t.numpy().tobytes() == np.asarray(want[name]).tobytes(), name


def test_converted_untied_head_takes_the_unfused_head():
    """An untied lm head converts too: ``head_params`` declines it, the
    one-launch mode samples from the logits, and the tokens are JAX's."""
    jc = _jax_model(tie_word_embeddings=False)
    tc = _port_model(jgpt.checkpoint_state(jc), tie_word_embeddings=False)
    assert tc.head_params() is not None
    assert jquant.convert_to_weight_only_int8(jc) == \
        tquant.convert_to_weight_only_int8(tc) == 4 * 2 + 1
    assert tc.head_params() is None
    for mode in ("static", "paged"):
        want = np.asarray(jc.generate(
            pt.Tensor(PROMPTS["b2s6"]), max_new_tokens=8, temperature=0.0,
            **MODES[mode]).value)
        np.testing.assert_array_equal(_greedy(tc, "b2s6", mode, 8), want)


@pytest.mark.parametrize("multi_step", [1, 4])
def test_engine_on_converted_model_matches_jax(converted, multi_step):
    jc, tc, _, _ = converted
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 1024, n).astype(np.int32)
               for n in (5, 9, 13)]

    def streams(eng):
        rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
        res = eng.run()
        eng.allocator.check_no_leak()
        eng.close()
        return [res[r].tolist() for r in rids]

    got = streams(create_decode_engine(tc, device="cpu", fused_step=True,
                                       multi_step=multi_step, **ENGINE_KW))
    want = streams(jax_engine(jc, fused_step=True, multi_step=multi_step,
                              **ENGINE_KW))
    assert got == want
