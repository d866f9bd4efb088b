"""Speculative decoding in the PyTorch port, against the JAX package's on
the CPU (gpt_tiny, the JAX model's weights carried over by
``load_jax_state``):

- the n-gram draft (host and device twin) and the greedy verify math
  (``speculative_verify_tokens``, ``fused_verify_tokens``) bitwise
  against the JAX functions on seeded inputs;
- ``verify_step`` logits within 1e-4 of the JAX model's, and each
  verify position's logits those of the vanilla decode step there;
- the speculative engine's greedy tokens equal to the port's vanilla
  engine bit for bit (n-gram, always-wrong, model draft, int8 pools, the
  prefix cache, EOS inside an accepted run) and to the JAX speculative
  engine's;
- rollback returns pages mid-flight and never touches shared prefix
  pages, an oversubscribed pool recycles, the ``serving.verify`` site
  retries a transient fault to the same tokens and cleans up after a
  persistent one, and the spec stats reach the metrics.

Mirrors ``tests/test_speculative.py`` where its cases apply.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.inference import SpeculativeConfig as JaxSpecConfig
from paddle_tpu.inference import create_decode_engine as jax_engine
from paddle_tpu.inference.speculative import ModelDraft as JaxModelDraft
from paddle_tpu.inference.speculative import NGramDraft as JaxNGramDraft
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.nn import decode as jdecode
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch.core.monitor import StatRegistry
from paddle_tpu_torch.distributed import fault_inject as fi
from paddle_tpu_torch.inference import (CallableDraft, ModelDraft,
                                        NGramDraft, PageAllocator,
                                        SelfDraft, SpeculativeConfig,
                                        as_spec_config,
                                        create_decode_engine,
                                        device_draft_params)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn import decode as tdecode
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.serving.prefix_cache import PrefixCache

VOCAB = 1024
LOGIT_TOL = 1e-4  # fp32 logits across the two packages (test_torch_gpt)


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


def _kw(**kw):
    base = dict(num_slots=2, page_size=8, max_seq_len=96, num_pages=12)
    base.update(kw)
    return base


def _engine(tm, **kw):
    return create_decode_engine(tm, device="cpu", **_kw(**kw))


def _prompts():
    """``tests/test_speculative.py:57-61``."""
    shared = (np.arange(19, dtype=np.int32) * 5) % 100
    return [np.concatenate([shared,
                            (np.arange(t, dtype=np.int32) + 3 * t) % 100])
            for t in (3, 5, 7, 9)]


def _run(tm, new_tokens=12, **kw):
    done = []
    eng = _engine(tm, on_complete=done.append, **kw)
    rids = [eng.submit(p, max_new_tokens=new_tokens) for p in _prompts()]
    out = eng.run()
    eng.close()
    eng.allocator.check_no_leak()
    return [out[r].tolist() for r in rids], done


@pytest.fixture(scope="module")
def vanilla(models):
    _, tm = models
    return _run(tm)[0]


def _wrong_draft():
    """(last + 7) mod vocab: wrong in practice for a random-weight
    model, the rejection storm the rollback tests lean on."""
    return CallableDraft(lambda h, k: [(int(h[-1]) + 7) % VOCAB] * k)


# -- drafts and the verify math against the JAX functions --------------------

def _histories(seed, n=6, hcap=40):
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 5, (n, hcap)).astype(np.int32)  # many repeats
    lens = rng.integers(1, hcap + 1, (n,)).astype(np.int32)
    lens[0] = 1  # a history with nothing earlier to match
    return hist, lens


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k,max_ngram,min_ngram", [(4, 3, 1), (3, 2, 2)])
def test_ngram_draft_tokens_match_jax_and_the_host_draft(seed, k, max_ngram,
                                                        min_ngram):
    hist, lens = _histories(seed)
    want = np.asarray(jdecode.ngram_draft_tokens(
        jnp.asarray(hist), jnp.asarray(lens), k, max_ngram, min_ngram))
    got = tdecode.ngram_draft_tokens(torch.from_numpy(hist),
                                     torch.from_numpy(lens), k, max_ngram,
                                     min_ngram)
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == want.tolist()
    hs = [hist[i, :lens[i]] for i in range(len(lens))]
    host = NGramDraft(max_ngram, min_ngram).propose(hs, k)
    assert host.tolist() == want.tolist()
    assert host.tolist() == \
        JaxNGramDraft(max_ngram, min_ngram).propose(hs, k).tolist()


def test_ngram_draft_examples():
    """``tests/test_speculative.py:162-179``."""
    d = NGramDraft(max_ngram=3)
    h = np.asarray([7, 8, 9, 1, 2, 3, 4, 5, 1, 2, 3], np.int32)
    assert d.propose([h], 4)[0].tolist() == [4, 5, 1, 2]
    assert d.propose([np.asarray([1, 2, 1, 2], np.int32)],
                     4)[0].tolist() == [1, 2, 2, 2]
    out = NGramDraft().propose([None, np.asarray([3, 1, 4], np.int32)], 3)
    assert out.tolist() == [[0, 0, 0], [4, 4, 4]]
    assert out.dtype == np.int32 and out.shape == (2, 3)


def _verify_case(seed, b=3, s=5, v=64, ties=True):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, s, v)).astype(np.float32)
    full = logits.argmax(-1)
    drafts = full[:, :-1].copy()
    drafts[1, 1:] = (drafts[1, 1:] + 1) % v  # row 1 rejects at 1
    if ties:
        logits[2, 0, 7] = logits[2, 0, 9] = logits[2, 0].max() + 1.0
    return logits, drafts.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_verify_tokens_match_jax(seed):
    logits, drafts = _verify_case(seed)
    ja, jr, jf, _ = jdecode.speculative_verify_tokens(
        jnp.asarray(logits), jnp.asarray(drafts), 0.0)
    ta, tr, tf = tdecode.speculative_verify_tokens(
        torch.from_numpy(logits), torch.from_numpy(drafts), 0.0)
    assert ta.numpy().tolist() == np.asarray(ja).tolist()
    assert tr.numpy().tolist() == np.asarray(jr).tolist()
    assert tf.numpy().tolist() == np.asarray(jf).tolist()
    assert int(tf[2, 0]) == 7  # the first index of the planted tie
    assert ta[0].all() and not ta[1, 1]


@pytest.mark.parametrize("transpose_y", [True, False])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_verify_tokens_match_jax(transpose_y, bias):
    rng = np.random.default_rng(3)
    b, s, d, v = 3, 5, 128, 300
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((v, d)) * 0.1).astype(np.float32)
    if not transpose_y:
        w = np.ascontiguousarray(w.T)
    bb = rng.standard_normal((v,)).astype(np.float32) if bias else None
    full = (hidden @ (w.T if transpose_y else w)
            + (0 if bb is None else bb)).argmax(-1)
    drafts = full[:, :-1].astype(np.int32)
    drafts[0, 2] = (drafts[0, 2] + 1) % v
    ja, jr, jf, _ = jdecode.fused_verify_tokens(
        jnp.asarray(hidden), jnp.asarray(drafts), jnp.asarray(w), 0.0,
        transpose_y=transpose_y,
        bias=None if bb is None else jnp.asarray(bb), tile=128)
    ta, tr, tf = tdecode.fused_verify_tokens(
        torch.from_numpy(hidden), torch.from_numpy(drafts),
        torch.from_numpy(w), 0.0, transpose_y=transpose_y,
        bias=None if bb is None else torch.from_numpy(bb), tile=128)
    assert tf.numpy().tolist() == np.asarray(jf).tolist() == full.tolist()
    assert ta.numpy().tolist() == np.asarray(ja).tolist()
    assert tr.numpy().tolist() == np.asarray(jr).tolist()


def test_verify_tokens_greedy_semantics():
    """``tests/test_speculative.py:115-127``."""
    lg = np.full((1, 3, 4), -5.0, np.float32)
    lg[0, 0, 2] = lg[0, 1, 0] = lg[0, 2, 3] = 5.0
    accept, resid, full = tdecode.speculative_verify_tokens(
        torch.from_numpy(lg), torch.tensor([[2, 1]], dtype=torch.int32), 0.0)
    assert full.tolist() == [[2, 0, 3]]
    assert accept.tolist() == [[True, False]]
    assert resid.tolist() == [[2, 0]]


def test_verify_tokens_residual_excludes_draft():
    rng = np.random.default_rng(0)
    lg = torch.from_numpy(rng.standard_normal((3, 4, 8)).astype(np.float32))
    drafts = torch.from_numpy(rng.integers(0, 8, (3, 3)).astype(np.int32))
    for seed in range(5):
        gen = torch.Generator().manual_seed(seed)
        _, resid, full = tdecode.speculative_verify_tokens(
            lg, drafts, 0.9, None, gen)
        # a residual draw never returns the rejected draft
        assert not (resid == drafts).any()
        assert tuple(full.shape) == (3, 4)
    # top-k: every full-distribution draw comes from its row's top 2
    gen = torch.Generator().manual_seed(1)
    _, _, full = tdecode.speculative_verify_tokens(lg, drafts, 0.7, 2, gen)
    top2 = torch.topk(lg, 2, dim=-1).indices
    assert (full[..., None] == top2).any(-1).all()


# -- verify_step ---------------------------------------------------------------

_PAGE, _MP = 8, 8


def _prefilled(tm, jm, prompts):
    """Both packages' paged caches with ``prompts`` prefilled, one slot
    each (a table of ``_MP`` pages a slot); ``jm=None`` prefills the
    port's alone (the JAX caches are then None)."""
    cfg = tm.config
    b = len(prompts)
    bucket = max(len(p) for p in prompts)
    ids = np.zeros((b, bucket), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    plen = np.array([len(p) for p in prompts], np.int32)
    n_pages = b * _MP
    tcs = [tgpt.paged_cache_create(b, n_pages, _PAGE, cfg.num_heads,
                                   cfg.head_dim, torch.float32, _MP)
           for _ in range(cfg.num_layers)]
    with torch.no_grad():
        _, tcs = tm(torch.from_numpy(ids), caches=tcs,
                    prefill_lens=torch.from_numpy(plen))
    if jm is None:
        return tcs, None
    jcs = [jgpt.paged_cache_create(b, n_pages, _PAGE, cfg.num_heads,
                                   cfg.head_dim, jnp.float32, _MP)
           for _ in range(cfg.num_layers)]
    _, jcs = jm.forward(Tensor(ids), caches=jcs,
                        prefill_lens=jnp.asarray(plen))
    return tcs, jcs


def _rewind(caches, lens, torch_side=True):
    if torch_side:
        return [c._replace(seq_lens=torch.from_numpy(lens)) for c in caches]
    return [c._replace(seq_lens=jnp.asarray(lens)) for c in caches]


def test_verify_step_logits_match_jax(models):
    jm, tm = models
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, VOCAB, n).astype(np.int32) for n in (9, 14)]
    tcs, jcs = _prefilled(tm, jm, prompts)
    toks = rng.integers(0, VOCAB, (2, 5)).astype(np.int32)
    valid = np.array([5, 3], np.int32)
    with torch.no_grad():
        tl, tn = tm.verify_step(torch.from_numpy(toks), tcs,
                                torch.from_numpy(valid))
    jl, jn = jm.verify_step(Tensor(toks), jcs, jnp.asarray(valid))
    want = np.asarray(jl.value)
    for i, n in enumerate(valid):
        np.testing.assert_allclose(tl.numpy()[i, :n], want[i, :n],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert tn[0].seq_lens.tolist() == np.asarray(jn[0].seq_lens).tolist()


def test_verify_positions_are_the_vanilla_decode_logits(models):
    """Position j of one verify forward scores what the vanilla decode
    step scores after the same j tokens (same package, CPU)."""
    _, tm = models
    rng = np.random.default_rng(22)
    prompt = rng.integers(0, VOCAB, 11).astype(np.int32)
    toks = rng.integers(0, VOCAB, (1, 4)).astype(np.int32)
    tcs, _ = _prefilled(tm, None, [prompt])
    lens0 = np.array([len(prompt)], np.int32)
    with torch.no_grad():
        ver, _ = tm.verify_step(torch.from_numpy(toks),
                                _rewind(tcs, lens0),
                                torch.tensor([4], dtype=torch.int32))
        caches = _rewind(tcs, lens0)
        for j in range(4):
            dec, caches = tm(torch.from_numpy(toks[:, j:j + 1]),
                             caches=caches)
            np.testing.assert_allclose(dec[0, 0].numpy(),
                                       ver[0, j].numpy(), atol=1e-5,
                                       rtol=1e-5)


def test_verify_row_with_no_valid_token_changes_nothing_else(models):
    """A row at ``valid_len == 0`` (an empty or half-prefilled slot)
    writes only the scratch page: every other row's logits and every
    real page are as they are without it."""
    jm, tm = models
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, VOCAB, n).astype(np.int32) for n in (10, 6)]
    toks = rng.integers(0, VOCAB, (2, 4)).astype(np.int32)
    outs = {}
    for v1 in (4, 0):
        tcs, _ = _prefilled(tm, None, prompts)
        before = [c.k_pages[8:16].clone() for c in tcs]
        with torch.no_grad():
            lg, new = tm.verify_step(torch.from_numpy(toks), tcs,
                                     torch.tensor([4, v1],
                                                  dtype=torch.int32))
        outs[v1] = (lg[0].clone(), [c.k_pages[:8].clone() for c in new],
                    new[0].seq_lens.tolist())
        if v1 == 0:
            # row 1's pages (8..15) were not written
            for c, b0 in zip(new, before):
                assert torch.equal(c.k_pages[8:16], b0)
    assert torch.equal(outs[4][0], outs[0][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[4][1], outs[0][1]))
    assert outs[0][2] == [14, 6]


# -- the engine: bit identity -----------------------------------------------------

def test_ngram_draft_engine_bit_identical(models, vanilla):
    _, tm = models
    out, done = _run(tm, speculative=SpeculativeConfig(k=4))
    assert out == vanilla
    assert all(r.stats.spec_steps > 0 for r in done)


def test_adversarial_draft_rejection_storm(models, vanilla):
    _, tm = models
    out, done = _run(tm, speculative=SpeculativeConfig(k=8,
                                                       draft=_wrong_draft()))
    assert out == vanilla
    assert sum(r.stats.spec_accepted for r in done) == 0
    assert sum(r.stats.spec_drafted for r in done) > 0


def test_model_draft_accepts_and_matches(models, vanilla):
    _, tm = models
    out, done = _run(tm, speculative=SpeculativeConfig(
        k=4, draft=ModelDraft(tm, window=64)))
    assert out == vanilla
    # a self-draft inside its window is exact: more than 1.5 tokens a step
    steps = sum(r.stats.spec_steps for r in done)
    toks = sum(r.stats.tokens_out - 1 for r in done)
    assert steps and toks / steps > 1.5


def test_model_draft_proposals_match_jax(models):
    """The window grows, then slides: the greedy drafts of both packages
    agree on histories shorter and longer than the window."""
    jm, tm = models
    rng = np.random.default_rng(31)
    hist = [rng.integers(0, VOCAB, n).astype(np.int32) for n in (5, 30)]
    hist.append(None)
    got = ModelDraft(tm, window=16).propose(hist, 4)
    want = JaxModelDraft(jm, window=16).propose(hist, 4)
    assert got.shape == (3, 4) and got.dtype == np.int32
    assert got.tolist() == np.asarray(want).tolist()


def test_int8_pools_bit_identical(models):
    _, tm = models
    ref, _ = _run(tm, 8, kv_int8=True)
    out, _ = _run(tm, 8, kv_int8=True, speculative=SpeculativeConfig(k=4))
    adv, _ = _run(tm, 8, kv_int8=True, speculative=SpeculativeConfig(
        k=8, draft=_wrong_draft()))
    assert out == ref and adv == ref


def test_prefix_cache_on_bit_identical(models, vanilla):
    _, tm = models
    pc = PrefixCache(8)
    out, _ = _run(tm, prefix_cache=pc, speculative=SpeculativeConfig(
        k=4, draft=ModelDraft(tm, window=64)))
    assert out == vanilla
    assert pc.hit_pages > 0


def test_unfused_verify_bit_identical(models, vanilla):
    _, tm = models
    out, _ = _run(tm, fused_step=False, speculative=SpeculativeConfig(k=4))
    assert out == vanilla


def test_eos_inside_accepted_drafts(models, vanilla):
    _, tm = models
    prompt = _prompts()[0]
    eos = int(vanilla[0][len(prompt) + 4])
    e0 = _engine(tm)
    ra = e0.submit(prompt, max_new_tokens=12, eos_token=eos)
    ref = e0.run()[ra].tolist()
    e0.close()
    e1 = _engine(tm, speculative=SpeculativeConfig(
        k=4, draft=ModelDraft(tm, window=64)))
    rb = e1.submit(prompt, max_new_tokens=12, eos_token=eos)
    out = e1.run()[rb].tolist()
    e1.close()
    e1.allocator.check_no_leak()
    assert out == ref and len(ref) < len(prompt) + 12


@pytest.fixture(scope="module")
def jax_spec_streams(models):
    jm, _ = models
    eng = jax_engine(jm, **_kw(speculative=JaxSpecConfig(k=4)))
    rids = [eng.submit(p, max_new_tokens=12) for p in _prompts()]
    out = eng.run()
    eng.close()
    return [np.asarray(out[r]).tolist() for r in rids]


@pytest.mark.parametrize("draft", ["ngram", "wrong"])
def test_spec_engine_matches_jax_spec_engine(models, jax_spec_streams,
                                             draft):
    _, tm = models
    d = "ngram" if draft == "ngram" else _wrong_draft()
    out, _ = _run(tm, speculative=SpeculativeConfig(k=4, draft=d))
    assert out == jax_spec_streams


# -- rollback mechanics -----------------------------------------------------------

def test_rejection_rollback_returns_pages_mid_flight(models):
    """k=8 at page 8: every verify window crosses a page boundary, so a
    rejection storm grows pages and must hand them back each step."""
    _, tm = models
    eng = _engine(tm, num_slots=1, speculative=SpeculativeConfig(
        k=8, draft=_wrong_draft()))
    released = []
    orig = eng.allocator.release_pages

    def spy(owner, pages, rereserve=False):
        released.append((owner, tuple(pages), rereserve))
        return orig(owner, pages, rereserve=rereserve)

    eng.allocator.release_pages = spy
    rid = eng.submit(_prompts()[0], max_new_tokens=16)
    eng.run()
    assert released and all(r[2] for r in released)
    assert any(r[0] == rid for r in released)
    reasons = [e.get("reason") for e in eng.ledger.tail(256)]
    assert "spec_grow" in reasons and "spec_rollback" in reasons
    eng.close()
    eng.allocator.check_no_leak()


def test_admission_reserves_capacity_and_binds_prefill_pages(models):
    _, tm = models
    eng = _engine(tm, num_slots=1, speculative=SpeculativeConfig(k=4))
    prompt = _prompts()[0]  # 22 tokens: 3 prefill pages of 5 in all
    rid = eng.submit(prompt, max_new_tokens=12)
    eng.step()
    # the verify grows at most one page past the 3 prefill pages
    assert 3 <= len(eng.allocator.owners()[rid]) <= 4
    assert eng.allocator.reserved(rid) >= 1
    assert len(eng.allocator.owners()[rid]) + \
        eng.allocator.reserved(rid) == 5
    assert eng.allocator.occupancy()["reserved"] == \
        eng.allocator.reserved(rid)
    eng.close()
    eng.allocator.check_no_leak()


def test_shared_prefix_pages_never_rolled_back(models):
    _, tm = models
    pc = PrefixCache(8)
    eng = _engine(tm, prefix_cache=pc, num_pages=16,
                  speculative=SpeculativeConfig(k=8, draft=_wrong_draft()))
    for p in _prompts():
        eng.submit(p, max_new_tokens=12)
    eng.run()
    assert pc.total_pages() > 0
    pc.check_consistent(eng.allocator)
    eng.close()
    eng.allocator.check_no_leak()


def test_oversubscribed_pool_recycles_under_speculation(models):
    _, tm = models
    eng = _engine(tm, num_pages=8, speculative=SpeculativeConfig(k=4))
    ref = _engine(tm, num_pages=8)
    rids = [eng.submit(p, max_new_tokens=10) for p in _prompts()]
    rref = [ref.submit(p, max_new_tokens=10) for p in _prompts()]
    out, expect = eng.run(), ref.run()
    for a, b in zip(rids, rref):
        assert out[a].tolist() == expect[b].tolist()
    eng.close()
    ref.close()
    eng.allocator.check_no_leak()


# -- the serving.verify site --------------------------------------------------------

def test_transient_verify_fault_retried_bit_identical(models, vanilla):
    _, tm = models
    fi.get_injector().arm("serving.verify", at_calls=[1])
    out, _ = _run(tm, speculative=SpeculativeConfig(k=4))
    assert fi.get_injector().counts("serving.verify")["fired"] == 1
    assert out == vanilla


def test_persistent_verify_fault_raises_and_cleans_up(models):
    _, tm = models
    fi.get_injector().arm("serving.verify", probability=1.0)
    eng = _engine(tm, speculative=SpeculativeConfig(k=4))
    eng.submit(_prompts()[0], max_new_tokens=8)
    with pytest.raises(Exception):
        eng.run()
    eng.close()
    eng.allocator.check_no_leak()


def test_verify_retry_none_surfaces_the_first_fault(models):
    _, tm = models
    fi.get_injector().arm("serving.verify", at_calls=[1])
    eng = _engine(tm, speculative=SpeculativeConfig(k=4), verify_retry=None,
                  inprogram=False)
    eng.submit(_prompts()[0], max_new_tokens=8)
    with pytest.raises(fi.InjectedFault):
        eng.run()
    assert fi.get_injector().counts("serving.verify")["fired"] == 1
    eng.close()
    eng.allocator.check_no_leak()


# -- telemetry ---------------------------------------------------------------------

def test_stats_and_histograms(models):
    _, tm = models
    metrics = ServingMetrics(registry=StatRegistry())
    _, done = _run(tm, speculative=SpeculativeConfig(
        k=4, draft=ModelDraft(tm, window=64)))
    for r in done:
        st = r.stats
        assert st.spec_steps > 0
        assert 0.0 <= st.acceptance_rate <= 1.0
        assert st.tokens_per_step >= 1.0
        d = st.to_dict()
        assert d["acceptance_rate"] == st.acceptance_rate
        assert d["tokens_per_step"] == st.tokens_per_step
        metrics.observe_request(r)
    snap = metrics.snapshot()
    assert snap["spec_accept_rate"]["count"] == len(done)
    assert snap["spec_tokens_per_step"]["p50"] >= 1.0
    assert snap["counters"]["spec_drafted_total"] > 0
    text = metrics.prometheus_text()
    assert "serving_spec_accept_rate_bucket" in text
    assert "serving_spec_tokens_per_step_bucket" in text


def test_vanilla_requests_skip_spec_histograms(models):
    _, tm = models
    metrics = ServingMetrics(registry=StatRegistry())
    _, done = _run(tm)
    for r in done:
        metrics.observe_request(r)
    assert metrics.spec_accept_rate.total == 0


def test_verify_ms_on_the_step_timeline(models):
    _, tm = models
    eng = _engine(tm, speculative=SpeculativeConfig(k=4))
    eng.submit(_prompts()[0], max_new_tokens=8)
    eng.run()
    tl = eng.step_timeline()
    assert any("verify_ms" in e for e in tl)
    assert not any("decode_ms" in e for e in tl)
    assert eng.programs_launched["verify"] >= 1
    eng.close()


def test_spec_config_and_draft_builders():
    assert as_spec_config(3).k == 3
    cfg = SpeculativeConfig(k=2)
    assert as_spec_config(cfg) is cfg
    assert isinstance(as_spec_config(SelfDraft()).draft, SelfDraft)
    with pytest.raises(ValueError):
        as_spec_config(True)
    with pytest.raises(ValueError):
        SpeculativeConfig(k=0)
    with pytest.raises(ValueError):
        SpeculativeConfig(draft="beam").build_draft()
    assert isinstance(SpeculativeConfig().build_draft(), NGramDraft)
    assert isinstance(SpeculativeConfig(draft="self").build_draft(),
                      SelfDraft)
    assert device_draft_params(NGramDraft(4, 2)) == \
        {"kind": "ngram", "max_ngram": 4, "min_ngram": 2}
    assert device_draft_params(_wrong_draft()) is None
    assert SelfDraft().propose([np.array([5, 6], np.int32), None],
                               2).tolist() == [[6, 6], [0, 0]]


# -- allocator reservations (the rollback discipline) ----------------------------------

def test_reserve_alloc_release_cycle():
    a = PageAllocator(8)
    assert a.reserve("r", 5)
    assert a.free_count == 3 and a.reserved("r") == 5
    assert a.alloc("other", 4) is None  # reserved capacity is not free
    pages = a.alloc_reserved("r", 2)
    assert len(pages) == 2 and a.reserved("r") == 3
    a.release_pages("r", pages, rereserve=True)
    assert a.reserved("r") == 5 and a.free_count == 3
    with pytest.raises(RuntimeError, match="reserved"):
        a.alloc_reserved("r", 6)
    a.free("r")  # drops pages and reservation
    a.check_no_leak()


def test_check_no_leak_flags_dangling_reservation():
    a = PageAllocator(4)
    a.reserve("r", 2)
    with pytest.raises(RuntimeError, match="reserved"):
        a.check_no_leak()
    a.free("r")
    a.check_no_leak()


# -- the server ---------------------------------------------------------------------

def test_server_end_to_end_with_speculation(models):
    from paddle_tpu_torch.serving.server import ServingServer, client_request
    _, tm = models
    srv = ServingServer(tm, device="cpu",
                        metrics=ServingMetrics(registry=StatRegistry()),
                        speculative=SpeculativeConfig(
                            k=4, draft=ModelDraft(tm, window=64)),
                        **_kw())
    port = srv.start()
    try:
        toks = []
        rep = client_request("127.0.0.1", port, {
            "op": "generate", "prompt": list(range(1, 9)),
            "max_new_tokens": 8, "stream": True}, on_token=toks.append)
        assert "error" not in rep, rep
        assert rep["generated"] == toks and len(toks) == 8
        assert rep["stats"]["tokens_per_step"] >= 1.0
        assert "acceptance_rate" in rep["stats"]
        h = client_request("127.0.0.1", port, {"op": "health"})
        assert h["reserved_pages"] == 0
        assert h["prefill_chunk_tokens"] is None
    finally:
        srv.stop()
    srv.engine.allocator.check_no_leak()


def test_released_engine_refuses_to_launch(models):
    """After ``release_device`` every retrying launch site (prefill,
    verify) raises a terminal error at once, not after its retries."""
    _, tm = models
    eng = _engine(tm, speculative=SpeculativeConfig(k=4))
    rid = eng.submit(_prompts()[0], max_new_tokens=8)
    eng.step()
    eng.release_device()
    with pytest.raises(RuntimeError, match="released"):
        eng.step()
    assert eng._slots[0] is not None and eng._slots[0].req_id == rid
    eng.close()
    eng.allocator.check_no_leak()


def test_hopeless_gate_counts_k_plus_one_tokens_a_step(models):
    """A verify emits up to k+1 tokens: 20 tokens at 10 ms a step take
    200 ms vanilla but 4 steps (40 ms) speculative, so a 60 ms deadline
    is hopeless only for the vanilla engine."""
    import time
    from paddle_tpu_torch.inference import DecodeRequest
    _, tm = models
    now = time.monotonic()
    req = DecodeRequest(0, _prompts()[0], 20, deadline_t=now + 0.06)
    verdicts = []
    for spec in (None, SpeculativeConfig(k=4)):
        eng = _engine(tm, speculative=spec)
        eng.decode_ema_s = 0.01
        verdicts.append(eng._deadline_hopeless(req, now))
        eng.close()
    assert verdicts == [True, False]
