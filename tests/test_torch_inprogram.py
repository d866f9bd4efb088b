"""In-program speculation and chunked prefill of the port's multi-step
engine, on the CPU at gpt_tiny size with the JAX model's weights,
mirroring ``tests/test_inprogram_inner_loop.py``:

- with an n-gram or self draft (both have device twins) the verify runs
  inside the macro launch: greedy tokens equal the per-token vanilla
  engine's and the JAX in-program engine's, the boundary ``verify``
  never launches, launches drop against the boundary-interleaved spec
  engine, and an EOS inside an accepted run stops where the per-token
  engine stops;
- a rejection storm rewinds the lengths inside the launch and every
  exit (drain, close mid-flight, deadline) leaves no page and no
  reservation behind;
- chained prefill chunks advance inside the launch
  (``prefill_chunk_inprogram`` spans), compose with in-program
  speculation, and a request dumped mid-chunk replays onto a rebuilt
  engine to the uninterrupted run's tokens;
- ``inprogram=False`` and a host-only draft keep the boundary paths.
"""

import _torch_threads  # noqa: F401

import time

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.inference import SpeculativeConfig as JaxSpecConfig
from paddle_tpu.inference import create_decode_engine as jax_engine
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch.distributed import fault_inject as fi
from paddle_tpu_torch.inference import (CallableDraft, SpeculativeConfig,
                                        create_decode_engine)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import SpanTracer


@pytest.fixture(autouse=True)
def _clean_injector():
    fi.reset()
    yield
    fi.reset()


def _pair(cfg_kw=None):
    pt.seed(0)
    if cfg_kw is None:
        jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
        tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    else:
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**cfg_kw))
        tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg_kw), device="cpu")
    jm.eval()
    tgpt.load_jax_state(tm, jgpt.checkpoint_state(jm))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair()


@pytest.fixture(scope="module")
def vmodels():
    """A vocab-16 twin: greedy decoding repeats itself soon enough for
    the n-gram and self drafts to get accepted runs."""
    return _pair(dict(vocab_size=16, hidden_size=128, num_layers=2,
                      num_heads=4, max_seq_len=128, dropout=0.0,
                      attn_dropout=0.0))


ENGINE_KW = dict(num_slots=2, page_size=8, max_seq_len=64)


def _port(tm, **kw):
    return create_decode_engine(tm, device="cpu", **dict(ENGINE_KW, **kw))


def _prompts(vocab=1024):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32)
            for n in (5, 9, 13, 7)]


def _long_prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 1024, n).astype(np.int32) for n in (41, 9)]


def _run(eng, mnt=8, eos=None, prompts=None, stats=None):
    if stats is not None:
        eng.set_on_complete(lambda r: stats.append(r.stats))
    ps = _prompts() if prompts is None else prompts
    rids = [eng.submit(p, max_new_tokens=mnt, eos_token=eos) for p in ps]
    res = eng.run()
    launches = dict(eng.programs_launched)
    eng.close()
    return [res[r].tolist() for r in rids], launches


def _jax_run(jm, mnt=8, eos=None, prompts=None, **kw):
    return _run(jax_engine(jm, **dict(ENGINE_KW, **kw)), mnt, eos,
                prompts)[0]


SPEC = dict(k=3, draft="ngram")


@pytest.fixture(scope="module")
def base(models):
    return _run(_port(models[1], multi_step=1))[0]


@pytest.fixture(scope="module")
def long_base(models):
    return _run(_port(models[1], multi_step=1), prompts=_long_prompts())[0]


# ---------------------------------------------------------------------------
# In-program speculation
# ---------------------------------------------------------------------------

class TestInProgramSpec:
    @pytest.mark.parametrize("draft", ["ngram", "self"])
    def test_bit_identical_ngram_and_self(self, models, base, draft):
        jm, tm = models
        eng = _port(tm, multi_step=4,
                    speculative=SpeculativeConfig(k=3, draft=draft))
        assert eng._spec_inprogram
        got, _ = _run(eng)
        assert got == base, f"in-program {draft} draft diverged"
        assert got == _jax_run(jm, multi_step=4,
                               speculative=JaxSpecConfig(k=3, draft=draft))

    def test_verify_rides_inside_macro(self, models):
        _, tm = models
        eng = _port(tm, multi_step=4, speculative=SpeculativeConfig(**SPEC))
        assert eng._spec_inprogram
        got, launches = _run(eng)
        assert "verify" not in launches and "decode" not in launches
        tokens = sum(len(g) for g in got) - sum(len(p) for p in _prompts())
        assert launches["decode_multi"] < tokens

    def test_launches_strictly_reduced_vs_boundary(self, models):
        _, tm = models
        spec = SpeculativeConfig(**SPEC)
        got_b, lb = _run(_port(tm, multi_step=4, speculative=spec,
                               inprogram=False))
        got_i, li = _run(_port(tm, multi_step=4, speculative=spec))
        assert got_i == got_b
        assert lb["verify"] > 0
        assert li["decode_multi"] < lb["verify"]

    @pytest.mark.parametrize("draft", ["ngram", "self"])
    def test_accepted_runs_occur(self, vmodels, draft):
        """The in-program verify accepts on the small-vocab stream, and
        the ring's runs rebuild the stats."""
        jm, tm = vmodels
        prompts = [np.array([3, 1, 4, 1, 5], np.int32)]
        stats = []
        got, _ = _run(_port(tm, multi_step=4, max_seq_len=96,
                            speculative=SpeculativeConfig(k=3,
                                                          draft=draft)),
                      mnt=32, prompts=prompts, stats=stats)
        assert stats[0].spec_accepted > 0, f"{draft}: no accepts"
        assert stats[0].spec_drafted >= stats[0].spec_accepted
        assert got == _jax_run(jm, mnt=32, prompts=prompts, multi_step=4,
                               max_seq_len=96,
                               speculative=JaxSpecConfig(k=3, draft=draft))

    def test_eos_inside_run_every_offset(self, vmodels):
        """An EOS at each token's first occurrence in the small-vocab
        stream, inside an accepted run or anywhere else in a launch,
        stops where the per-token engine stops."""
        jm, tm = vmodels
        prompts = [np.array([3, 1, 4, 1, 5], np.int32)]
        kw = dict(mnt=16, prompts=prompts)
        base, _ = _run(_port(tm, multi_step=1, max_seq_len=96), **kw)
        gen = base[0][len(prompts[0]):]
        offsets = [i for i, t in enumerate(gen) if t not in gen[:i]]
        assert len(offsets) >= 4
        for off in offsets[:5]:
            eos = gen[off]
            a, _ = _run(_port(tm, multi_step=1, max_seq_len=96), eos=eos,
                        **kw)
            b, _ = _run(_port(tm, multi_step=4, max_seq_len=96,
                              speculative=SpeculativeConfig(**SPEC)),
                        eos=eos, **kw)
            assert a == b, f"EOS at generated offset {off} diverged"
            assert len(a[0]) == len(prompts[0]) + off + 1
        assert b == _jax_run(jm, eos=eos, multi_step=4, max_seq_len=96,
                             speculative=JaxSpecConfig(**SPEC), **kw)

    def test_escape_hatch_inprogram_false(self, models, base):
        _, tm = models
        eng = _port(tm, multi_step=4, inprogram=False,
                    speculative=SpeculativeConfig(**SPEC))
        assert not eng._spec_inprogram and not eng._chunk_inprogram
        got, launches = _run(eng)
        assert got == base
        assert launches["verify"] > 0

    def test_host_draft_falls_back_to_boundary(self, models, base):
        _, tm = models
        draft = CallableDraft(lambda h, k: [int(h[-1])] * k)
        eng = _port(tm, multi_step=4,
                    speculative=SpeculativeConfig(k=3, draft=draft))
        assert not eng._spec_inprogram
        got, launches = _run(eng)
        assert got == base
        assert launches["verify"] > 0


# ---------------------------------------------------------------------------
# Rejection storms
# ---------------------------------------------------------------------------

class TestRejectionStorm:
    """The 1024-vocab stream never repeats, so every n-gram draft is
    rejected: each iteration writes k speculative positions that the
    in-program rewind must give back."""

    def test_storm_outputs_and_drain_leak_free(self, models, base):
        _, tm = models
        stats = []
        eng = _port(tm, multi_step=4, speculative=SpeculativeConfig(**SPEC))
        rids = [eng.submit(p, max_new_tokens=8) for p in _prompts()]
        eng.set_on_complete(lambda r: stats.append(r.stats))
        res = eng.run()
        assert [res[r].tolist() for r in rids] == base
        assert sum(s.spec_accepted for s in stats) == 0
        assert sum(s.spec_drafted for s in stats) > 0
        assert eng.allocator.reserved_total == 0
        eng.close()
        eng.allocator.check_no_leak()

    def test_mid_flight_close_during_storm(self, models):
        _, tm = models
        eng = _port(tm, multi_step=4, speculative=SpeculativeConfig(**SPEC))
        for p in _prompts():
            eng.submit(p, max_new_tokens=16)
        eng.step()
        eng.step()  # a speculative launch is in flight
        eng.close()
        assert eng.allocator.reserved_total == 0
        eng.allocator.check_no_leak()

    def test_deadline_eviction_mid_storm(self, models):
        _, tm = models
        states = []
        eng = _port(tm, multi_step=4,
                    on_complete=lambda r: states.append(r.state),
                    speculative=SpeculativeConfig(**SPEC))
        eng.submit(_prompts()[0], max_new_tokens=32,
                   deadline_t=time.monotonic() + 0.01)
        eng.step()
        time.sleep(0.02)
        eng.step()
        assert "deadline" in states
        assert eng.allocator.reserved_total == 0
        eng.close()
        eng.allocator.check_no_leak()


# ---------------------------------------------------------------------------
# In-program chunked prefill
# ---------------------------------------------------------------------------

class TestInProgramChunk:
    def test_bit_identical_and_traced(self, models, long_base):
        jm, tm = models
        tr = SpanTracer(sample_rate=1.0)
        eng = _port(tm, multi_step=4, prefill_chunk_tokens=8, tracer=tr)
        assert eng._chunk_inprogram
        got, launches = _run(eng, prompts=_long_prompts())
        assert got == long_base
        assert got == _jax_run(jm, prompts=_long_prompts(), multi_step=4,
                               prefill_chunk_tokens=8)
        spans = [s["name"] for t in tr.finished() for s in t["spans"]]
        assert "prefill_chunk_inprogram" in spans
        # only the fresh first chunks ran at the boundary
        assert "prefill_chained" not in launches
        eng.allocator.check_no_leak()

    def test_composes_with_inprogram_spec(self, models, long_base):
        jm, tm = models
        eng = _port(tm, multi_step=4, prefill_chunk_tokens=8,
                    speculative=SpeculativeConfig(**SPEC))
        assert eng._spec_inprogram and eng._chunk_inprogram
        got, launches = _run(eng, prompts=_long_prompts())
        assert got == long_base
        assert "verify" not in launches
        assert got == _jax_run(jm, prompts=_long_prompts(), multi_step=4,
                               prefill_chunk_tokens=8,
                               speculative=JaxSpecConfig(**SPEC))

    def test_boundary_chunks_with_inprogram_false(self, models, long_base):
        _, tm = models
        eng = _port(tm, multi_step=4, prefill_chunk_tokens=8,
                    inprogram=False)
        assert not eng._chunk_inprogram
        got, launches = _run(eng, prompts=_long_prompts())
        assert got == long_base
        assert launches["prefill_chained"] > 0

    def test_replay_mid_chunk_onto_rebuilt_engine(self, models, long_base):
        _, tm = models
        eng = _port(tm, multi_step=4, prefill_chunk_tokens=8)
        for p in _long_prompts():
            eng.submit(p, max_new_tokens=8)
        mid = None
        for _ in range(8):
            eng.step()
            mid = next((r for r in eng._slots if r is not None
                        and r.state == "prefill_partial"
                        and 0 < r.prefill_done_len < len(r.prompt)), None)
            if mid is not None:
                break
        assert mid is not None, "never observed a mid-chunk request"
        snap = eng.dump_inflight()
        pre = {r.req_id: ([int(t) for t in r.prompt],
                          [int(t) for t in r.generated],
                          r.max_new_tokens) for r in snap}
        eng.close()
        eng.allocator.check_no_leak()
        eng2 = _port(tm, multi_step=4, prefill_chunk_tokens=8)
        new_rids = {}
        for old_rid, (prompt, gen, mnt) in sorted(pre.items()):
            new_rids[old_rid] = eng2.submit(
                np.asarray(prompt + gen, np.int32),
                max_new_tokens=mnt - len(gen))
        res = eng2.run()
        eng2.close()
        eng2.allocator.check_no_leak()
        for old_rid in sorted(pre):
            prompt, gen, _mnt = pre[old_rid]
            full = prompt + gen + [
                int(t) for t in
                res[new_rids[old_rid]][len(prompt) + len(gen):]]
            assert full == long_base[old_rid], \
                f"mid-chunk replay diverged for req {old_rid}"
