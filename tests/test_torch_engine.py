"""The PyTorch port's continuous-batching engine against the JAX
package's, on the CPU at gpt_tiny size: several requests through two
slots with a small page pool, so pages are recycled between requests.
"""

import _torch_threads  # noqa: F401

import time

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.inference import create_decode_engine as jax_engine
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch.inference import create_decode_engine
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving.scheduler import Priority, SLOScheduler

_LENGTHS = (5, 9, 13, 7, 20)


@pytest.fixture(scope="module")
def models():
    pt.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    tgpt.load_jax_state(tm, jgpt.checkpoint_state(jm))
    return jm, tm


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 1024, n).astype(np.int32) for n in _LENGTHS]


def _kw(**kw):
    # 10 pages of 8 tokens for 2 slots: requests wait for pages, and
    # freed pages go to the next request
    base = dict(num_slots=2, page_size=8, max_seq_len=64, num_pages=10)
    base.update(kw)
    return base


def _streams(make, model, **kw):
    eng = make(model, **_kw(**kw))
    rids = [eng.submit(p, max_new_tokens=8) for p in _prompts()]
    res = eng.run()
    eng.close()
    return [res[r].tolist() for r in rids]


def _port(model, **kw):
    return create_decode_engine(model, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_streams(models):
    jm, _ = models
    return {"fp": _streams(jax_engine, jm),
            "int8": _streams(jax_engine, jm, kv_int8=True)}


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_engine_streams_match_jax(models, jax_streams, kv):
    _, tm = models
    got = _streams(_port, tm, kv_int8=(kv == "int8"))
    assert got == jax_streams[kv]


@pytest.mark.parametrize("kv_int8", [False, True])
def test_fused_and_unfused_bit_identical(models, kv_int8):
    _, tm = models
    fused = _streams(_port, tm, fused_step=True, kv_int8=kv_int8)
    unfused = _streams(_port, tm, fused_step=False, kv_int8=kv_int8)
    assert fused == unfused


def test_pages_recycle_and_no_leak(models):
    _, tm = models
    eng = _port(tm, **_kw())
    seen = set()
    for p in _prompts():
        eng.submit(p, max_new_tokens=8)
    while eng.num_queued or eng.num_active:
        eng.step()
        for owner, pages in eng.allocator.owners().items():
            seen.update(pages)
    eng.check_no_leak()
    assert eng.free_pages == 10
    # five requests of up to 4 pages each through a 10-page pool
    assert len(seen) <= 10 and eng.steps > 8
    eng.close()


def test_callbacks_stream_before_completion(models):
    _, tm = models
    events = []
    eng = _port(tm, **_kw(),
                on_complete=lambda r: events.append(("done", r.req_id,
                                                     r.state)))
    rid = eng.submit(_prompts()[0], max_new_tokens=4,
                     on_token=lambda i, t, d: events.append(("tok", i, d)))
    eng.run()
    toks = [e for e in events if e[0] == "tok"]
    assert len(toks) == 4 and toks[-1][2] is True
    assert events[-1] == ("done", rid, "done")


def test_eos_stops_early(models):
    _, tm = models
    eng = _port(tm, **_kw())
    first = _streams(_port, tm)[0]
    prompt = _prompts()[0]
    eos = first[len(prompt) + 2]
    rid = eng.submit(prompt, max_new_tokens=8, eos_token=eos)
    out = eng.run()[rid].tolist()
    assert out[-1] == eos and len(out) <= len(prompt) + 3


def test_close_midflight_and_deadline_return_pages(models):
    _, tm = models
    states = []
    eng = _port(tm, **_kw(), on_complete=lambda r: states.append(r.state))
    eng.submit(_prompts()[0], max_new_tokens=8)
    eng.submit(_prompts()[1], max_new_tokens=8,
               deadline_t=time.monotonic() + 1e-3)
    eng.submit(_prompts()[2], max_new_tokens=8)
    time.sleep(0.01)
    eng.step()
    assert "deadline" in states
    eng.close()
    assert states.count("evicted") >= 1
    assert eng.free_pages == 10


def test_scheduler_admits_higher_priority_first(models):
    _, tm = models
    order = []
    eng = _port(tm, **_kw(num_slots=1), scheduler=SLOScheduler(),
                on_complete=lambda r: order.append(r.req_id))
    a = eng.submit(_prompts()[0], max_new_tokens=2,
                   priority=int(Priority.BATCH))
    b = eng.submit(_prompts()[1], max_new_tokens=2,
                   priority=int(Priority.INTERACTIVE))
    eng.run()
    assert order == [b, a]


@pytest.mark.parametrize("kwarg,value", [
    ("mesh", object()),
])
def test_unported_engine_arguments_raise(models, kwarg, value):
    _, tm = models
    with pytest.raises(NotImplementedError, match="not yet ported"):
        _port(tm, **_kw(), **{kwarg: value})


def test_max_seq_len_past_position_table_raises(models):
    _, tm = models
    with pytest.raises(ValueError, match="position-embedding"):
        _port(tm, num_slots=1, page_size=8, max_seq_len=256)


def test_submit_validation(models):
    _, tm = models
    eng = _port(tm, **_kw())
    with pytest.raises(ValueError):
        eng.submit(np.arange(60, dtype=np.int32), max_new_tokens=8)
    with pytest.raises(ValueError):
        eng.submit(np.array([5000], np.int32), max_new_tokens=2)
    with pytest.raises(ValueError):
        eng.submit(np.array([1], np.int32), max_new_tokens=0)
    eng.close()


def test_page_allocator_matches_jax():
    """The host allocator is a copy: the same operation sequence leaves
    both with the same books."""
    from paddle_tpu.inference.continuous_batching import \
        PageAllocator as JaxAllocator
    from paddle_tpu_torch.inference import PageAllocator
    ja, ta = JaxAllocator(12), PageAllocator(12)
    for alloc in (ja, ta):
        assert alloc.alloc("a", 5) is not None
        assert alloc.alloc("b", 8) is None          # all-or-nothing
        assert alloc.reserve("b", 4)
        pages = alloc.alloc_reserved("b", 2)
        alloc.release_pages("b", pages[:1], rereserve=True)
        alloc.transfer("a", ("prefix", 1), alloc.owners()["a"][:2])
    assert ta.free_count == ja.free_count
    assert ta.reserved_total == ja.reserved_total
    assert ta.owners() == ja.owners()
    for alloc in (ja, ta):
        for owner in ("a", "b", ("prefix", 1)):
            alloc.free(owner)
        alloc.check_no_leak()
