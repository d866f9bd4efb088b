"""The PyTorch port's observability surface on the CPU at gpt_tiny with the
JAX model's weights, mirroring ``tests/test_memory_observer.py``
(``TestForecastMath``, ``TestEngineLedger``, ``TestServerSurface``) and
the server cases of ``tests/test_tracing.py``:

- the step timeline's occupancy, the page ledger's events and
  ``capacity_snapshot`` equal the JAX engine's on the same workload;
- ``forecast_exhaustion`` equals the JAX function on its unit inputs, and
  forecast admission takes the JAX engine's decisions on the same
  synthetic timeline, also under ``multi_step=4`` (where the decode EMA
  times a whole launch, so the horizon is N times longer in both);
- ``program_costs`` records the JAX engine's program kinds (empty with
  capture off); the decode count's GEMM and head terms equal
  ``FlopCounterMode``'s count of the same plain step, and its attention
  term counts the live positions where the plain step's dense gather
  multiplies every position of the page table;
- every server op of this surface answers with the JAX server's keys and
  deterministic values: ``export``, ``slo`` (retargeting and its
  ``BadRequest``s), ``trace`` (``n``, ``drain``, ``format: chrome``),
  ``capacity``, ``profile`` on the CPU (``chip_pending: true``), a
  capture window ``tools/merge_traces.py`` merges, and the gauges.
"""

import _torch_threads  # noqa: F401

import importlib.util
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import paddle_tpu as pt
from paddle_tpu.core.monitor import StatRegistry as JaxStatRegistry
from paddle_tpu.inference import SpeculativeConfig as JaxSpecConfig
from paddle_tpu.inference import create_decode_engine as jax_engine
from paddle_tpu.inference.continuous_batching import (
    DecodeRequest as JaxRequest)
from paddle_tpu.inference.page_ledger import (
    forecast_exhaustion as jax_forecast)
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import ServingMetrics as JaxMetrics
from paddle_tpu.serving.prefix_cache import PrefixCache as JaxPrefixCache
from paddle_tpu.serving.server import ServingServer as JaxServer

from paddle_tpu_torch.core.monitor import StatRegistry
from paddle_tpu_torch.inference import (SpeculativeConfig,
                                        create_decode_engine)
from paddle_tpu_torch.inference import costs
from paddle_tpu_torch.inference.continuous_batching import DecodeRequest
from paddle_tpu_torch.inference.page_ledger import forecast_exhaustion
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import (ServingMetrics, ServingServer,
                                      client_request)
from paddle_tpu_torch.serving.prefix_cache import PrefixCache

ENGINE_KW = dict(num_slots=2, page_size=8, max_seq_len=96, num_pages=24)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.fixture(scope="module")
def models():
    pt.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    tgpt.load_jax_state(tm, jgpt.checkpoint_state(jm))
    return jm, tm


def _port(tm, **kw):
    return create_decode_engine(tm, device="cpu", **dict(ENGINE_KW, **kw))


def _jax(jm, **kw):
    return jax_engine(jm, **dict(ENGINE_KW, **kw))


def _shared_prompts():
    """Two requests over one 16-token prefix (2 full pages) and a third
    alone: the second admission hits the cache (a chained prefill)."""
    rng = np.random.default_rng(3)
    sys_p = rng.integers(0, 1024, 16).astype(np.int32)
    return [np.concatenate([sys_p, rng.integers(0, 1024, n)
                            .astype(np.int32)]) for n in (5, 9)] + \
        [rng.integers(0, 1024, 11).astype(np.int32)]


def _drive(eng, prompts, max_new=5):
    for p in prompts:
        eng.submit(p, max_new)
    eng.run()
    return eng


# ---------------------------------------------------------------------------
# Engine: timeline occupancy, ledger, capacity
# ---------------------------------------------------------------------------

def _ledger_view(events):
    return [{k: e.get(k) for k in ("seq", "ev", "owner", "pages", "step",
                                   "reason", "req", "to", "n")}
            for e in events]


def test_capacity_ledger_and_timeline_occupancy_match_jax(models):
    jm, tm = models
    prompts = _shared_prompts()
    port = _drive(_port(tm, prefix_cache=PrefixCache(
        8, spill_bytes=1 << 20)), prompts)
    jax = _drive(_jax(jm, prefix_cache=JaxPrefixCache(
        8, spill_bytes=1 << 20)), prompts)
    got, want = port.step_timeline(), jax.step_timeline()
    assert [e["occupancy"] for e in got] == \
        [e["occupancy"] for e in want]
    assert [e["programs"] for e in got] == [e["programs"] for e in want]
    assert any(e["occupancy"]["prefix_device"] for e in got)
    for e in got:
        assert sum(e["occupancy"].values()) == port.num_pages
    assert set(got[-1]) == set(want[-1])
    assert _ledger_view(port.ledger_tail(512)) == \
        _ledger_view(jax.ledger_tail(512))
    snap, jsnap = port.capacity_snapshot(), jax.capacity_snapshot()
    assert snap == jsnap
    assert "host_tier_pages" in snap and snap["ledger"]["events_total"]
    port.close()
    jax.close()


def test_ledger_off_engine_has_no_ledger(models):
    _, tm = models
    eng = _drive(_port(tm, page_ledger=False), _shared_prompts()[:1])
    assert eng.ledger is None and eng.ledger_tail(8) == []
    assert "ledger" not in eng.capacity_snapshot()
    eng.close()


# ---------------------------------------------------------------------------
# Forecast math and forecast admission
# ---------------------------------------------------------------------------

def _entries(frees, dt_s=1.0):
    return [{"t_us": i * dt_s * 1e6, "free_pages": f}
            for i, f in enumerate(frees)]


@pytest.mark.parametrize("entries", [
    _entries([20, 18, 16, 14, 12, 10]),            # steady consumption
    _entries([4, 8, 12]),                          # freeing
    _entries([8, 8, 8]),                           # steady
    [], _entries([5]),                             # too few entries
    _entries([40, 30, 20, 20, 20, 20, 20, 20]),    # EWMA weights recent
    [{"free_pages": 4}, {"t_us": 1.0}, {"t_us": 0.0, "free_pages": 8},
     {"t_us": 1e6, "free_pages": 6}],              # malformed skipped
], ids=["steady_burn", "freeing", "flat", "empty", "one", "ewma",
        "malformed"])
def test_forecast_exhaustion_matches_jax(entries):
    assert forecast_exhaustion(entries) == jax_forecast(entries)


@pytest.mark.parametrize("multi_step", [1, 4])
def test_forecast_admission_decisions_match_jax(models, multi_step):
    """Both engines get one synthetic timeline (20 pages/s burn) and one
    decode EMA; requests of growing horizon cross from admitted to
    denied at the same point, and ``forecast_denials`` counts alike.
    Under ``multi_step=4`` the EMA stands for a whole launch, and both
    charge ``max_new_tokens`` x that EMA, as the reference does."""
    jm, tm = models
    port = _port(tm, forecast_admission=True, multi_step=multi_step)
    jax = _jax(jm, forecast_admission=True, multi_step=multi_step)
    decisions = []
    for eng, req_cls in ((port, DecodeRequest), (jax, JaxRequest)):
        eng.timeline.extend(_entries([24, 22, 20, 18, 16], dt_s=0.1))
        eng.decode_ema_s = 0.05 * multi_step
        row = []
        for i, max_new in enumerate((1, 8, 20, 40, 60)):
            req = req_cls(i, np.arange(1, 9, dtype=np.int32), max_new)
            row.append(eng._fits(req))
        eng.decode_ema_s = None  # no estimate: the instant gate only
        row.append(eng._fits(req_cls(9, np.arange(1, 9, dtype=np.int32),
                                     60)))
        decisions.append((row, eng.forecast_denials,
                          eng.capacity_snapshot()["forecast_denials"]))
    assert decisions[0] == decisions[1]
    row, denials, _ = decisions[0]
    assert row[0] and not all(row[:5]) and row[5] and denials > 0
    port.close()
    jax.close()


def test_forecast_admission_serves_the_same_tokens(models):
    _, tm = models
    prompts = _shared_prompts()
    outs = []
    for fa in (False, True):
        eng = _port(tm, forecast_admission=fa)
        rids = [eng.submit(p, 5) for p in prompts]
        res = eng.run()
        outs.append([res[r].tolist() for r in rids])
        eng.close()
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# Program costs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", ["plain", "cache", "spec", "multi_step"])
def test_program_costs_record_the_jax_kinds(models, config):
    jm, tm = models
    kw, pkw, jkw = {}, {}, {}
    if config == "cache":
        pkw["prefix_cache"] = PrefixCache(8)
        jkw["prefix_cache"] = JaxPrefixCache(8)
    elif config == "spec":
        pkw["speculative"] = SpeculativeConfig(k=2, draft="ngram")
        jkw["speculative"] = JaxSpecConfig(k=2, draft="ngram")
    elif config == "multi_step":
        kw["multi_step"] = 4
    prompts = _shared_prompts()
    port = _drive(_port(tm, capture_costs=True, **kw, **pkw), prompts)
    jax = _drive(_jax(jm, capture_costs=True, **kw, **jkw), prompts)
    got = port.program_costs()
    assert set(got) == set(jax.program_costs())
    assert set(got) == set(port.programs_launched)
    for cost in got.values():
        assert cost["flops"] > 0 and cost["bytes_accessed"] > 0
    port.close()
    jax.close()


def test_program_costs_empty_with_capture_off(models):
    _, tm = models
    eng = _drive(_port(tm), _shared_prompts())
    assert eng.program_costs() == {}
    eng.close()


def test_decode_flops_against_flop_counter(models):
    """The decode count against ``FlopCounterMode`` over the same plain
    decode step. The GEMMs (QKV, out-projection, MLP) and the lm head
    are equal; attention differs by design and is named: the plain
    step's dense gather multiplies every position of the page table
    (``max_pages x page`` a row), the count the live ones."""
    _, tm = models
    cfg = tm.config
    eng = _port(tm)
    for p in _shared_prompts()[:2]:
        eng.submit(p, 6)
    eng.step()  # admits and prefills both, then one decode
    lens = eng._lens.copy()
    with FlopCounterMode(display=False) as fc:
        eng.step()  # one decode step, nothing else
    counted = fc.get_total_flops()
    eng.run()
    eng.close()
    L, H, D, B = cfg.num_layers, cfg.num_heads, cfg.head_dim, 2
    ours = costs.decode_cost(cfg, B, lens, 0, 0)["flops"]
    live_attn = 4 * H * D * L * int(np.sum(lens + 1))
    gemm_and_head = ours - live_attn
    padded_attn = 4 * H * D * L * B * eng.max_pages * eng.page_size
    assert counted == pytest.approx(gemm_and_head + padded_attn, rel=0.01)
    E, V, F = cfg.hidden_size, cfg.vocab_size, cfg.ffn_hidden_mult * \
        cfg.hidden_size
    assert gemm_and_head == 2 * B * L * (4 * E * E + 2 * E * F) + \
        2 * B * E * V


def test_costs_bounds_and_counts():
    """The helpers ``chip_smoke.py``'s kernel table reads: a bound takes
    the larger of the two times and names it."""
    ms, by = costs.bound_ms(3.35e9, 0.0)
    assert (round(ms, 9), by) == (1.0, "bytes")
    ms, by = costs.bound_ms(0.0, 495e9 / 3)
    assert (round(ms, 9), by) == (1.0, "3xtf32")
    assert costs.bound_ms(0.0, 989e9, "bf16") == (1.0, "bf16")
    cfg = tgpt.gpt_tiny()
    one = costs.decode_cost(cfg, 2, [3, 5], 100, 10)
    two = costs.decode_cost(cfg, 2, [3, 5], 100, 10, iterations=2,
                            stops=[2, 1])
    # the second iteration: slot 0 attends 5 positions (4 in the
    # first), slot 1 (6 in the first) has stopped
    assert two["flops"] - 2 * one["flops"] == pytest.approx(
        4 * cfg.num_heads * cfg.head_dim * cfg.num_layers * (5 - 4 - 6))
    assert costs.restore_cost(cfg, 3, 8, 10)["bytes_accessed"] == \
        cfg.num_layers * 3 * 8 * 10


# ---------------------------------------------------------------------------
# Server ops against the JAX server
# ---------------------------------------------------------------------------

PROMPT = list(range(1, 20))


@pytest.fixture(scope="module")
def servers(models):
    """A port server and a JAX server on the same weights, each having
    served the same two requests (spans sampled)."""
    jm, tm = models
    port = ServingServer(tm, device="cpu", trace_sample=1.0,
                         metrics=ServingMetrics(registry=StatRegistry()),
                         slo_ttft_ms=60000, slo_tpot_ms=60000, **ENGINE_KW)
    jax = JaxServer(jm, trace_sample=1.0,
                    metrics=JaxMetrics(registry=JaxStatRegistry()),
                    slo_ttft_ms=60000, slo_tpot_ms=60000, **ENGINE_KW)
    ports = port.start(), jax.start()
    for p in ports:
        for n in (19, 7):
            rep = client_request("127.0.0.1", p,
                                 {"op": "generate", "prompt": PROMPT[:n],
                                  "max_new_tokens": 4}, timeout_s=120)
            assert rep.get("done"), rep
    yield ports, (port, jax)
    port.stop()
    jax.stop()


def _both(servers, payload):
    return [client_request("127.0.0.1", p, dict(payload), timeout_s=120)
            for p in servers[0]]


def _keys(d):
    """The nested key structure of a reply."""
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    return None


def test_export_op_matches_jax(servers):
    got, want = _both(servers, {"op": "export"})
    assert _keys(got) == _keys(want)
    assert got["export"]["counters"]["requests_total"] == \
        want["export"]["counters"]["requests_total"] == 2


@pytest.mark.parametrize("payload", [
    {"op": "slo"},
    {"op": "slo", "ttft_ms": 50, "tpot_ms": 10},
    {"op": "slo", "ttft_ms": 75},            # tpot target kept
    {"op": "slo", "tpot_ms": None},          # cleared
    {"op": "slo", "ttft_ms": -1},
    {"op": "slo", "tpot_ms": True},
    {"op": "slo", "ttft_ms": "fast"},
], ids=["read", "set", "partial", "clear", "negative", "bool", "string"])
def test_slo_op_matches_jax(servers, payload):
    got, want = _both(servers, payload)
    assert got == want


def test_trace_op_n_drain_and_chrome_match_jax(servers):
    one = _both(servers, {"op": "trace", "n": 1})
    assert _keys(one[0]).keys() == _keys(one[1]).keys()
    assert len(one[0]["traces"]) == len(one[1]["traces"]) == 1
    for k in ("multi_step", "sample_rate"):
        assert one[0][k] == one[1][k]
    assert set(one[0]["program_costs"]) == set(one[1]["program_costs"])
    assert [r["tokens"] for r in one[0]["per_token_timeline"]
            if "tokens" in r] == [r["tokens"] for r in
                                  one[1]["per_token_timeline"]
                                  if "tokens" in r]
    chrome = _both(servers, {"op": "trace", "format": "chrome"})
    assert _keys(chrome[0]).keys() == _keys(chrome[1]).keys()
    assert chrome[0]["chrome"]["traceEvents"]
    drained = _both(servers, {"op": "trace", "drain": True})
    assert len(drained[0]["traces"]) == len(drained[1]["traces"]) == 2
    after = _both(servers, {"op": "trace"})
    assert after[0]["traces"] == after[1]["traces"] == []


def test_capacity_op_matches_jax(servers):
    got, want = _both(servers, {"op": "capacity", "ledger_tail": 8})
    assert _keys(got).keys() == _keys(want).keys()
    for k in ("num_pages", "page_size", "occupancy", "used_fraction",
              "evictable_pages", "unreclaimable_pages", "engine_restarts",
              "forecast_admission", "forecast_denials"):
        assert got[k] == want[k], k
    assert sum(got["occupancy"].values()) == got["num_pages"]
    assert _ledger_view(got["ledger_tail"]) == \
        _ledger_view(want["ledger_tail"])
    assert set(got["forecast"]) == set(want["forecast"])
    plain = _both(servers, {"op": "capacity"})
    assert "ledger_tail" not in plain[0] and "ledger_tail" not in plain[1]


def test_profile_op_on_the_cpu_matches_jax(servers):
    """Each device's entry as JAX's (JAX lists every virtual host device
    of its CPU backend, the port the one CPU)."""
    got, want = _both(servers, {"op": "profile"})
    assert got["chip_pending"] is want["chip_pending"] is True
    assert got["devices"] == want["devices"][:1]
    assert got["devices"][0]["memory_stats"] is None


def _merge_traces():
    spec = importlib.util.spec_from_file_location(
        "merge_traces", os.path.join(ROOT, "tools", "merge_traces.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_profile_capture_window_merges(servers, tmp_path):
    (port, _), _srv = servers
    prof = client_request("127.0.0.1", port,
                          {"op": "profile", "ms": 40, "dir": str(tmp_path)},
                          timeout_s=120)
    assert prof["trace_dir"] == str(tmp_path) and prof["ms"] == 40.0
    assert prof["trace_file"].endswith(".trace.json")
    assert os.path.getsize(prof["trace_file"]) == prof["trace_bytes"]
    events = _merge_traces().load_trace(str(tmp_path))
    assert isinstance(events, list) and events
    for bad in (-1, 0, 30001, True, "x"):
        rep = client_request("127.0.0.1", port,
                             {"op": "profile", "ms": bad})
        assert rep["error"] == "BadRequest", bad


def test_profile_is_one_capture_at_a_time(servers):
    (port, _), (srv, _j) = servers
    assert srv._profile_lock.acquire(blocking=False)
    try:
        rep = client_request("127.0.0.1", port, {"op": "profile", "ms": 5})
    finally:
        srv._profile_lock.release()
    assert rep["error"] == "ProfileBusy"


def test_slo_targets_overlay_a_given_metrics(models):
    """A server given its metrics keeps their SLO monitor and overlays
    the targets it is given one by one (``server.py:334-345``); the port
    once dropped them."""
    _, tm = models
    metrics = ServingMetrics(registry=StatRegistry())
    metrics.slo.set_targets(40.0, 9.0)
    s = ServingServer(tm, device="cpu", metrics=metrics, slo_tpot_ms=12.0,
                      **ENGINE_KW)
    assert s.metrics is metrics
    assert (metrics.slo.ttft_ms, metrics.slo.tpot_ms) == (40.0, 12.0)


def test_health_stats_and_gauges_match_jax(servers):
    _ports, (port, jax) = servers
    for op in ("health", "stats"):
        got, want = _both(servers, {"op": op})
        for k in ("weight_generation", "weight_swaps", "multi_step",
                  "macro_launches"):
            assert got[k] == want[k], (op, k)
    g, jg = port._gauges(), jax._gauges()
    # the JAX gauges this single server has: the fleet's (roles,
    # handoff) and the mesh's are not ported
    assert set(jg) <= set(g) | {"mesh_model_parallel", "mesh_devices",
                                "mesh_collective_bytes"}
    for k in ("weight_generation", "ledger_events", "ledger_dropped",
              "pages_inflight", "pages_prefix_device", "pages_used",
              "pages_unreclaimable", "num_pages"):
        assert g[k] == jg[k], k
    assert set(k for k in g if k.startswith("program_")) == \
        set(k for k in jg if k.startswith("program_"))
    text = client_request("127.0.0.1", servers[0][0],
                          {"op": "metrics"})["text"]
    for fam in ("serving_pages_inflight", "serving_pages_used",
                "serving_ledger_events", "serving_weight_generation",
                "serving_program_decode_flops",
                "serving_traces_finished_total"):
        assert fam in text, fam
