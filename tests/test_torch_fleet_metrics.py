"""The port's fleet telemetry plane (``paddle_tpu_torch/serving/
fleet_metrics.py``) against the JAX package's
(``tests/test_fleet_metrics.py`` on both): the same export sequences go
into both packages' ``FleetMetrics``, ``PressureMonitor`` and
``robust_zscores``; the snapshots (wall-clock ages aside), verdicts,
outliers and exposition text are equal, and the reference's assertions
hold on each. The crash flight recorder: a port server's resurrection
and terminal failure write bundles that ``tools/flight_inspect.py``
lints clean; without ``flight_dir`` nothing is written.
"""

import _torch_threads  # noqa: F401

import importlib.util
import json
import os
import re
import sys
import time
import types
from pathlib import Path

import pytest

from paddle_tpu.core.monitor import StatRegistry as JStatRegistry
from paddle_tpu.serving import fleet_metrics as jfm
from paddle_tpu.serving import metrics as jmetrics
from paddle_tpu.serving import supervisor as jsup

from paddle_tpu_torch.core.monitor import StatRegistry as TStatRegistry
from paddle_tpu_torch.distributed import fault_inject as fi
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import fleet_metrics as tfm
from paddle_tpu_torch.serving import metrics as tmetrics
from paddle_tpu_torch.serving import supervisor as tsup
from paddle_tpu_torch.serving.server import ServingServer, client_request

REPO = Path(__file__).resolve().parent.parent

JAX = types.SimpleNamespace(fm=jfm, metrics=jmetrics, reg=JStatRegistry,
                            sup=jsup)
PORT = types.SimpleNamespace(fm=tfm, metrics=tmetrics, reg=TStatRegistry,
                             sup=tsup)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


flight_inspect = _load_tool("flight_inspect")

_PROM_TYPE = re.compile(
    r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) (counter|gauge|histogram)$")
_PROM_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})? "
    r"(-?[0-9]+(\.[0-9]+)?([eE][+-]?[0-9]+)?|NaN|[+-]Inf)$")


def _mk_export(ns, n=4, ttft=5.0, step=1.0, errors=0, steps=10,
               slo_targets=(100.0, 10.0), queued=0.0, inflight=0.0,
               slots=4.0):
    """Synthetic ``ServingMetrics.export()`` with n finished requests
    (``tests/test_fleet_metrics.py`` ``_mk_export``), in ``ns``'s
    package."""
    m = ns.metrics.ServingMetrics(
        registry=ns.reg(),
        slo=ns.metrics.SLOAttainment(ttft_ms=slo_targets[0],
                                     tpot_ms=slo_targets[1]))
    for _ in range(n):
        m.ttft_ms.observe(ttft)
        m.tpot_ms.observe(step)
        m.step_ms.observe(step)
        m.slo.observe(1, ttft / 1e3, step / 1e3)
        m.counter("requests_total").add()
    if errors:
        m.counter("engine_errors_total").add(errors)
    e = m.export()
    e["gauges"] = {"queued_requests": queued, "inflight_slots": inflight,
                   "num_slots": slots, "prefill_debt_tokens": 0.0,
                   "engine_steps": float(steps)}
    return e


def _timeless(obj):
    """``obj`` without its wall-clock fields (export stamps, ages)."""
    if isinstance(obj, dict):
        return {k: _timeless(v) for k, v in obj.items()
                if k not in ("t", "age_s", "t_unix")}
    if isinstance(obj, (list, tuple)):
        return [_timeless(v) for v in obj]
    return obj


# -- scenarios: each runs on one package and returns what is compared ----

def _slow_replica(ns):
    fm = ns.fm.FleetMetrics()
    for i in range(3):
        slow = i == 2
        fm.ingest(i, _mk_export(ns, n=2, step=40.0 if slow else 1.0))
        fm.ingest(i, _mk_export(ns, n=6, step=40.0 if slow else 1.0))
    snap = fm.fleet_snapshot()
    assert "2" in snap["outliers"] and "0" not in snap["outliers"]
    assert snap["outliers"]["2"]["step_ms"]["z"] > 3.5
    assert snap["collector"]["outlier_flags_total"] == 1
    again = fm.fleet_snapshot()
    assert again["collector"]["outlier_flags_total"] == 1
    return snap, fm.prometheus_text(), sorted(fm.outliers())


def _mid_scrape_death(ns):
    fm = ns.fm.FleetMetrics()
    for i in range(3):
        fm.ingest(i, _mk_export(ns, n=4))
    fm.mark_stale(2)
    snap = fm.fleet_snapshot()
    assert snap["replicas_fresh"] == 2 and snap["replicas_known"] == 3
    assert snap["per_replica"]["2"]["stale"] is True
    assert snap["counters"]["requests_total"] == 8
    assert snap["histogram_exports"]["ttft_ms"]["total"] == 8
    assert snap["slo"]["classes"]["normal"]["total"] == 8
    text = fm.prometheus_text()
    assert 'replica="2"' not in text and "fleet_requests_total 8" in text
    return snap, text


def _idle_replica(ns):
    fm = ns.fm.FleetMetrics()
    for _round in range(2):
        for i in range(3):
            fm.ingest(i, _mk_export(ns, n=4,
                                    step=40.0 if i == 2 else 1.0))
    snap = fm.fleet_snapshot()
    assert snap["per_replica"]["2"]["signals"]["step_ms"] is None
    assert snap["outliers"] == {}
    return snap


def _pressure_generations(ns):
    fm = ns.fm.FleetMetrics(pressure=ns.fm.PressureMonitor(hysteresis=2),
                            pressure_interval_s=0.0)
    for i in range(3):
        fm.ingest(i, _mk_export(ns, n=2, queued=50.0))
    seq = [fm.fleet_snapshot()["pressure"]]
    assert seq[0]["raw"] == "scale_up"
    for _ in range(5):
        seq.append(fm.fleet_snapshot()["pressure"])
        assert seq[-1]["streak"] == seq[0]["streak"]
        assert seq[-1]["verdict"] == "steady"
    for i in range(3):
        fm.ingest(i, _mk_export(ns, n=4, queued=50.0))
    seq.append(fm.fleet_snapshot()["pressure"])
    assert seq[-1]["verdict"] == "scale_up"
    for i in range(3):
        fm.mark_stale(i)
    seq.append(fm.fleet_snapshot()["pressure"])
    assert seq[-1]["raw"] == "no_data"
    assert seq[-1]["verdict"] == "scale_up"
    return seq


def _bursty_cycle(ns):
    fm = ns.fm.FleetMetrics(pressure=ns.fm.PressureMonitor(hysteresis=3))
    seen = []
    for i in range(3):
        fm.ingest(i, _mk_export(ns, n=2 + i, queued=50.0))
        seen.append(sorted(fm.outliers()))
        p = fm.fleet_snapshot()["pressure"]
    assert p["streak"] <= 1 and p["verdict"] == "steady"
    return seen, p


def _stale_rejoin(ns):
    fm = ns.fm.FleetMetrics()
    for i in range(2):
        fm.ingest(i, _mk_export(ns, n=1))
    fm.mark_stale(1)
    one = fm.fleet_snapshot()
    assert one["replicas_fresh"] == 1
    fm.ingest(1, _mk_export(ns, n=1))
    two = fm.fleet_snapshot()
    assert two["replicas_fresh"] == 2
    return one, two


def _exposition(ns):
    fm = ns.fm.FleetMetrics()
    for i in range(3):
        fm.ingest(i, _mk_export(ns, n=2 + i, errors=i,
                                step=1.0 + i))
    text = fm.prometheus_text()
    for line in text.splitlines():
        if line:
            assert _PROM_TYPE.match(line) or _PROM_SAMPLE.match(line), \
                line
    assert "fleet_requests_total 9" in text
    return text


def _pressure_monitor(ns):
    pm = ns.fm.PressureMonitor(hysteresis=3)
    out = [pm.evaluate(0.5, 0.0, 0.0, 0.5) for _ in range(3)]
    assert [r["verdict"] for r in out] == ["steady", "steady",
                                           "scale_up"]
    pm2 = ns.fm.PressureMonitor(hysteresis=2)
    out += [pm2.evaluate(0.5, 0.0, 0.0, 0.5),
            pm2.evaluate(0.95, 2.0, 0.0, 0.5),
            pm2.evaluate(0.5, 0.0, 0.0, 0.5)]
    assert out[-1]["verdict"] == "steady"
    out.append(ns.fm.PressureMonitor(hysteresis=1, queue_high=4.0)
               .evaluate(None, 10.0, 0.0, 0.5))
    out.append(ns.fm.PressureMonitor(hysteresis=1, debt_high=100.0)
               .evaluate(None, 0.0, 5000.0, 0.5))
    out.append(ns.fm.PressureMonitor(hysteresis=1)
               .evaluate(1.0, 0.0, 0.0, 0.05))
    out.append(ns.fm.PressureMonitor(hysteresis=1)
               .evaluate(1.0, 2.0, 0.0, 0.9))
    assert [r["verdict"] for r in out[-4:]] == [
        "scale_up", "scale_up", "scale_down", "steady"]
    return out


def _zscores(ns):
    z = [ns.fm.robust_zscores({0: 1.0, 1: 2.0}),
         ns.fm.robust_zscores({0: 1.0, 1: 1.1, 2: 0.9, 3: 50.0}),
         ns.fm.robust_zscores({0: 10.0, 1: 10.0, 2: 10.0, 3: 20.0}),
         ns.fm.robust_zscores({0: 3.0, 1: 5.0, 2: 4.0, 3: 4.5, 4: 0.1})]
    assert z[0] == {0: 0.0, 1: 0.0}
    assert z[1][3] > 3.5 and abs(z[1][0]) < 2.0
    assert z[2][3] > 3.5 and z[2][0] == 0.0
    return z


def _merge_slo(ns):
    exports = [_mk_export(ns, n=2 + i, ttft=5.0 + 100.0 * i)["slo"]
               for i in range(3)]
    return ns.fm.merge_slo_exports(exports)


def _multi_export_lines(ns):
    pairs = [({"replica": str(i)}, _mk_export(ns, n=1 + i, errors=i))
             for i in range(2)] + [(None, _mk_export(ns, n=5))]
    return ns.fm.prometheus_multi_export_lines(pairs)


def _consume_latch(ns):
    fm = ns.fm.FleetMetrics(pressure=ns.fm.PressureMonitor(hysteresis=1),
                            pressure_interval_s=0.0)
    assert fm.consume_pressure() is None
    for i in range(2):
        fm.ingest(i, _mk_export(ns, n=2, queued=50.0))
    first = fm.consume_pressure()
    assert first is not None and first["verdict"] == "scale_up"
    assert fm.consume_pressure() is None
    fm.fleet_snapshot()
    assert fm.consume_pressure() is None
    return first


SCENARIOS = {
    "slow_replica": _slow_replica,
    "mid_scrape_death": _mid_scrape_death,
    "idle_replica": _idle_replica,
    "pressure_generations": _pressure_generations,
    "bursty_cycle": _bursty_cycle,
    "stale_rejoin": _stale_rejoin,
    "exposition": _exposition,
    "pressure_monitor": _pressure_monitor,
    "zscores": _zscores,
    "merge_slo": _merge_slo,
    "multi_export_lines": _multi_export_lines,
    "consume_latch": _consume_latch,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fleet_metrics_equal_jax(name):
    fn = SCENARIOS[name]
    assert _timeless(fn(PORT)) == _timeless(fn(JAX))


def test_aged_out_replica_leaves_rollup(monkeypatch):
    fm = tfm.FleetMetrics(stale_after_s=5.0)
    for i in range(2):
        fm.ingest(i, _mk_export(PORT, n=2))
    assert fm.fleet_snapshot()["replicas_fresh"] == 2
    real = time.monotonic
    monkeypatch.setattr(time, "monotonic", lambda: real() + 30.0)
    assert fm.fleet_snapshot()["replicas_fresh"] == 0


@pytest.mark.parametrize("ns", [JAX, PORT], ids=["jax", "port"])
def test_probe_failure_taxonomy(ns):
    import socket
    c = ns.sup.classify_probe_failure
    table = [(None, "malformed"), (socket.timeout(), "timeout"),
             (ConnectionRefusedError(), "refused"),
             (ConnectionResetError(), "reset"),
             (json.JSONDecodeError("x", "y", 0), "torn_json"),
             (ConnectionError(), "closed"), (OSError(), "os_error"),
             (ValueError(), "error")]
    assert [c(e) for e, _ in table] == [k for _, k in table]


# -- router fleet ops over a real socket (no subprocess) ------------------

def _sup_with_data(ns):
    sup = ns.sup.Supervisor(model="gpt_tiny", replicas=2)
    for i in range(2):
        sup.fleet.ingest(i, _mk_export(ns, n=3 + i))
        sup.replicas[i].load = i
    return sup


def test_router_fleet_stats_and_metrics_ops():
    out = {}
    for tag, ns in (("jax", JAX), ("port", PORT)):
        sup = _sup_with_data(ns)
        router = ns.sup.FailoverRouter(sup)
        port = router.start()
        try:
            fs = client_request("127.0.0.1", port,
                                {"op": "fleet_stats"})["fleet"]
            text = client_request("127.0.0.1", port,
                                  {"op": "fleet_metrics"})["text"]
            cap = client_request("127.0.0.1", port,
                                 {"op": "fleet_capacity"})["capacity"]
        finally:
            router.stop()
        assert fs["counters"]["requests_total"] == 7
        assert set(fs["supervision"]) == {"0", "1"}
        assert 'serving_requests_total{replica="1"} 4' in text
        out[tag] = (fs, text, cap)
    assert _timeless(out["port"]) == _timeless(out["jax"])


def test_router_typed_unavailable_on_a_stub_supervisor():
    class _Stub:
        host = "127.0.0.1"
        replicas = []

        def live(self):
            return []

    router = tsup.FailoverRouter(_Stub())
    port = router.start()
    try:
        r = [client_request("127.0.0.1", port, {"op": op})
             for op in ("fleet_stats", "fleet_metrics", "fleet_capacity",
                        "autoscale")]
    finally:
        router.stop()
    assert [x["error"] for x in r] == [
        "FleetMetricsUnavailable", "FleetMetricsUnavailable",
        "FleetCapacityUnavailable", "AutoscalerUnavailable"]


# -- the flight recorder ----------------------------------------------------

def _bundle_payload(ns, n_steps=3):
    return {"model": "stub", "engine": {"steps": n_steps},
            "recipe": {}, "restarts": 0, "consec_errors": 0,
            "step_timeline": [{"step": i, "ms": 1.0}
                              for i in range(n_steps)],
            "traces": [], "events": [],
            "metrics": ns.metrics.ServingMetrics(
                registry=ns.reg()).export(),
            "inflight": []}


def test_flight_recorder_ring_and_limits(tmp_path):
    def big():
        b = _bundle_payload(PORT)
        b["pad"] = "x" * 4096
        return b

    fr = tfm.FlightRecorder(str(tmp_path / "ring"), budget_bytes=10_000,
                            min_interval_s=0.0)
    paths = [fr.record("stall", big) for _ in range(8)]
    assert all(paths) and os.path.exists(paths[-1])
    assert fr.pruned_total > 0
    assert not [f for f in os.listdir(tmp_path / "ring")
                if f.endswith(".tmp")]
    _, errors = flight_inspect.lint_dir(str(tmp_path / "ring"),
                                        budget_bytes=10_000)
    assert errors == []
    limited = tfm.FlightRecorder(str(tmp_path / "rate"),
                                 min_interval_s=60.0)
    assert limited.record("stall", lambda: _bundle_payload(PORT))
    assert limited.record("stall", lambda: _bundle_payload(PORT)) is None
    assert limited.record("resurrect", lambda: _bundle_payload(PORT))

    def boom():
        raise RuntimeError("collector died")

    assert limited.record("engine_failed", boom) is None
    assert limited.record_failures_total == 1


@pytest.fixture(scope="module")
def model():
    m = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu",
                            generator=__import__("torch").Generator()
                            .manual_seed(0))
    m.eval()
    return m


def _server(m, **kw):
    merged = dict(num_slots=2, page_size=8, max_seq_len=96, num_pages=24)
    merged.update(kw)
    return ServingServer(m, device="cpu",
                         metrics=tmetrics.ServingMetrics(
                             registry=TStatRegistry()), **merged)


@pytest.fixture(autouse=True)
def _clean_injector():
    fi.reset()
    yield
    fi.reset()


def test_resurrection_writes_lintable_flight_bundle(model, tmp_path):
    fi.get_injector().arm("engine.step", at_calls=[3, 4])
    srv = _server(model, max_engine_errors=2, flight_dir=str(tmp_path),
                  trace_sample=1.0)
    port = srv.start()
    try:
        r = client_request("127.0.0.1", port,
                           {"op": "generate", "prompt": [1, 2, 3, 4],
                            "max_new_tokens": 8})
        assert r.get("done") and r["stats"].get("replayed") is True
        bundles = srv.flight.bundles()
        assert len(bundles) == 1
        obj = json.load(open(bundles[0]))
        assert obj["reason"] == "resurrect"
        assert flight_inspect.lint_bundle(obj) == []
        assert obj["inflight"] and obj["engine"]["steps"] >= 1
        assert obj["step_timeline"] and obj["v"] == 2
        assert obj["capacity"]["num_pages"] == 24
    finally:
        srv.stop()
    _, errors = flight_inspect.lint_dir(str(tmp_path))
    assert errors == []


def test_terminal_failure_writes_bundle_and_no_dir_writes_nothing(
        model, tmp_path):
    fi.get_injector().arm("engine.step", probability=1.0)
    srv = _server(model, max_engine_errors=2, max_engine_restarts=0,
                  flight_dir=str(tmp_path))
    port = srv.start()
    try:
        r = client_request("127.0.0.1", port,
                           {"op": "generate", "prompt": [1, 2, 3],
                            "max_new_tokens": 4})
        assert r.get("error") in ("EngineFailed", "ServerEvicted"), r
        reasons = [json.load(open(p))["reason"]
                   for p in srv.flight.bundles()]
        assert "engine_failed" in reasons
    finally:
        srv.stop()
    fi.reset()
    quiet = _server(model)
    assert quiet.flight is None
    quiet._flight_record("stall")  # a no-op
    quiet.stop()
