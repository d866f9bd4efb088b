"""The port's profiler against the JAX package's, on the CPU.

``core.profiler`` records the same host events and writes the same
chrome JSON (``tests/test_native_and_aux.py:237``); the ``profiler``
facade's ``summary`` gives the same rows; ``profiler_guard(trace_dir)``
writes the device trace (``torch.profiler``, with every ``RecordEvent``
in it as a ``record_function``) to ``<trace_dir>/device_trace.json``;
and ``SpanTracer``'s profiler bridge (``tests/test_tracing.py:151``)
puts finished request spans into the host events while the profiler is
on, as JAX's does, also from the paged engine's requests.
"""

import _torch_threads  # noqa: F401

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu.core.profiler as jprof
import paddle_tpu.profiler as jfacade
import paddle_tpu.serving.tracing as jtracing
import paddle_tpu_torch.core.profiler as tprof
import paddle_tpu_torch.profiler as tfacade
import paddle_tpu_torch.serving.tracing as ttracing

SIDES = {"jax": (jprof, jfacade, jtracing),
         "port": (tprof, tfacade, ttracing)}


@pytest.fixture(autouse=True)
def _off():
    for prof, _, _ in SIDES.values():
        prof.disable_profiler()
        prof.reset_profiler()
    yield
    for prof, _, _ in SIDES.values():
        prof.disable_profiler()
        prof.reset_profiler()


def _trace_shape(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ph"], sorted(e), sorted(e["args"]),
             e["dur"] > 0) for e in events]


def _record(prof):
    prof.enable_profiler()
    with prof.RecordEvent("outer", annotation="step 1"):
        with prof.RecordEvent("inner"):
            torch.ones(4).sum()
    prof.external_event("span", 10.0, 12.5, annotation="t-1")
    prof.disable_profiler()
    with prof.RecordEvent("after_disable"):
        pass
    prof.external_event("late", 1.0, 2.0)


def test_events_and_chrome_json_match_jax(tmp_path):
    shapes = {}
    for side, (prof, _, _) in SIDES.items():
        _record(prof)
        events = prof.profiler_events()
        assert [e.name for e in events] == ["inner", "outer", "span"]
        assert events[1].annotation == "step 1"
        assert not prof.profiler_active()
        path = tmp_path / f"{side}.json"
        prof.export_chrome_trace(str(path))
        shapes[side] = _trace_shape(path)
        prof.reset_profiler()
        assert prof.profiler_events() == []
    assert shapes["port"] == shapes["jax"]


def test_flag_enables_recording_as_in_jax():
    from paddle_tpu.core import flags as jflags
    from paddle_tpu_torch.core import flags as tflags
    for flags, prof in ((jflags, jprof), (tflags, tprof)):
        flags.set_flags({"profiler_enabled": True})
        try:
            assert prof.profiler_active()
            with prof.RecordEvent("flagged"):
                pass
        finally:
            flags.set_flags({"profiler_enabled": False})
        assert [e.name for e in prof.profiler_events()] == ["flagged"]


def test_facade_profiler_and_summary_rows(tmp_path, capsys):
    rows = {}
    for side, (prof, facade, _) in SIDES.items():
        host = tmp_path / f"{side}_host.json"
        with facade.profiler(profile_path=str(host)):
            for _ in range(3):
                with prof.RecordEvent("step"):
                    pass
            with prof.RecordEvent("load"):
                pass
        assert [n for n, *_ in _trace_shape(host)] == ["step"] * 3 + ["load"]
        rows[side] = [(name, calls) for name, calls, total, mean in
                      facade.summary(top_k=5)]
        table = capsys.readouterr().out.splitlines()
        assert table[0].split() == ["Event", "Calls", "Total(us)", "Avg(us)"]
        assert len(table) == 3
        facade.start_profiler()
        with prof.RecordEvent("between"):
            pass
        facade.stop_profiler(profile_path=str(host))
        assert [n for n, *_ in _trace_shape(host)] == ["between"]
    assert sorted(rows["port"]) == sorted(rows["jax"]) == \
        [("load", 1), ("step", 3)]


def test_guard_writes_the_device_trace(tmp_path):
    """``profiler_guard(trace_dir)``: host events on, and
    ``torch.profiler``'s trace in ``device_trace.json`` with the
    ``RecordEvent`` markers in it."""
    with tprof.profiler_guard(trace_dir=str(tmp_path / "trace")):
        assert tprof.profiler_active()
        with tprof.RecordEvent("marked_region"):
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert not tprof.profiler_active()
    path = tmp_path / "trace" / tprof.DEVICE_TRACE_FILE
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "marked_region" in names
    assert any("mm" in str(n) for n in names)
    # the facade's start / stop pair writes the same file
    tfacade.start_profiler(trace_dir=str(tmp_path / "again"))
    with tprof.RecordEvent("second"):
        pass
    tfacade.stop_profiler(trace_dir=True)
    with open(tmp_path / "again" / tprof.DEVICE_TRACE_FILE) as f:
        assert "second" in {e.get("name")
                            for e in json.load(f)["traceEvents"]}
    tprof.start_device_trace(str(tmp_path))
    with pytest.raises(RuntimeError, match="already running"):
        tprof.start_device_trace(str(tmp_path))
    tprof.stop_device_trace()


def _spans(tracing, prof, bridge=True, enabled=True):
    tr = tracing.SpanTracer(sample_rate=1.0, profiler_bridge=bridge)
    if enabled:
        prof.enable_profiler()
    t = tr.start("request")
    sp = t.begin("queue", parent=t.anchor)
    t.end(sp)
    t.event("admit")
    dec = t.begin("decode", parent=t.anchor)
    t.end(dec)
    tr.finish(t, state="done")
    prof.disable_profiler()
    events = prof.profiler_events()
    prof.reset_profiler()
    return [(e.name, e.annotation == t.trace_id, e.end_us >= e.start_us)
            for e in events]


@pytest.mark.parametrize("mode", ["bridged", "bridge_off", "profiler_off"])
def test_span_bridge_matches_jax(mode):
    kw = {"bridged": {}, "bridge_off": dict(bridge=False),
          "profiler_off": dict(enabled=False)}[mode]
    want = _spans(jtracing, jprof, **kw)
    got = _spans(ttracing, tprof, **kw)
    assert got == want
    if mode == "bridged":
        assert [n for n, *_ in got] == ["queue", "admit", "decode",
                                        "request"]
        assert all(ok and same for _, same, ok in got)
    else:
        assert got == []


def test_engine_spans_and_markers_land_in_one_host_trace(tmp_path):
    """The paged engine with a ``SpanTracer`` under the profiler: the
    host JSON holds the per-step markers and each request's spans,
    annotated with its trace id; the greedy tokens are those of the run
    without the profiler."""
    from paddle_tpu_torch.inference import create_decode_engine
    from paddle_tpu_torch.models import gpt as tgpt
    model = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 1024, n) for n in (5, 17, 9)]

    def run():
        tracer = ttracing.SpanTracer(sample_rate=1.0)
        eng = create_decode_engine(model, device="cpu", num_slots=2,
                                   page_size=8, num_pages=16,
                                   tracer=tracer)
        rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
        while eng.num_queued or eng.num_active:
            with tprof.RecordEvent("engine.step"):
                eng.step()
        out = [eng.result(r).tolist() for r in rids]
        eng.close()
        return out, tracer

    plain, _ = run()
    host = tmp_path / "host.json"
    with tfacade.profiler(profile_path=str(host),
                          trace_dir=str(tmp_path / "dev")):
        got, tracer = run()
    assert got == plain
    with open(host) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events]
    assert names.count("engine.step") >= 6
    ids = {t["trace_id"] for t in tracer.finished()}
    assert len(ids) == len(prompts)
    spans = [e for e in events if e["args"].get("annotation") in ids]
    assert {"request", "queue", "prefill", "decode"} <= \
        {e["name"] for e in spans}
    assert sum(e["name"] == "request" for e in spans) == len(prompts)
    assert os.path.getsize(tmp_path / "dev" / tprof.DEVICE_TRACE_FILE) > 0
