"""Profiling: ``RecordEvent`` host markers and the device trace (port of
``paddle_tpu/core/profiler.py``).

Reference: ``paddle/fluid/platform/profiler.h:127`` RecordEvent, ``:213``
EnableProfiler; device events through CUPTI (``device_tracer.h:43``).
Host events are collected in-process, with the JAX package's event
record and chrome JSON. Where the JAX package opens a
``jax.named_scope``, every :class:`RecordEvent` here opens
``torch.profiler.record_function(name)``, so the markers show in the
device trace beside the kernels they launched; where it calls
``jax.profiler.start_trace``, :func:`profiler_guard` runs
``torch.profiler.profile`` over the CPU and, when there is one, the
card (CUPTI), and writes the trace as chrome JSON into its
``trace_dir`` (:data:`DEVICE_TRACE_FILE`).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

import torch

from .flags import get_flag, set_flags

__all__ = ["DEVICE_TRACE_FILE", "RecordEvent", "disable_profiler",
           "enable_profiler", "export_chrome_trace", "external_event",
           "profiler_active", "profiler_events", "profiler_guard",
           "reset_profiler"]

# the device trace's file name in a profiler_guard's trace_dir
DEVICE_TRACE_FILE = "device_trace.json"


@dataclass
class _Event:
    name: str
    start_us: float
    end_us: float
    thread_id: int
    annotation: Optional[str] = None


@dataclass
class _ProfilerState:
    enabled: bool = False
    events: List[_Event] = field(default_factory=list)
    lock: threading.Lock = field(default_factory=threading.Lock)
    # the running torch.profiler session and the directory it writes to
    device: Any = None
    trace_dir: Optional[str] = None


_STATE = _ProfilerState()


class RecordEvent:
    """RAII host-event marker; nests a ``record_function`` for device
    traces."""

    def __init__(self, name: str, annotation: Optional[str] = None):
        self.name = name
        self.annotation = annotation
        self._scope = None
        self._start = 0.0

    def __enter__(self):
        self._start = time.perf_counter() * 1e6
        self._scope = torch.profiler.record_function(self.name)
        self._scope.__enter__()
        return self

    def __exit__(self, *exc):
        self._scope.__exit__(*exc)
        if _STATE.enabled or get_flag("profiler_enabled"):
            evt = _Event(self.name, self._start, time.perf_counter() * 1e6,
                         threading.get_ident(), self.annotation)
            with _STATE.lock:
                _STATE.events.append(evt)
        return False


def enable_profiler() -> None:
    set_flags({"profiler_enabled": True})
    _STATE.enabled = True
    with _STATE.lock:
        _STATE.events.clear()


def disable_profiler() -> None:
    set_flags({"profiler_enabled": False})
    _STATE.enabled = False


def reset_profiler() -> None:
    with _STATE.lock:
        _STATE.events.clear()


def profiler_events() -> List[_Event]:
    with _STATE.lock:
        return list(_STATE.events)


def profiler_active() -> bool:
    """Cheap enabled-check for external event sources (the serving span
    tracer bridges through this before paying any work)."""
    return _STATE.enabled or bool(get_flag("profiler_enabled"))


def external_event(name: str, start_us: float, end_us: float,
                   annotation: Optional[str] = None) -> None:
    """Inject an externally-timed host event (perf_counter / monotonic
    microseconds, one clock on Linux). The serving span tracer
    (``serving/tracing.py``) uses this so request spans land in the same
    :func:`export_chrome_trace` as the RecordEvent markers."""
    if not profiler_active():
        return
    evt = _Event(name, float(start_us), float(end_us),
                 threading.get_ident(), annotation)
    with _STATE.lock:
        _STATE.events.append(evt)


def export_chrome_trace(path: str) -> None:
    """Write the collected host events as a chrome://tracing JSON file."""
    with _STATE.lock:
        events = list(_STATE.events)
    trace = {"traceEvents": [
        {"name": e.name, "ph": "X", "ts": e.start_us,
         "dur": max(e.end_us - e.start_us, 0.01), "pid": 0,
         "tid": e.thread_id % 1_000_000,
         "args": ({"annotation": e.annotation} if e.annotation else {})}
        for e in events]}
    with open(path, "w") as f:
        json.dump(trace, f)


def start_device_trace(trace_dir: str) -> None:
    """Start ``torch.profiler`` over the CPU and the card (when CUDA is
    available) for :func:`stop_device_trace` to write into
    ``trace_dir``."""
    if _STATE.device is not None:
        raise RuntimeError("a device trace is already running (into "
                           f"{_STATE.trace_dir!r})")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _STATE.device, _STATE.trace_dir = prof, str(trace_dir)


def stop_device_trace() -> Optional[str]:
    """Stop the running device trace and write it as chrome JSON to
    ``<trace_dir>/device_trace.json``; returns that path (None when no
    trace ran)."""
    prof, trace_dir = _STATE.device, _STATE.trace_dir
    if prof is None:
        return None
    _STATE.device = _STATE.trace_dir = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, DEVICE_TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def profiler_guard(trace_dir: Optional[str] = None):
    """Context enabling host events and, with ``trace_dir``, the device
    trace: ``torch.profiler`` over the CPU and the card, written on exit
    as chrome JSON to ``<trace_dir>/device_trace.json``."""
    enable_profiler()
    if trace_dir is not None:
        start_device_trace(trace_dir)
    try:
        yield
    finally:
        if trace_dir is not None:
            stop_device_trace()
        disable_profiler()
