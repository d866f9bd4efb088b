"""``paddle.profiler``: the profiling facade (port of
``paddle_tpu/profiler.py``).

Reference parity: ``python/paddle/utils/profiler.py`` and
``fluid/profiler.py``, context managers over the event collector. Host
events come from ``core.profiler``; the device trace is
``torch.profiler``'s over the CPU and the card, written as chrome JSON
to ``<trace_dir>/device_trace.json`` (``core.profiler.DEVICE_TRACE_FILE``)
where the JAX package calls ``jax.profiler``.
"""

import contextlib

from .core.profiler import (RecordEvent, disable_profiler,  # noqa: F401
                            enable_profiler, export_chrome_trace,
                            profiler_events, profiler_guard,
                            reset_profiler, start_device_trace,
                            stop_device_trace)


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None,
             trace_dir=None):
    """reference: ``fluid.profiler.profiler``. ``profile_path`` receives
    the host events' chrome JSON on exit; ``trace_dir`` the device
    trace."""
    with profiler_guard(trace_dir=trace_dir):
        yield
    if profile_path:
        export_chrome_trace(profile_path)


def start_profiler(state="All", trace_dir=None):
    enable_profiler()
    if trace_dir:
        start_device_trace(trace_dir)


def stop_profiler(sorted_key=None, profile_path=None, trace_dir=False):
    """Stop host events (and, with a true ``trace_dir``, write the device
    trace started by :func:`start_profiler`)."""
    if trace_dir:
        stop_device_trace()
    disable_profiler()
    if profile_path:
        export_chrome_trace(profile_path)


def summary(top_k=20):
    """Aggregate host events by name: rows ``(name, calls, total us,
    mean us)``, the longest total first; printed as a table."""
    events = profiler_events()
    agg = {}
    for e in events:
        dur = e.end_us - e.start_us
        cnt, tot = agg.get(e.name, (0, 0.0))
        agg[e.name] = (cnt + 1, tot + dur)
    rows = sorted(((name, c, t, t / c) for name, (c, t) in agg.items()),
                  key=lambda r: -r[2])[:top_k]
    lines = [f"{'Event':<40}{'Calls':>8}{'Total(us)':>14}{'Avg(us)':>12}"]
    for name, c, t, avg in rows:
        lines.append(f"{name:<40}{c:>8}{t:>14.1f}{avg:>12.1f}")
    out = "\n".join(lines)
    print(out)
    return rows
