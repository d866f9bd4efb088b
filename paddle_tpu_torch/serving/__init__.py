"""paddle_tpu_torch.serving — the serving layer over the decode engine:
the newline-JSON server (``server``), replica supervision with the
failover router (``supervisor``), SLO-aware admission (``scheduler``),
the refcounted prefix cache with its spill tiers (``prefix_cache``),
request metrics (``metrics``), the fleet telemetry plane and the crash
flight recorder (``fleet_metrics``) and span tracing (``tracing``)."""

from .fleet_metrics import (FleetMetrics, FlightRecorder,  # noqa: F401
                            PressureMonitor)
from .metrics import (Histogram, ServingMetrics,  # noqa: F401
                      SLOAttainment, merge_exports,
                      quantile_from_buckets)
from .prefix_cache import (DiskSpillTier, HostSpillTier,  # noqa: F401
                           PrefixCache, SpillCorrupt)
from .scheduler import (Priority, ServerOverloaded,  # noqa: F401
                        SLOConfig, SLOScheduler)
from .tracing import (RequestTrace, SpanTracer,  # noqa: F401
                      request_latencies, stderr_span_sink)


def __getattr__(name):
    # server.py and supervisor.py load lazily, so `python -m
    # paddle_tpu_torch.serving.<mod>` does not run the module twice
    if name in ("ServingServer", "client_request", "PageFetchFailed",
                "fetch_page_blobs"):
        from . import server
        return getattr(server, name)
    if name in ("Supervisor", "FailoverRouter", "Replica"):
        from . import supervisor
        return getattr(supervisor, name)
    raise AttributeError(
        f"module 'paddle_tpu_torch.serving' has no attribute {name!r}")
