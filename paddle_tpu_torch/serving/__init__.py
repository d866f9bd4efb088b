"""paddle_tpu_torch.serving — the serving layer over the decode engine:
the newline-JSON server (``server``), SLO-aware admission
(``scheduler``), the refcounted prefix cache with its spill tiers
(``prefix_cache``), request metrics (``metrics``) and span tracing
(``tracing``)."""

from .metrics import ServingMetrics, SLOAttainment  # noqa: F401
from .prefix_cache import (DiskSpillTier, HostSpillTier,  # noqa: F401
                           PrefixCache, SpillCorrupt)
from .scheduler import (Priority, ServerOverloaded,  # noqa: F401
                        SLOConfig, SLOScheduler)
from .server import ServingServer, client_request  # noqa: F401
from .tracing import SpanTracer  # noqa: F401
