"""Core runtime: flags, errors, places, dtypes, RNG, profiling, stats
(port of ``paddle_tpu/core/``)."""

from .profiler import (RecordEvent, disable_profiler,  # noqa: F401
                       enable_profiler, export_chrome_trace, profiler_guard)
