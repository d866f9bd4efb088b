"""paddle_tpu_torch.inference — the continuous-batching decode engine."""

from .continuous_batching import (ContinuousBatchingEngine,  # noqa: F401
                                  DecodeRequest, PageAllocator,
                                  RequestStats, create_decode_engine)
from .page_ledger import PageLedger  # noqa: F401
