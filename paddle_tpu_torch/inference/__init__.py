"""paddle_tpu_torch.inference — the continuous-batching decode engine and
the eval-graph BN folding."""

from .continuous_batching import (ContinuousBatchingEngine,  # noqa: F401
                                  DecodeRequest, PageAllocator,
                                  RequestStats, create_decode_engine)
from .page_ledger import PageLedger  # noqa: F401
from .fusion import (find_foldable_pairs, fold_preserves_outputs,  # noqa: F401
                     fuse_conv_bn)
