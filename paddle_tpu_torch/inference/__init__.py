"""paddle_tpu_torch.inference — the continuous-batching decode engine, its
speculative draft sources and the eval-graph BN folding."""

from .continuous_batching import (ContinuousBatchingEngine,  # noqa: F401
                                  DecodeRequest, PageAllocator,
                                  RequestStats, SwapFailed,
                                  create_decode_engine)
from .page_ledger import PageLedger  # noqa: F401
from .fusion import (find_foldable_pairs, fold_preserves_outputs,  # noqa: F401
                     fuse_conv_bn)
from .speculative import (CallableDraft, ModelDraft,  # noqa: F401
                          NGramDraft, SelfDraft, SpeculativeConfig,
                          as_spec_config, device_draft_params)
