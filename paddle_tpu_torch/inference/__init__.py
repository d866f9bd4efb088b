"""paddle_tpu_torch.inference — the continuous-batching decode engine, its
speculative draft sources, the eval-graph BN folding and the predictor
over saved programs (``predictor.py``, ``capi_bridge.py``)."""

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
from .predictor import (Config, DataType, PlaceType,  # noqa: F401
                        PrecisionType, Predictor, PredictorPool, Tensor,
                        Tensor as InferTensor, create_predictor,
                        get_num_bytes_of_data_type, get_version)
