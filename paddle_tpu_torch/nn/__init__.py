"""``paddle.nn``: layers, containers, initializers and the functional
API (port of ``paddle_tpu/nn/__init__.py``, with its export list).

Every layer is a ``Layer`` (a ``torch.nn.Module``); the containers
(``LayerList``, ``LayerDict``, ``ParameterList``) are ``Layer``s too,
``utils`` holds the weight reparametrisations, and ``functional_call`` /
``bind_state`` / ``functional_state`` run a layer as a function of its
state.
"""

from ..optimizer.clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa
                              ClipGradByValue)
from . import functional, initializer, utils  # noqa: F401
from .activation import (CELU, ELU, GELU, GLU, Hardshrink,  # noqa: F401
                         Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
                         LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU,
                         ReLU6, SELU, Sigmoid, Silu, Softmax, Softplus,
                         Softshrink, Softsign, Swish, Tanh, Tanhshrink,
                         ThresholdedReLU)
from .common import (AlphaDropout, Bilinear, CosineSimilarity,  # noqa: F401
                     Dropout, Dropout2D, Dropout3D, Embedding, Flatten, Fold,
                     Identity, Linear, Pad1D, Pad2D, Pad3D, PairwiseDistance,
                     PixelShuffle, Unfold, Upsample, UpsamplingBilinear2D,
                     UpsamplingNearest2D, ZeroPad2D)
from .container import (LayerDict, LayerList,  # noqa: F401
                        ParameterList, Sequential)
from .conv import (Conv1D, Conv1DTranspose, Conv2D,  # noqa: F401
                   Conv2DTranspose, Conv3D, Conv3DTranspose, DeformConv2D)
from .decode import BeamSearchDecoder, dynamic_decode  # noqa: F401
from .initializer import ParamAttr  # noqa: F401
from .layer import (Layer, bind_state, functional_call,  # noqa: F401
                    functional_state)
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,  # noqa
                   CrossEntropyLoss, CTCLoss, GaussianNLLLoss, HingeEmbeddingLoss,
                   HSigmoidLoss, KLDivLoss, L1Loss, MarginRankingLoss,
                   MSELoss, MultiLabelSoftMarginLoss, NLLLoss,
                   PoissonNLLLoss, SmoothL1Loss, SoftMarginLoss,
                   TripletMarginLoss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                   BatchNorm3D, DataNorm, GroupNorm, InstanceNorm1D,
                   InstanceNorm2D, InstanceNorm3D, LayerNorm,
                   LocalResponseNorm, RMSNorm, SpectralNorm, SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,  # noqa: F401
                      AdaptiveAvgPool3D, AdaptiveMaxPool1D, AdaptiveMaxPool2D,
                      AdaptiveMaxPool3D, AvgPool1D, AvgPool2D, AvgPool3D,
                      LPPool2D, MaxPool1D, MaxPool2D, MaxPool3D)
from .rnn import (BiRNN, GRU, GRUCell, LSTM, LSTMCell, RNN,  # noqa: F401
                  RNNCellBase, SimpleRNN, SimpleRNNCell)
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
