"""``paddle.nn``, the counterpart of ``paddle_tpu/nn/__init__.py``: every
layer (each a ``Layer``, ``torch.nn.Module`` with Paddle's methods),
``functional``, ``initializer``, ``utils``, the clips, ``Parameter`` and
``ParamAttr``."""

from ..core import Parameter
from ..framework.param_attr import ParamAttr
from . import functional, initializer, utils
from .activation import (
    CELU, ELU, GELU, GLU, SELU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
    LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6,
    RReLU, Sigmoid, SiLU, Softmax, Softmax2D, Softplus, Softshrink,
    Softsign, Swish, Tanh, Tanhshrink, ThresholdedReLU,
)
from .clip import (
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_,
    clip_grad_value_,
)
from .common import (
    AlphaDropout, Bilinear, ChannelShuffle, CosineSimilarity, Dropout,
    Dropout2D, Dropout3D, Embedding, Flatten, Fold, Identity, Linear, Pad1D,
    Pad2D, Pad3D, PairwiseDistance, PixelShuffle, PixelUnshuffle, Unflatten,
    Unfold, Upsample, UpsamplingBilinear2D, UpsamplingNearest2D, ZeroPad2D,
)
from .container import LayerDict, LayerList, ParameterList, Sequential
from .decode import BeamSearchDecoder, dynamic_decode
from .layers import Layer
from .loss import (
    BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss, CrossEntropyLoss,
    CTCLoss, GaussianNLLLoss, HingeEmbeddingLoss, HSigmoidLoss, KLDivLoss,
    L1Loss, MarginRankingLoss, MSELoss, MultiLabelSoftMarginLoss,
    MultiMarginLoss, NLLLoss, PoissonNLLLoss, SmoothL1Loss, SoftMarginLoss,
    TripletMarginLoss, TripletMarginWithDistanceLoss,
)
from .conv import (
    Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
    Conv3DTranspose,
)
from .norm import (
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, RMSNorm, SpectralNorm,
)
from .pooling import (
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
    AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D, MaxUnPool1D,
    MaxUnPool2D, MaxUnPool3D,
)
from .rnn import (
    GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell, RNNCellBase, SimpleRNN,
    SimpleRNNCell,
)
from .transformer import (
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer,
)

__all__ = sorted([n for n, v in dict(globals()).items()
                  if isinstance(v, type)] + [
                      "clip_grad_norm_", "clip_grad_value_", "dynamic_decode",
                      "functional", "initializer", "utils"])
