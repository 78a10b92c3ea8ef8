from . import functional
from .activation import GELU, ReLU, Tanh
from .clip import ClipGradByGlobalNorm
from .common import Dropout, Embedding, Linear
from .container import LayerList, Sequential
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
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm, RMSNorm,
)
from .pooling import (
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
    AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
)
from .transformer import (
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer,
)

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "BCELoss",
           "BCEWithLogitsLoss", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "CTCLoss", "ClipGradByGlobalNorm", "Conv1D",
           "Conv1DTranspose", "Conv2D", "Conv2DTranspose", "Conv3D",
           "Conv3DTranspose", "CosineEmbeddingLoss", "CrossEntropyLoss",
           "Dropout", "Embedding", "GELU", "GaussianNLLLoss", "GroupNorm",
           "HSigmoidLoss", "HingeEmbeddingLoss", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "KLDivLoss", "L1Loss",
           "LayerList", "LayerNorm", "Linear", "MSELoss",
           "MarginRankingLoss", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "MultiHeadAttention", "MultiLabelSoftMarginLoss",
           "MultiMarginLoss", "NLLLoss", "PoissonNLLLoss", "RMSNorm", "ReLU",
           "Sequential", "SmoothL1Loss", "SoftMarginLoss", "Tanh",
           "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer",
           "TripletMarginLoss", "TripletMarginWithDistanceLoss",
           "functional"]
