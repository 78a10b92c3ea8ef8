from . import functional
from .activation import GELU, ReLU, Tanh
from .clip import ClipGradByGlobalNorm
from .common import Dropout, Embedding, Linear
from .container import LayerList, Sequential
from .conv import (
    Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
    Conv3DTranspose,
)
from .norm import (
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
)
from .pooling import (
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
    AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
)
from .transformer import (
    MultiHeadAttention, TransformerEncoder, TransformerEncoderLayer,
)

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "ClipGradByGlobalNorm", "Conv1D",
           "Conv1DTranspose", "Conv2D", "Conv2DTranspose", "Conv3D",
           "Conv3DTranspose", "Dropout", "Embedding", "GELU", "GroupNorm",
           "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D", "LayerList",
           "LayerNorm", "Linear", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "MultiHeadAttention", "ReLU", "Sequential", "Tanh",
           "TransformerEncoder", "TransformerEncoderLayer", "functional"]
