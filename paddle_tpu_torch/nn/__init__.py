from . import functional
from .activation import GELU, Tanh
from .clip import ClipGradByGlobalNorm
from .common import Dropout, Embedding, Linear
from .norm import GroupNorm, LayerNorm
from .transformer import (
    MultiHeadAttention, TransformerEncoder, TransformerEncoderLayer,
)

__all__ = ["ClipGradByGlobalNorm", "Dropout", "Embedding", "GELU",
           "GroupNorm", "LayerNorm", "Linear", "MultiHeadAttention", "Tanh",
           "TransformerEncoder", "TransformerEncoderLayer", "functional"]
