from . import functional
from .layer import (FusedFeedForward, FusedMultiHeadAttention,
                    FusedTransformerEncoderLayer)

__all__ = ["FusedFeedForward", "FusedMultiHeadAttention",
           "FusedTransformerEncoderLayer", "functional"]
