from . import functional
from .clip import ClipGradByGlobalNorm
from .norm import GroupNorm, LayerNorm

__all__ = ["ClipGradByGlobalNorm", "GroupNorm", "LayerNorm", "functional"]
