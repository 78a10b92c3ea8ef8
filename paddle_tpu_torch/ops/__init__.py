from .rms_norm import rms_norm, rms_norm_plain
from .rope import apply_rotary_emb

__all__ = ["rms_norm", "rms_norm_plain", "apply_rotary_emb"]
