from .flash_attention import (
    flash_attention, flash_attention_plain, flash_bwd, flash_bwd_dkv_kernel,
    flash_bwd_dq_kernel, flash_fwd, flash_fwd_kernel,
)
from .fused_ce import fused_linear_cross_entropy
from .group_norm import group_norm, group_norm_bwd, group_norm_plain
from .layer_norm import layer_norm, layer_norm_bwd, layer_norm_plain
from .rms_norm import rms_norm, rms_norm_bwd, rms_norm_plain
from .rope import apply_rotary_emb


def _counters():
    from ..serving.paged_attention import paged_attention

    return {"paged_attention": paged_attention, "rms_norm": rms_norm,
            "rms_norm_bwd": rms_norm_bwd, "flash_fwd": flash_fwd_kernel,
            "flash_bwd_dq": flash_bwd_dq_kernel,
            "flash_bwd_dkv": flash_bwd_dkv_kernel,
            "layer_norm": layer_norm, "layer_norm_bwd": layer_norm_bwd,
            "group_norm": group_norm, "group_norm_bwd": group_norm_bwd}


def kernel_launches():
    """The process-wide launch counts of every kernel wrapper of the
    port (each adds one where it launches its kernel, and nowhere
    else)."""
    return {name: fn.launches for name, fn in _counters().items()}


def reset_kernel_launches():
    for fn in _counters().values():
        fn.launches = 0


__all__ = ["flash_attention", "flash_attention_plain", "flash_fwd",
           "flash_bwd", "fused_linear_cross_entropy", "group_norm",
           "group_norm_bwd", "group_norm_plain", "layer_norm",
           "layer_norm_bwd", "layer_norm_plain", "rms_norm",
           "rms_norm_bwd", "rms_norm_plain", "apply_rotary_emb",
           "kernel_launches", "reset_kernel_launches"]
