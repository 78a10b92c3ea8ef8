from . import debugging
from .auto_cast import (
    amp_dtype_for, amp_guard, auto_cast, black_list, cast_inputs, decorate,
    is_bf16_supported, is_float16_supported, white_list,
)
from .grad_scaler import AmpScaler, GradScaler, OptimizerState

autocast = auto_cast
is_bfloat16_supported = is_bf16_supported

__all__ = ["AmpScaler", "GradScaler", "OptimizerState", "amp_dtype_for",
           "amp_guard", "auto_cast", "autocast", "black_list", "cast_inputs",
           "debugging", "decorate", "is_bf16_supported", "is_bfloat16_supported",
           "is_float16_supported", "white_list"]
