"""Serving quantization: weight-only int8 (:mod:`.serving`)."""

from .serving import (
    SCALE_FLOOR, QuantizedWeight, channelwise_scales, dequantize_weight,
    quantize_for_serving, quantize_weight,
)

__all__ = ["SCALE_FLOOR", "QuantizedWeight", "channelwise_scales",
           "dequantize_weight", "quantize_for_serving", "quantize_weight"]
