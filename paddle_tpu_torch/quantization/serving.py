"""Weight-only int8 quantization for the serving engine (counterpart of
``paddle_tpu/quantization/serving.py``).

Decode reads every weight once a step, so storing the matmul weights
as int8 halves the bytes a bf16 model keeps resident.  Each weight is
rebuilt as ``(q.float() * scale).to(dtype)`` before its product, as the
JAX engine's ``_run_model`` does; the product itself stays the serving
path's row-tiled cuBLAS product (``models.gpt.tiled_linear``).

Scale layout: one absmax scale per OUTPUT channel.  The port's
``nn.Linear`` stores its weight ``[in_features, out_features]``, as
paddle's, so the per-output scale reduces axis 0 and has shape
``[1, out]``: payload and scales equal the JAX package's bit for bit.
The floor is applied per channel (``max(absmax, 1e-8)``) before any
division, so an all-zero output channel quantizes to exact zeros
instead of 0/0.

:func:`quantize_for_serving` quantizes every ``nn.Linear`` weight of a
model (the q/k/v/o projections, the SwiGLU MLP, the LM head).
Embeddings and norms stay in their dtype.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..nn.common import Linear

#: per-channel absmax floor: an all-zero channel quantizes to zeros
#: (scale floor / qmax) instead of dividing by zero
SCALE_FLOOR = 1e-8


def channelwise_scales(w, channel_axis=-1, quant_bits=8):
    """Per-channel symmetric quantization step for ``w``: absmax over
    every dim except ``channel_axis`` (-1, the output channel of an
    ``[in, out]`` weight), floored at :data:`SCALE_FLOOR` per channel,
    divided by the int range; f32, with ``keepdim`` so it broadcasts
    against ``w``."""
    qmax = float(2 ** (quant_bits - 1) - 1)
    axis = channel_axis % w.dim()
    dims = tuple(i for i in range(w.dim()) if i != axis)
    absmax = w.float().abs().amax(dim=dims, keepdim=True)
    return absmax.clamp_min(SCALE_FLOOR) / qmax


def quantize_weight(w, channel_axis=-1, quant_bits=8):
    """Symmetric per-channel int8 quantization: ``(q, scale)`` with ``q``
    int8 shaped like ``w`` and ``scale`` f32 broadcastable against it
    (:func:`dequantize_weight` inverts)."""
    qmax = float(2 ** (quant_bits - 1) - 1)
    scale = channelwise_scales(w, channel_axis, quant_bits)
    q = torch.round(w.float() / scale).clamp(-qmax, qmax)
    return q.to(torch.int8), scale


def dequantize_weight(q, scale, dtype=torch.float32):
    """``(q.float() * scale).to(dtype)`` in one elementwise pass: the
    product is taken in f32 and rounded once to ``dtype``."""
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    return torch.mul(q, scale, out=out)


@dataclass
class QuantizedWeight:
    """One serving-quantized weight: int8 payload, f32 per-channel scale
    and the dtype :meth:`dequantize` restores."""

    q: torch.Tensor
    scale: torch.Tensor
    dtype: torch.dtype

    def dequantize(self):
        return dequantize_weight(self.q, self.scale, self.dtype)

    @property
    def nbytes(self):
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())


def quantize_for_serving(model, quant_bits=8):
    """Absmax-calibrate every ``nn.Linear`` weight of ``model``: returns
    ``{state_dict name: QuantizedWeight}`` (no calibration data: the
    scales depend on the weights alone).  The caller keeps the model's
    weights and substitutes the dequantized ones on its own path."""
    out = {}
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, Linear):
                w = mod.weight
                q, scale = quantize_weight(w, -1, quant_bits)
                out[f"{name}.weight"] = QuantizedWeight(q, scale, w.dtype)
    return out
