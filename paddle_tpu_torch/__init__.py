"""paddle_tpu_torch: the PyTorch / CUDA port of paddle_tpu, slice by slice.

It imports ``torch`` and never ``jax`` or ``paddle_tpu``.  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``.  The
kernels that the JAX package wrote in Pallas for the TPU are written by
hand for Hopper (``csrc/`` for CUDA C++, Triton beside its module);
each has a plain PyTorch twin that runs for CPU tensors.

This slice serves a GPT / LLaMA decoder through the continuous-batching
engine (``serving.Engine``) with two kernels: ragged paged attention
(``csrc/paged_attention.cu``) and the RMSNorm forward
(``ops/rms_norm.py``, Triton).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
