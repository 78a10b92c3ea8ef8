"""paddle_tpu_torch: the PyTorch / CUDA port of paddle_tpu, slice by slice.

It imports ``torch`` and never ``jax`` or ``paddle_tpu``.  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``.  The
kernels that the JAX package wrote in Pallas for the TPU are written by
hand for Hopper (``csrc/`` for CUDA C++, Triton beside its module);
each has a plain PyTorch twin that runs for CPU tensors.

Three slices so far:

* serving a GPT / LLaMA decoder through the continuous-batching engine
  (``serving.Engine``): ragged paged attention
  (``csrc/paged_attention.cu``) and the RMSNorm forward
  (``ops/rms_norm.py``, Triton);
* training that decoder (``jit.TrainStep``, ``optimizer.AdamW``): flash
  attention forward, dQ and dK/dV (``csrc/flash_attention.cu``) and the
  RMSNorm backward;
* training the Stable-Diffusion UNet (``models.UNet2DConditionModel``,
  ``models.unet_loss``): LayerNorm and GroupNorm forward and backward
  (``ops/layer_norm.py``, ``ops/group_norm.py``, Triton) and flash at
  head dims 40/80/160.

On the CPU the UNet runs at a tiny size with ``device="cpu"``, e.g.
``UNet2DConditionModel(UNetConfig(block_out_channels=(16, 32),
layers_per_block=1, cross_attention_dim=16, attention_head_dim=2,
norm_num_groups=4), device="cpu")``, its norms and attention through the
plain twins.  On the card, ``chip_smoke.py``'s kernel cases, its
``unet_train`` (full SD-1.x width) and ``unet_train_parity`` phases
cover it.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
