"""paddle_tpu_torch: the PyTorch / CUDA port of paddle_tpu, slice by slice.

It imports ``torch`` and never ``jax`` or ``paddle_tpu``.  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``.  The
kernels that the JAX package wrote in Pallas for the TPU are written by
hand for Hopper (``csrc/`` for CUDA C++, Triton beside its module);
each has a plain PyTorch twin that runs for CPU tensors.

Four paths so far:

* serving a GPT / LLaMA decoder through the continuous-batching engine
  (``serving.Engine``), reached over HTTP through the gateway
  (``serving.gateway``, with ``observability`` and ``serving.faults``):
  ragged paged attention (``csrc/paged_attention.cu``) and the RMSNorm
  forward (``ops/rms_norm.py``, Triton);
* training that decoder (``jit.TrainStep``, ``optimizer.AdamW``): flash
  attention forward, dQ and dK/dV (``csrc/flash_attention.cu``) and the
  RMSNorm backward;
* training the Stable-Diffusion UNet (``models.UNet2DConditionModel``,
  ``models.unet_loss``): LayerNorm and GroupNorm forward and backward
  (``csrc/norms.cu``, bound in ``ops/layer_norm.py`` and
  ``ops/group_norm.py``) and flash at head dims 40/80/160;
* BERT masked-LM pretraining (``models.BertForMaskedLM``, on
  ``nn.TransformerEncoder``, with ``nn.Dropout`` and the counter stream
  of ``random``, the optimizers and schedules of ``optimizer``, and
  ``distributed.recompute``): the LayerNorm kernels at H 768 and flash
  at head dim 64 (without a mask and attention dropout; with either,
  attention runs JAX's plain f32 path, ``nn.functional.sdpa_plain``).

On the CPU the UNet runs at a tiny size with ``device="cpu"``, e.g.
``UNet2DConditionModel(UNetConfig(block_out_channels=(16, 32),
layers_per_block=1, cross_attention_dim=16, attention_head_dim=2,
norm_num_groups=4), device="cpu")``, its norms and attention through the
plain twins.  On the card, ``chip_smoke.py``'s kernel cases, its
``unet_train`` (full SD-1.x width) and ``unet_train_parity`` phases
cover it; ``bert_train``, ``bert_train_flash``, ``bert_parity``,
``train_recompute`` and ``optimizers`` cover the fourth path.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
