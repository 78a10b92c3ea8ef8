"""paddle_tpu_torch: the PyTorch / CUDA port of paddle_tpu, slice by slice.

It imports ``torch`` and never ``jax`` or ``paddle_tpu``.  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``.  The
kernels that the JAX package wrote in Pallas for the TPU are written by
hand for Hopper (``csrc/`` for CUDA C++, Triton beside its module);
each has a plain PyTorch twin that runs for CPU tensors.

Eight paths so far:

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
  attention runs JAX's plain f32 path, ``nn.functional.sdpa_plain``);
* ResNet image classification (``vision.models.resnet50`` and the rest
  of the family, over ``nn``'s convolution, pooling and BatchNorm
  layers, ``metric.Accuracy``, and ``amp.auto_cast`` with
  ``amp.GradScaler`` through ``jit.TrainStep(scaler=)``): no Pallas
  kernel lies on it, so convolutions are cuDNN's and the rest plain
  torch, as the JAX package computes them outside Pallas;
* the high-level training API over those models: ``Model``
  (``hapi``: ``prepare``, ``fit``, ``evaluate``, ``predict``, ``save``
  and ``load``, the callbacks, ``summary`` and ``flops``) fed by ``io``
  (datasets, samplers and a ``DataLoader`` that lands batches on the
  card through pinned host memory) from ``vision.datasets`` and
  ``vision.transforms``, with the loss layers of ``nn`` and
  ``save``/``load`` (``framework``), which also read the JAX package's
  files.  It adds no kernel: a BERT model fitted through it runs the
  LayerNorm and flash kernels as its ``TrainStep`` does;
* Paddle's fused generation stack (``incubate``: the fused functionals
  of ``incubate.nn.functional`` with ``fused_multi_transformer`` and
  ``masked_multihead_attention`` over fixed-capacity KV caches, the
  fused layers, ``LookAhead`` and ``ModelAverage``; ``nn.RMSNorm``, the
  public flash functionals, ``inference.create_llm_engine``): the flash
  forward on the causal prefill, the LayerNorm kernels in the fused
  layers and the stack's norms, the RMSNorm kernel through
  ``fused_rms_norm``; the decode attention over the cache is plain
  torch, as JAX's is jnp;
* the tensor surface (``tensor``: every function of JAX's tensor
  namespace, re-exported here as JAX's root does, functions only;
  ``linalg``, ``fft``, ``signal``) and the recurrent layers of ``nn``
  with ``BeamSearchDecoder``/``dynamic_decode``, driven by an attention
  LSTM seq2seq: cuDNN's fused RNN, cuBLAS, cuSOLVER and cuFFT, as the
  JAX package computes these outside Pallas.

On the CPU the UNet runs at a tiny size with ``device="cpu"``, e.g.
``UNet2DConditionModel(UNetConfig(block_out_channels=(16, 32),
layers_per_block=1, cross_attention_dim=16, attention_head_dim=2,
norm_num_groups=4), device="cpu")``, its norms and attention through the
plain twins.  On the card, ``chip_smoke.py``'s kernel cases, its
``unet_train`` (full SD-1.x width) and ``unet_train_parity`` phases
cover it; ``bert_train``, ``bert_train_flash``, ``bert_parity``,
``train_recompute`` and ``optimizers`` cover the fourth path.  ResNet
runs on the CPU at a tiny size, e.g. ``resnet18(num_classes=10,
device="cpu")`` on 32 px images; ``resnet_train``, ``resnet_amp`` and
``resnet_parity`` drive ResNet-50 at 224 px on the card.  ``Model.fit``
runs on the CPU with ``device="cpu"`` models and ``places="cpu"``
loaders; ``hapi_fit`` (ResNet-50 from ``FakeData`` through the threaded
loader) and ``hapi_fit_bert`` (BERT-base) drive it on the card.  The
fused stack runs on the CPU at a tiny size on CPU tensors (its functions
run where their tensors lie); ``fused_decode`` (GPT-3 6.7B widths),
``fused_rotary`` and ``fused_layers`` drive it on the card.

The root is Paddle's namespace, as JAX's: ``to_tensor`` (on the current
device), the grad modes, ``grad``, the dtype names and default dtype,
``set_device``/``get_device`` (``"gpu"`` is the card and raises without
one), the flags, ``finfo``/``iinfo``, ``Tensor`` (``torch.Tensor``),
``Parameter``, ``Layer`` (``torch.nn.Module`` with Paddle's methods;
every layer of the port is one), ``ParamAttr``, ``LazyGuard`` and
``__version__``; the heavy subpackages (``serving``, ``optimizer``,
``jit``, ...) and the small host modules (``autograd``, ``profiler``,
``text``, ``hub``, ``utils``, ``sysconfig``) are attached on first use,
so importing the package builds no kernel.  ``layer_api`` drives a
script written against it on the card, ``host_api`` the host modules.
``enable_static``/``disable_static`` switch Paddle's static-graph mode
(``static``: programs recorded on symbolic tensors and replayed through
the kernels by ``static.Executor``, trained through
``Optimizer.minimize``); ``static_graph`` drives it on the card.
"""

import importlib

from . import tensor
from .tensor import *  # noqa: F401,F403  (JAX's root: from .tensor import *)
from . import (amp, device, fft, framework, hapi, incubate, inference, io,
               linalg, metric, nn, signal, version, vision)
from .core import (Parameter, Tensor, enable_grad, grad, is_grad_enabled,
                   no_grad, set_grad_enabled, to_tensor)
from .device import (device_count, get_cudnn_version, get_device,
                     is_compiled_with_cuda, is_compiled_with_rocm,
                     is_compiled_with_xpu, resolve_device, set_device,
                     synchronize)
from .dtype import (bfloat16, bool_, complex64, complex128, float16, float32,
                    float64, get_default_dtype, int8, int16, int32, int64,
                    set_default_dtype, uint8)
from .flags import get_flags, set_flags
from .framework import load, save
from .framework.dtype_info import finfo, iinfo
from .framework.param_attr import ParamAttr
from .hapi import Model, flops, summary
from .io.reader_compat import batch
from .nn import Layer
from .nn.initializer import LazyGuard
from .random import get_rng_state, seed, set_rng_state
from .version import full_version as __version__

#: attached on first use (PEP 562), as JAX's root attaches its subpackages:
#: importing the package builds no kernel and starts no serving engine
_LAZY_SUBMODULES = ("autograd", "distributed", "hub", "jit", "models",
                    "onnx", "optimizer", "profiler", "quantization",
                    "regularizer", "serving", "static", "sysconfig", "text",
                    "utils")


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def enable_static():
    """Enter static-graph mode: ``static.data`` placeholders, recorded
    ops and ``static.Executor.run`` (see ``paddle_tpu_torch.static``)."""
    from .static.graph import enable_static as _enable

    _enable()


def disable_static(place=None):
    """Leave static-graph mode (back to eager, the default)."""
    from .static.graph import disable_static as _disable

    _disable()


def in_dynamic_mode():
    """False between ``enable_static()`` and ``disable_static()``."""
    from .tensor.logic import in_dynamic_mode as _dynamic

    return _dynamic()


__all__ = sorted(tensor.__all__ + list(_LAZY_SUBMODULES) + [
    "LazyGuard", "Layer", "Model", "ParamAttr", "Parameter", "Tensor", "amp",
    "batch", "bfloat16", "bool_", "complex128", "complex64", "device",
    "device_count", "disable_static", "enable_grad", "enable_static", "fft",
    "finfo", "float16", "float32", "float64", "flops", "framework",
    "get_default_dtype", "get_device", "get_cudnn_version", "get_flags", "get_rng_state", "grad", "hapi",
    "iinfo", "in_dynamic_mode", "incubate", "inference", "int16", "int32",
    "int64", "int8", "io", "is_compiled_with_cuda", "is_compiled_with_rocm",
    "is_compiled_with_xpu", "is_grad_enabled", "linalg", "load", "metric",
    "nn", "no_grad", "resolve_device", "save", "seed", "set_default_dtype",
    "set_device", "set_flags", "set_grad_enabled", "set_rng_state",
    "signal", "summary", "synchronize", "tensor", "to_tensor", "uint8",
    "version", "vision"])
