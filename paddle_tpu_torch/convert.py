"""Load the JAX package's model weights and optimizer state into the
port.

``state_dict_from_jax`` takes the arrays of a JAX ``GPTForCausalLM``'s
``state_dict()`` (as numpy, e.g. ``{k: v.numpy() for k, v in
m.state_dict().items()}``) and returns tensors for the port's
``GPTForCausalLM.load_state_dict``: the keys are the same.

Layout: a paddle ``Linear.weight`` is ``[in, out]``
(``paddle_tpu/nn/layer/common.py``); the port's projections are
``torch.nn.Linear`` with ``[out, in]`` weights, so every projection
matrix is transposed here, once.  Embeddings (``[vocab, hidden]``) and
norm weights keep their layout.  With tied embeddings the JAX model has
no ``lm_head.weight`` and neither has the port: both compute the logits
against the embedding matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

_PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                "up_proj", "down_proj")


def expected_shapes(config):
    """``{key: torch-layout shape}`` of a ``GPTForCausalLM(config)``."""
    c = config
    hd, kvd = c.num_attention_heads * c.head_dim, c.kv_heads * c.head_dim
    h, f = c.hidden_size, c.intermediate_size
    shapes = {"model.embed_tokens.weight": (c.vocab_size, h)}
    for i in range(c.num_hidden_layers):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (hd, h),
            p + "self_attn.k_proj.weight": (kvd, h),
            p + "self_attn.v_proj.weight": (kvd, h),
            p + "self_attn.o_proj.weight": (h, hd),
            p + "post_attention_layernorm.weight": (h,),
            p + "mlp.gate_proj.weight": (f, h),
            p + "mlp.up_proj.weight": (f, h),
            p + "mlp.down_proj.weight": (h, f),
        })
    shapes["model.norm.weight"] = (h,)
    if not c.tie_word_embeddings:
        shapes["lm_head.weight"] = (c.vocab_size, h)
    return shapes


def _is_linear(key):
    return key == "lm_head.weight" or \
        key.rsplit(".", 2)[-2] in _PROJECTIONS


def state_dict_from_jax(np_state, config, device=None, dtype=None):
    """``dict[str, np.ndarray]`` (the JAX ``state_dict``) ->
    ``dict[str, torch.Tensor]`` on ``device`` (``cuda`` unless asked
    otherwise), in ``dtype`` (default: the arrays' own).  Raises on a
    missing, unexpected or misshaped key."""
    dev = resolve_device(device)
    want = expected_shapes(config)
    missing = sorted(set(want) - set(np_state))
    extra = sorted(set(np_state) - set(want))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing[:4]}, "
                       f"unexpected {extra[:4]}")
    out = {}
    for key, shape in want.items():
        a = np.asarray(np_state[key])
        if _is_linear(key):
            a = a.T                       # paddle [in, out] -> [out, in]
        if tuple(a.shape) != shape:
            raise ValueError(f"{key}: shape {tuple(a.shape)} after layout "
                             f"conversion, expected {shape}")
        t = torch.tensor(a)              # a copy: the state stays the caller's
        out[key] = t.to(device=dev, dtype=dtype or t.dtype)
    return out


_ACCUMULATORS = ("moment1", "moment2", "beta1_pow", "beta2_pow",
                 "master_weight")


def optimizer_state_from_jax(np_state, config, device=None):
    """The JAX ``Adam``/``AdamW`` accumulators -> an optimizer
    ``state_dict`` of the port, so a JAX run resumes in the port.

    ``np_state`` maps ``"<model state_dict key>.<accumulator>"`` to arrays
    (``moment1``, ``moment2``, ``beta1_pow``, ``beta2_pow`` and, under
    ``multi_precision``, ``master_weight``: the JAX optimizer's
    ``_accumulators`` of each parameter, keyed by the model's state_dict
    key) and may carry ``"global_step"``.  Per-element accumulators of a
    ``Linear`` weight are transposed as the weight is.  Load the result
    with ``optimizer.set_state_dict`` on an optimizer built from
    ``model.named_parameters()``.  Raises on a key that names no
    parameter or accumulator, or a misshaped array."""
    dev = resolve_device(device)
    want = expected_shapes(config)
    out = {"global_step": int(np_state.get("global_step", 0))}
    for key, a in np_state.items():
        if key == "global_step":
            continue
        pkey, _, acc = key.rpartition(".")
        if pkey not in want or acc not in _ACCUMULATORS:
            raise KeyError(f"optimizer state {key!r} names no parameter "
                           "accumulator of this config")
        a = np.asarray(a)
        if acc in ("beta1_pow", "beta2_pow"):
            if a.size != 1:
                raise ValueError(f"{key}: shape {a.shape}, expected a scalar")
            a = a.reshape(())
        else:
            if _is_linear(pkey):
                a = a.T
            if tuple(a.shape) != want[pkey]:
                raise ValueError(f"{key}: shape {tuple(a.shape)} after "
                                 f"layout conversion, expected {want[pkey]}")
        out[key] = torch.tensor(a, dtype=torch.float32, device=dev)
    return out
