"""Load the JAX package's model weights and optimizer state into the
port.

Every model of the port keeps the JAX model's parameter names and
layouts: a ``Linear.weight`` is paddle's ``[in, out]`` (the port's
``nn.Linear``, under GPT's and the UNet's projections as under BERT,
the vision zoo and ``nn.Transformer``), convolutions are OIHW in both
frameworks, and the fused generation stack (``incubate``) takes
paddle's layout as the JAX functions and layers do.  So nothing here
transposes: ``load_state_dict`` or ``Model.load`` of a JAX
``state_dict`` loads it as it is, and these functions give the same
arrays as tensors on a device, each key and shape checked first.

* ``state_from_jax(np_state, model)`` checks the keys and shapes
  against ``model.state_dict()`` (any model or layer of the port,
  buffers included);
* ``state_dict_from_jax(np_state, config)`` and
  ``unet_state_dict_from_jax(np_state, config)`` check them against the
  shapes a ``GPTForCausalLM(config)`` or ``UNet2DConditionModel(config)``
  has (``expected_shapes``, ``unet_expected_shapes``), without building
  the model;
* ``optimizer_state_from_jax`` carries a JAX ``Adam``/``AdamW`` run's
  accumulators across, so it resumes in the port;
* ``fused_multi_transformer_params_from_jax`` carries the twelve
  per-layer weight lists of ``fused_multi_transformer`` across.

With tied embeddings the JAX GPT has no ``lm_head.weight`` and neither
has the port: both compute the logits against the embedding matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

def expected_shapes(config):
    """``{key: shape}`` of a ``GPTForCausalLM(config)``: projections
    ``[in, out]``."""
    c = config
    hd, kvd = c.num_attention_heads * c.head_dim, c.kv_heads * c.head_dim
    h, f = c.hidden_size, c.intermediate_size
    shapes = {"model.embed_tokens.weight": (c.vocab_size, h)}
    for i in range(c.num_hidden_layers):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (h, hd),
            p + "self_attn.k_proj.weight": (h, kvd),
            p + "self_attn.v_proj.weight": (h, kvd),
            p + "self_attn.o_proj.weight": (hd, h),
            p + "post_attention_layernorm.weight": (h,),
            p + "mlp.gate_proj.weight": (h, f),
            p + "mlp.up_proj.weight": (h, f),
            p + "mlp.down_proj.weight": (f, h),
        })
    shapes["model.norm.weight"] = (h,)
    if not c.tie_word_embeddings:
        shapes["lm_head.weight"] = (h, c.vocab_size)
    return shapes


def _from_jax(np_state, want, device, dtype):
    """Tensors of the keys ``want`` ({key: shape}) from the numpy
    ``np_state``, on ``device`` in ``dtype`` (default: the arrays' own).
    Raises on a missing, unexpected or misshaped key."""
    dev = resolve_device(device)
    missing = sorted(set(want) - set(np_state))
    extra = sorted(set(np_state) - set(want))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing[:4]}, "
                       f"unexpected {extra[:4]}")
    out = {}
    for key, shape in want.items():
        a = np.asarray(np_state[key])
        if tuple(a.shape) != shape:
            raise ValueError(f"{key}: shape {tuple(a.shape)}, expected "
                             f"{shape}")
        t = torch.tensor(a)              # a copy: the state stays the caller's
        out[key] = t.to(device=dev, dtype=dtype or t.dtype)
    return out


def state_dict_from_jax(np_state, config, device=None, dtype=None):
    """``dict[str, np.ndarray]`` (the JAX ``state_dict``) ->
    ``dict[str, torch.Tensor]`` on ``device`` (``cuda`` unless asked
    otherwise), in ``dtype`` (default: the arrays' own).  Raises on a
    missing, unexpected or misshaped key."""
    return _from_jax(np_state, expected_shapes(config), device, dtype)


_ACCUMULATORS = ("moment1", "moment2", "beta1_pow", "beta2_pow",
                 "master_weight")


def optimizer_state_from_jax(np_state, config, device=None):
    """The JAX ``Adam``/``AdamW`` accumulators -> an optimizer
    ``state_dict`` of the port, so a JAX run resumes in the port.

    ``np_state`` maps ``"<model state_dict key>.<accumulator>"`` to arrays
    (``moment1``, ``moment2``, ``beta1_pow``, ``beta2_pow`` and, under
    ``multi_precision``, ``master_weight``: the JAX optimizer's
    ``_accumulators`` of each parameter, keyed by the model's state_dict
    key) and may carry ``"global_step"``; each per-element accumulator
    has its parameter's shape, as in JAX.  Load the result
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
        elif tuple(a.shape) != want[pkey]:
            raise ValueError(f"{key}: shape {tuple(a.shape)}, expected "
                             f"{want[pkey]}")
        out[key] = torch.tensor(a, dtype=torch.float32, device=dev)
    return out


def unet_expected_shapes(config):
    """``{key: shape}`` of a ``UNet2DConditionModel(config)``, from the
    same topology the model builds: linear weights ``[in, out]``,
    convolutions OIHW."""
    from .models.unet import UNet2DConditionModel

    c = config
    ch = c.block_out_channels
    temb = ch[0] * 4
    shapes = {}

    def conv(p, i, o, k):
        shapes[p + ".weight"] = (o, i, k, k)
        shapes[p + ".bias"] = (o,)

    def linear(p, i, o, bias=True):
        shapes[p + ".weight"] = (i, o)
        if bias:
            shapes[p + ".bias"] = (o,)

    def norm(p, n):
        shapes[p + ".weight"] = (n,)
        shapes[p + ".bias"] = (n,)

    def resnet(p, i, o):
        norm(p + ".norm1", i)
        conv(p + ".conv1", i, o, 3)
        linear(p + ".time_emb_proj", temb, o)
        norm(p + ".norm2", o)
        conv(p + ".conv2", o, o, 3)
        if i != o:
            conv(p + ".shortcut", i, o, 1)

    def block(p, d):
        norm(p + ".norm_in", d)
        conv(p + ".proj_in", d, d, 1)
        for a, ctx in (("attn1", d), ("attn2", c.cross_attention_dim)):
            norm(p + ".norm" + a[-1], d)
            linear(f"{p}.{a}.to_q", d, d, bias=False)
            linear(f"{p}.{a}.to_k", ctx, d, bias=False)
            linear(f"{p}.{a}.to_v", ctx, d, bias=False)
            linear(f"{p}.{a}.to_out", d, d)
        norm(p + ".norm3", d)
        linear(p + ".ff1", d, 4 * d)
        linear(p + ".ff2", 4 * d, d)
        conv(p + ".proj_out", d, d, 1)

    conv("conv_in", c.in_channels, ch[0], 3)
    linear("time_mlp1", ch[0], temb)
    linear("time_mlp2", temb, temb)
    r, in_c = 0, ch[0]
    for i, out_c in enumerate(ch):
        for _ in range(c.layers_per_block):
            resnet(f"down_resnets.{r}", in_c, out_c)
            if i < len(ch) - 1:
                block(f"down_attns.{r}", out_c)
            r, in_c = r + 1, out_c
        if i < len(ch) - 1:
            conv(f"downsamplers.{i}.conv", out_c, out_c, 3)
    resnet("mid_res1", ch[-1], ch[-1])
    block("mid_attn", ch[-1])
    resnet("mid_res2", ch[-1], ch[-1])
    r, prev = 0, ch[-1]
    for i, out_c in enumerate(reversed(ch)):
        skip = UNet2DConditionModel._skip_channels(ch, i, c.layers_per_block)
        for j in range(c.layers_per_block + 1):
            resnet(f"up_resnets.{r}", prev + skip[j], out_c)
            if i > 0:
                block(f"up_attns.{r}", out_c)
            r, prev = r + 1, out_c
        if i < len(ch) - 1:
            conv(f"upsamplers.{i}.conv", out_c, out_c, 3)
    norm("conv_norm_out", ch[0])
    conv("conv_out", ch[0], c.out_channels, 3)
    return shapes


def unet_state_dict_from_jax(np_state, config, device=None, dtype=None):
    """The JAX ``UNet2DConditionModel``'s ``state_dict`` (as numpy) ->
    tensors for the port's ``load_state_dict``, on ``device`` (``cuda``
    unless asked otherwise) in ``dtype`` (default: the arrays' own).
    Raises on a missing, unexpected or misshaped key."""
    return _from_jax(np_state, unet_expected_shapes(config), device, dtype)


def state_from_jax(np_state, model, device=None, dtype=None):
    """A JAX model's ``state_dict`` (as numpy, buffers included) ->
    tensors for ``model.load_state_dict``, ``model`` the port's model (or
    layer) of the same constructor and arguments, on ``device`` (``cuda``
    unless asked otherwise) in ``dtype`` (default: the arrays' own).
    Raises on a missing, unexpected or misshaped key."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    return _from_jax(np_state, want, device, dtype)


#: the per-layer weight lists of ``fused_multi_transformer``, in its order
FUSED_MT_WEIGHTS = ("ln_scales", "ln_biases", "qkv_weights", "qkv_biases",
                    "linear_weights", "linear_biases", "ffn_ln_scales",
                    "ffn_ln_biases", "ffn1_weights", "ffn1_biases",
                    "ffn2_weights", "ffn2_biases")


def fused_multi_transformer_params_from_jax(np_params, device=None,
                                            dtype=None):
    """``{name: [array or None per layer] or None}`` over the twelve
    names of :data:`FUSED_MT_WEIGHTS` (numpy) -> the same lists of
    tensors on ``device`` (``cuda`` unless asked otherwise) in ``dtype``
    (default: the arrays' own), ready to pass as keyword arguments.
    Raises on a missing or unexpected name, or lists of unequal
    length."""
    dev = resolve_device(device)
    if set(np_params) != set(FUSED_MT_WEIGHTS):
        raise KeyError(f"fused_multi_transformer weights: missing "
                       f"{sorted(set(FUSED_MT_WEIGHTS) - set(np_params))}, "
                       f"unexpected "
                       f"{sorted(set(np_params) - set(FUSED_MT_WEIGHTS))}")
    lengths = {len(v) for v in np_params.values() if v is not None}
    if len(lengths) != 1:
        raise ValueError(f"fused_multi_transformer weights: per-layer "
                         f"lists of lengths {sorted(lengths)}")
    out = {}
    for name in FUSED_MT_WEIGHTS:
        lst = np_params[name]
        out[name] = None if lst is None else [
            None if a is None else
            torch.tensor(np.asarray(a)).to(device=dev, dtype=dtype)
            for a in lst]
    return out
