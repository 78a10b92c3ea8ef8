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

``unet_state_dict_from_jax`` does the same for the SD UNet
(``models/unet.py``, whose projections are ``torch.nn.Linear`` too): the
weights of its linear layers transpose
(``time_mlp1``, ``time_mlp2``, each ResnetBlock's ``time_emb_proj``, each
attention's ``to_q``, ``to_k``, ``to_v`` and ``to_out``, each
TransformerBlock's ``ff1`` and ``ff2``); convolution weights are OIHW in
both frameworks (in either ``channels_last`` layout) and keep theirs, as
do biases and the GroupNorm / LayerNorm weights and biases.

The models built on the port's ``nn.Linear`` keep paddle's ``[in, out]``
weights, as the JAX models do, and the fused generation stack
(``incubate``) keeps paddle's layout, as the JAX functions and layers
take it, so nothing of theirs transposes: ``load_state_dict`` or
``Model.load`` of a JAX ``state_dict`` loads them as it is, and
``state_from_jax(np_state, model)`` gives the same tensors checked key by
key and shape by shape against ``model.state_dict()`` (BERT, the vision
zoo with its BatchNorm buffers, ``nn.Transformer``, the RNNs, the fused
layers: any model of the port).  ``fused_multi_transformer_params_from_jax``
carries the twelve per-layer weight lists of ``fused_multi_transformer``
across.
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


def _from_jax(np_state, want, device, dtype, is_linear=None):
    """Tensors of the keys ``want`` ({key: torch-layout shape}) from the
    numpy ``np_state``, the keys for which ``is_linear`` holds (if given)
    transposed (paddle ``[in, out]`` -> ``[out, in]``), on ``device`` in
    ``dtype``
    (default: the arrays' own).  Raises on a missing, unexpected or
    misshaped key."""
    dev = resolve_device(device)
    missing = sorted(set(want) - set(np_state))
    extra = sorted(set(np_state) - set(want))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing[:4]}, "
                       f"unexpected {extra[:4]}")
    out = {}
    for key, shape in want.items():
        a = np.asarray(np_state[key])
        if is_linear is not None and is_linear(key):
            a = a.T
        if tuple(a.shape) != shape:
            raise ValueError(f"{key}: shape {tuple(a.shape)} after layout "
                             f"conversion, expected {shape}")
        t = torch.tensor(a)              # a copy: the state stays the caller's
        out[key] = t.to(device=dev, dtype=dtype or t.dtype)
    return out


def state_dict_from_jax(np_state, config, device=None, dtype=None):
    """``dict[str, np.ndarray]`` (the JAX ``state_dict``) ->
    ``dict[str, torch.Tensor]`` on ``device`` (``cuda`` unless asked
    otherwise), in ``dtype`` (default: the arrays' own).  Raises on a
    missing, unexpected or misshaped key."""
    return _from_jax(np_state, expected_shapes(config), device, dtype,
                     _is_linear)


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


_UNET_LINEARS = ("time_mlp1", "time_mlp2", "time_emb_proj", "to_q", "to_k",
                 "to_v", "to_out", "ff1", "ff2")


def unet_expected_shapes(config):
    """``{key: torch-layout shape}`` of a ``UNet2DConditionModel(config)``,
    from the same topology the model builds."""
    from .models.unet import UNet2DConditionModel

    c = config
    ch = c.block_out_channels
    temb = ch[0] * 4
    shapes = {}

    def conv(p, i, o, k):
        shapes[p + ".weight"] = (o, i, k, k)
        shapes[p + ".bias"] = (o,)

    def linear(p, i, o, bias=True):
        shapes[p + ".weight"] = (o, i)
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
    Linear weights are transposed (see the module docstring).  Raises on
    a missing, unexpected or misshaped key."""
    return _from_jax(
        np_state, unet_expected_shapes(config), device, dtype,
        lambda key: key.endswith(".weight") and
        key.rsplit(".", 2)[-2] in _UNET_LINEARS)


def state_from_jax(np_state, model, device=None, dtype=None):
    """A JAX model's ``state_dict`` (as numpy, buffers included) ->
    tensors for ``model.load_state_dict``, ``model`` the port's model (or
    layer) of the same constructor and arguments, on ``device`` (``cuda``
    unless asked otherwise) in ``dtype`` (default: the arrays' own).
    Nothing transposes.  Raises on a missing, unexpected or misshaped
    key."""
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
