"""Stable-Diffusion-style conditional UNet, the counterpart of
``paddle_tpu/models/unet.py`` (SD-1.x topology by default: 0.81 B
parameters at ``block_out_channels=(320, 640, 1280, 1280)``).

Parameter names match the JAX model's ``state_dict()`` key for key, so
``convert.unet_state_dict_from_jax`` maps one onto the other: linear
layers are ``torch.nn.Linear`` (``[out, in]`` weights; paddle's
``[in, out]`` is transposed once, at load), convolutions
``torch.nn.Conv2d`` (OIHW in both frameworks, computed by cuDNN as the
JAX package leaves them to ``lax.conv``).  GroupNorm, LayerNorm and
attention go through :mod:`paddle_tpu_torch.nn.functional`: on the card
the Triton GroupNorm and LayerNorm kernels and the CUDA flash kernels
(head dims 320/8 = 40, 80 and 160, self-attention and cross-attention
over the context's 77 tokens), forward and backward.

Layouts.  ``UNetConfig.channels_last`` keeps both of the JAX model's
branches.  ``False`` (NCHW, the reference layout) is the one whose
GroupNorms reach the kernel, on the card as in JAX (``group_norm``
routes NC* only); ``True`` runs NHWC tensors between the layers: the
convolutions see them as channels-last-strided NCHW views (cuDNN's
native NHWC), the conv<->attention hops are free reshapes, and GroupNorm
is plain torch.

:func:`unet_loss` is ``bench_unet``'s loss (``benchmarks/
bench_models.py:202-204``): ``mse_loss(net(x, t, ctx), target)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as TF
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from ..nn.norm import GroupNorm, LayerNorm


@dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8       # the head COUNT, as in the JAX model
    norm_num_groups: int = 32
    sample_size: int = 64
    channels_last: bool = True


def timestep_embedding(t, dim, max_period=10000):
    """``[B] -> [B, dim]`` f32 sinusoids, cos before sin."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    ang = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


class _Conv2D(nn.Conv2d):
    """``nn.Conv2d`` that takes NHWC tensors when ``channels_last``: the
    permuted view is an NCHW tensor in channels-last memory, which cuDNN
    reads as it is, and the output is permuted back."""

    def __init__(self, in_c, out_c, k, stride=1, padding=0,
                 channels_last=False, **kw):
        super().__init__(in_c, out_c, k, stride=stride, padding=padding,
                         **kw)
        self._nhwc = channels_last

    def forward(self, x):
        if self._nhwc:
            return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return super().forward(x)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_c, out_c, temb_c, groups=32, channels_last=False,
                 **kw):
        super().__init__()
        df = "NHWC" if channels_last else "NCHW"
        self._nhwc = channels_last
        self.norm1 = GroupNorm(min(groups, in_c), in_c, data_format=df, **kw)
        self.conv1 = _Conv2D(in_c, out_c, 3, padding=1,
                             channels_last=channels_last, **kw)
        self.time_emb_proj = nn.Linear(temb_c, out_c, **kw)
        self.norm2 = GroupNorm(min(groups, out_c), out_c, data_format=df,
                               **kw)
        self.conv2 = _Conv2D(out_c, out_c, 3, padding=1,
                             channels_last=channels_last, **kw)
        self.shortcut = _Conv2D(in_c, out_c, 1, channels_last=channels_last,
                                **kw) if in_c != out_c else None

    def forward(self, x, temb):
        h = self.conv1(TF.silu(self.norm1(x)))
        t = self.time_emb_proj(TF.silu(temb))
        h = h + (t[:, None, None, :] if self._nhwc else t[:, :, None, None])
        h = self.conv2(TF.silu(self.norm2(h)))
        sc = self.shortcut(x) if self.shortcut is not None else x
        return h + sc


class CrossAttention(nn.Module):
    def __init__(self, query_dim, context_dim, heads, **kw):
        super().__init__()
        self.heads = heads
        self.head_dim = query_dim // heads
        self.to_q = nn.Linear(query_dim, query_dim, bias=False, **kw)
        self.to_k = nn.Linear(context_dim, query_dim, bias=False, **kw)
        self.to_v = nn.Linear(context_dim, query_dim, bias=False, **kw)
        self.to_out = nn.Linear(query_dim, query_dim, **kw)

    def forward(self, x, context=None):
        b, s, _ = x.shape
        if context is None:
            # self-attention: one [3D, D] GEMM over the concatenated
            # weights, as the JAX model (the state dict keeps three)
            w = torch.cat([self.to_q.weight, self.to_k.weight,
                           self.to_v.weight], dim=0)
            qkv = TF.linear(x, w).view(b, s, 3, self.heads, self.head_dim)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            sk = context.shape[1]
            q = self.to_q(x).view(b, s, self.heads, self.head_dim)
            wkv = torch.cat([self.to_k.weight, self.to_v.weight], dim=0)
            kv = TF.linear(context, wkv).view(b, sk, 2, self.heads,
                                              self.head_dim)
            k, v = kv[:, :, 0], kv[:, :, 1]
        out = F.scaled_dot_product_attention(q, k, v, training=self.training)
        return self.to_out(out.reshape(b, s, self.heads * self.head_dim))


class TransformerBlock2D(nn.Module):
    def __init__(self, dim, context_dim, heads, groups=32,
                 channels_last=False, **kw):
        super().__init__()
        self._nhwc = channels_last
        self.norm_in = GroupNorm(min(groups, dim), dim,
                                 data_format="NHWC" if channels_last
                                 else "NCHW", **kw)
        self.proj_in = _Conv2D(dim, dim, 1, channels_last=channels_last,
                               **kw)
        self.norm1 = LayerNorm(dim, **kw)
        self.attn1 = CrossAttention(dim, dim, heads, **kw)
        self.norm2 = LayerNorm(dim, **kw)
        self.attn2 = CrossAttention(dim, context_dim, heads, **kw)
        self.norm3 = LayerNorm(dim, **kw)
        self.ff1 = nn.Linear(dim, dim * 4, **kw)
        self.ff2 = nn.Linear(dim * 4, dim, **kw)
        self.proj_out = _Conv2D(dim, dim, 1, channels_last=channels_last,
                                **kw)

    def forward(self, x, context):
        residual = x
        y = self.proj_in(self.norm_in(x))
        if self._nhwc:
            b, h, w, c = x.shape
            y = y.reshape(b, h * w, c)
        else:
            b, c, h, w = x.shape
            y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = y + self.attn1(self.norm1(y))
        y = y + self.attn2(self.norm2(y), context)
        y = y + self.ff2(TF.gelu(self.ff1(self.norm3(y))))
        if self._nhwc:
            y = y.reshape(b, h, w, c)
        else:
            y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(y) + residual


class Downsample2D(nn.Module):
    def __init__(self, c, channels_last=False, **kw):
        super().__init__()
        self.conv = _Conv2D(c, c, 3, stride=2, padding=1,
                            channels_last=channels_last, **kw)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, c, channels_last=False, **kw):
        super().__init__()
        self._nhwc = channels_last
        self.conv = _Conv2D(c, c, 3, padding=1, channels_last=channels_last,
                            **kw)

    def forward(self, x):
        if self._nhwc:
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        else:
            x = TF.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(x)


class _Identity(nn.Module):
    def forward(self, x, *a, **k):
        return x


class UNet2DConditionModel(nn.Module):
    """The conditional UNet, built on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``) in ``dtype``, with weights drawn from a
    ``torch.Generator`` seeded by ``seed`` on that device: each conv and
    linear weight from U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (the bound of
    torch's default init), biases 0, norm weights 1 and biases 0."""

    def __init__(self, config: UNetConfig = None, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        c = config or UNetConfig()
        self.config = c
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        cl = bool(c.channels_last)
        self._nhwc = cl
        ch = c.block_out_channels
        temb_c = ch[0] * 4
        self.conv_in = _Conv2D(c.in_channels, ch[0], 3, padding=1,
                               channels_last=cl, **kw)
        self.time_proj_dim = ch[0]
        self.time_mlp1 = nn.Linear(ch[0], temb_c, **kw)
        self.time_mlp2 = nn.Linear(temb_c, temb_c, **kw)
        heads, groups = c.attention_head_dim, c.norm_num_groups

        def attn(out_c):
            return TransformerBlock2D(out_c, c.cross_attention_dim, heads,
                                      groups, channels_last=cl, **kw)

        self.down_resnets = nn.ModuleList()
        self.down_attns = nn.ModuleList()
        self.downsamplers = nn.ModuleList()
        self._down_plan = []
        in_c = ch[0]
        for i, out_c in enumerate(ch):
            use_attn = i < len(ch) - 1  # SD: attn on all but the last level
            for _ in range(c.layers_per_block):
                self.down_resnets.append(ResnetBlock2D(
                    in_c, out_c, temb_c, groups, channels_last=cl, **kw))
                self.down_attns.append(attn(out_c) if use_attn
                                       else _Identity())
                self._down_plan.append(use_attn)
                in_c = out_c
            if i < len(ch) - 1:
                self.downsamplers.append(Downsample2D(out_c, cl, **kw))

        self.mid_res1 = ResnetBlock2D(ch[-1], ch[-1], temb_c, groups,
                                      channels_last=cl, **kw)
        self.mid_attn = attn(ch[-1])
        self.mid_res2 = ResnetBlock2D(ch[-1], ch[-1], temb_c, groups,
                                      channels_last=cl, **kw)

        self.up_resnets = nn.ModuleList()
        self.up_attns = nn.ModuleList()
        self.upsamplers = nn.ModuleList()
        self._up_plan = []
        prev_c = ch[-1]
        for i, out_c in enumerate(reversed(ch)):
            use_attn = i > 0
            skip_ch = self._skip_channels(ch, i, c.layers_per_block)
            for j in range(c.layers_per_block + 1):
                self.up_resnets.append(ResnetBlock2D(
                    prev_c + skip_ch[j], out_c, temb_c, groups,
                    channels_last=cl, **kw))
                self.up_attns.append(attn(out_c) if use_attn
                                     else _Identity())
                self._up_plan.append(use_attn)
                prev_c = out_c
            if i < len(ch) - 1:
                self.upsamplers.append(Upsample2D(out_c, cl, **kw))

        self.conv_norm_out = GroupNorm(groups, ch[0],
                                       data_format="NHWC" if cl else "NCHW",
                                       **kw)
        self.conv_out = _Conv2D(ch[0], c.out_channels, 3, padding=1,
                                channels_last=cl, **kw)
        self._init_weights(dev, seed)

    def _init_weights(self, dev, seed):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (GroupNorm, LayerNorm)):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
                elif isinstance(mod, (nn.Linear, nn.Conv2d)):
                    bound = 1.0 / math.sqrt(mod.weight[0].numel())
                    mod.weight.uniform_(-bound, bound, generator=gen)
                    if mod.bias is not None:
                        mod.bias.zero_()

    @staticmethod
    def _skip_channels(ch, up_idx, layers_per_block):
        """Channels of the skip connections that up-block ``up_idx``
        consumes."""
        stack = [ch[0]]
        for i, out_c in enumerate(ch):
            stack.extend([out_c] * layers_per_block)
            if i < len(ch) - 1:
                stack.append(out_c)
        start = len(stack) - up_idx * (layers_per_block + 1)
        return [stack[start - 1 - j] for j in range(layers_per_block + 1)]

    def forward(self, sample, timestep, encoder_hidden_states):
        """``sample [B, C, H, W]``, ``timestep [B]`` (ints), context
        ``[B, S, cross_attention_dim]`` -> ``[B, out_channels, H, W]``."""
        temb = timestep_embedding(timestep, self.time_proj_dim)
        # the sinusoids are f32; follow the model's dtype from here
        temb = temb.to(self.time_mlp1.weight.dtype)
        temb = self.time_mlp2(TF.silu(self.time_mlp1(temb)))
        if self._nhwc:
            sample = sample.permute(0, 2, 3, 1)
        x = self.conv_in(sample)
        skips = [x]
        ri = di = 0
        ch = self.config.block_out_channels
        for i in range(len(ch)):
            for _ in range(self.config.layers_per_block):
                x = self.down_resnets[ri](x, temb)
                if self._down_plan[ri]:
                    x = self.down_attns[ri](x, encoder_hidden_states)
                skips.append(x)
                ri += 1
            if i < len(ch) - 1:
                x = self.downsamplers[di](x)
                skips.append(x)
                di += 1

        x = self.mid_res1(x, temb)
        x = self.mid_attn(x, encoder_hidden_states)
        x = self.mid_res2(x, temb)

        ri = ui = 0
        for i in range(len(ch)):
            for _ in range(self.config.layers_per_block + 1):
                x = torch.cat([x, skips.pop()], dim=-1 if self._nhwc else 1)
                x = self.up_resnets[ri](x, temb)
                if self._up_plan[ri]:
                    x = self.up_attns[ri](x, encoder_hidden_states)
                ri += 1
            if i < len(ch) - 1:
                x = self.upsamplers[ui](x)
                ui += 1

        x = self.conv_out(TF.silu(self.conv_norm_out(x)))
        if self._nhwc:
            x = x.permute(0, 3, 1, 2)
        return x


def unet_loss(net, x, t, ctx, target):
    """``bench_unet``'s loss: the mean squared error of the prediction."""
    return F.mse_loss(net(x, t, ctx), target)
