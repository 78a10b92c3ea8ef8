"""The common layers, the counterparts of ``paddle_tpu/nn/layer/common.py``
(all of them): ``Linear``, ``Embedding``, the dropouts, ``Identity``,
``Flatten``/``Unflatten``, the upsamplers, pixel and channel shuffles,
pads, ``CosineSimilarity``, ``Bilinear``, ``Unfold``/``Fold`` and
``PairwiseDistance``, each over its functional.

``Linear`` keeps the port's ``[out, in]`` weight (torch's layout;
``convert`` transposes paddle's ``[in, out]`` at load).  Initial values
follow the JAX layers' defaults, drawn from the port's counter stream
(:mod:`paddle_tpu_torch.random`), one key a parameter: ``Linear`` weights
Xavier-normal, biases 0; ``Embedding`` N(0, 1) with the ``padding_idx``
row at 0.  Models that want other initial values (BERT's N(0, 0.02)
embeddings) draw them over these.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import random as _random
from .. import tensor as _tensor
from . import functional as F


class Linear(nn.Module):
    def __init__(self, in_features, out_features, bias_attr=None,
                 device=None, dtype=None):
        """``bias_attr=False`` leaves out the bias, as paddle's."""
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               **kw))
        std = math.sqrt(2.0 / (in_features + out_features))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=_random.next_generator(
                self.weight.device))
        self.bias = (None if bias_attr is False else
                     nn.Parameter(torch.zeros(out_features, **kw)))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, device=None, dtype=None):
        """``sparse`` is accepted and ignored, as JAX's."""
        super().__init__()
        self._padding_idx = padding_idx
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=_random.next_generator(
                self.weight.device))
            if padding_idx is not None:
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)


class Dropout(nn.Module):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Identity(nn.Module):
    def forward(self, x):
        return x


class Flatten(nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return _tensor.flatten(x, self.start_axis, self.stop_axis)


class Unflatten(nn.Module):
    def __init__(self, axis, shape):
        super().__init__()
        self._axis = axis
        self._shape = shape

    def forward(self, x):
        return _tensor.unflatten(x, self._axis, self._shape)


class Dropout2D(nn.Module):
    def __init__(self, p=0.5, data_format="NCHW"):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(nn.Module):
    def __init__(self, p=0.5, data_format="NCDHW"):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(nn.Module):
    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Upsample(nn.Module):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW"):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW"):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class UpsamplingBilinear2D(Upsample):
    """Bilinear with ``align_corners=True``, as JAX's."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW"):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class PixelShuffle(nn.Module):
    def __init__(self, upscale_factor, data_format="NCHW"):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(nn.Module):
    def __init__(self, downscale_factor, data_format="NCHW"):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(nn.Module):
    def __init__(self, groups, data_format="NCHW"):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Pad1D(nn.Module):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL"):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad2D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW"):
        super().__init__(padding, mode, value, data_format)


class Pad3D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW"):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW"):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(nn.Module):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class Bilinear(nn.Module):
    """``weight`` ``[out, in1, in2]`` Xavier-normal over fan-in ``in1`` and
    fan-out ``out`` (JAX's layout, which ``F.bilinear`` contracts as it
    is), ``bias`` ``[out]`` at 0."""

    def __init__(self, in1_features, in2_features, out_features,
                 bias_attr=None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(
            out_features, in1_features, in2_features, **kw))
        std = math.sqrt(2.0 / (in1_features + out_features))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=_random.next_generator(
                self.weight.device))
        self.bias = (None if bias_attr is False else
                     nn.Parameter(torch.zeros(out_features, **kw)))

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(nn.Module):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(nn.Module):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)


class PairwiseDistance(nn.Module):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False):
        super().__init__()
        self._kw = dict(p=p, epsilon=epsilon, keepdim=keepdim)

    def forward(self, x, y):
        return F.pairwise_distance(x, y, **self._kw)
