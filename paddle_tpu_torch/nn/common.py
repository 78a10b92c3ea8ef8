"""The common layers, the counterparts of ``paddle_tpu/nn/layer/common.py``
(all of them): ``Linear``, ``Embedding``, the dropouts, ``Identity``,
``Flatten``/``Unflatten``, the upsamplers, pixel and channel shuffles,
pads, ``CosineSimilarity``, ``Bilinear``, ``Unfold``/``Fold`` and
``PairwiseDistance``, each over its functional.

``Linear`` keeps paddle's ``[in, out]`` weight, as JAX's, so a JAX
``state_dict`` loads as it is.  Parameters come from
``Layer.create_parameter`` with JAX's default initializers (each random
one draws one key of the port's counter stream): ``Linear`` weights
Xavier-normal, biases 0; ``Embedding`` N(0, 1) with the ``padding_idx``
row at 0; ``weight_attr``/``bias_attr`` as JAX's.  Models that want
other initial values (BERT's N(0, 0.02) embeddings) draw them over
these.
"""

from __future__ import annotations

import torch

from .. import tensor as _tensor
from . import functional as F
from .initializer import Normal, XavierNormal
from .layers import Layer


class Linear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        """``weight`` ``[in, out]`` (Xavier-normal), ``bias`` ``[out]``
        (0); ``bias_attr=False`` leaves out the bias, as paddle's."""
        super().__init__(dtype=dtype)
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], weight_attr,
            default_initializer=XavierNormal(), device=device)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [out_features], bias_attr, is_bias=True, device=device))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=None):
        """``sparse`` is accepted and ignored, as JAX's."""
        super().__init__(dtype=dtype)
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], weight_attr,
            default_initializer=(Normal(0.0, 1.0) if weight_attr is None
                                 else None), device=device)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)


class Dropout(Layer):
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


class Identity(Layer):
    def forward(self, x):
        return x


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return _tensor.flatten(x, self.start_axis, self.stop_axis)


class Unflatten(Layer):
    def __init__(self, axis, shape):
        super().__init__()
        self._axis = axis
        self._shape = shape

    def forward(self, x):
        return _tensor.unflatten(x, self._axis, self._shape)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW"):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW"):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Upsample(Layer):
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


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW"):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW"):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW"):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Pad1D(Layer):
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


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class Bilinear(Layer):
    """``weight`` ``[out, in1, in2]`` Xavier-normal over fan-in ``in1`` and
    fan-out ``out`` (JAX's layout, which ``F.bilinear`` contracts as it
    is), ``bias`` ``[out]`` at 0."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], weight_attr,
            default_initializer=XavierNormal(fan_in=in1_features,
                                             fan_out=out_features),
            device=device)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [out_features], bias_attr, is_bias=True, device=device))

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False):
        super().__init__()
        self._kw = dict(p=p, epsilon=epsilon, keepdim=keepdim)

    def forward(self, x, y):
        return F.pairwise_distance(x, y, **self._kw)
