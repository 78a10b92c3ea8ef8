"""Activation layers, the counterparts of
``paddle_tpu/nn/layer/activation.py`` (all 29): each calls its functional
in :mod:`paddle_tpu_torch.nn.functional` with the arguments it was built
with.  ``PReLU`` holds ``weight`` ``[num_parameters]`` at ``init``;
``RReLU`` draws its slopes in training only; ``Softmax2D`` takes a 4-D
NCHW tensor."""

from __future__ import annotations

from . import functional as F
from .initializer import Constant
from .layers import Layer


class _Act(Layer):
    """A parameterless activation: ``fn(x, **kw)``."""

    fn = None

    def __init__(self, **kw):
        super().__init__()
        self._kw = kw

    def forward(self, x):
        return type(self).fn(x, **self._kw)


class ReLU(_Act):
    fn = staticmethod(F.relu)


class ReLU6(_Act):
    fn = staticmethod(F.relu6)


class GELU(_Act):
    fn = staticmethod(F.gelu)

    def __init__(self, approximate=False):
        super().__init__(approximate=approximate)


class SiLU(_Act):
    fn = staticmethod(F.silu)


class Swish(SiLU):
    pass


class Sigmoid(_Act):
    fn = staticmethod(F.sigmoid)


class Tanh(_Act):
    fn = staticmethod(F.tanh)


class LeakyReLU(_Act):
    fn = staticmethod(F.leaky_relu)

    def __init__(self, negative_slope=0.01):
        super().__init__(negative_slope=negative_slope)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype)
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], weight_attr, default_initializer=Constant(init),
            device=device)

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0):
        super().__init__()
        self._lower, self._upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, self.training)


class ELU(_Act):
    fn = staticmethod(F.elu)

    def __init__(self, alpha=1.0):
        super().__init__(alpha=alpha)


class SELU(_Act):
    fn = staticmethod(F.selu)


class CELU(_Act):
    fn = staticmethod(F.celu)

    def __init__(self, alpha=1.0):
        super().__init__(alpha=alpha)


class Mish(_Act):
    fn = staticmethod(F.mish)


class Hardshrink(_Act):
    fn = staticmethod(F.hardshrink)

    def __init__(self, threshold=0.5):
        super().__init__(threshold=threshold)


class Hardsigmoid(_Act):
    fn = staticmethod(F.hardsigmoid)


class Hardswish(_Act):
    fn = staticmethod(F.hardswish)


class Hardtanh(_Act):
    fn = staticmethod(F.hardtanh)

    def __init__(self, min=-1.0, max=1.0):  # noqa: A002  (paddle's names)
        super().__init__(min=min, max=max)


class Softplus(_Act):
    fn = staticmethod(F.softplus)

    def __init__(self, beta=1.0, threshold=20.0):
        super().__init__(beta=beta, threshold=threshold)


class Softshrink(_Act):
    fn = staticmethod(F.softshrink)

    def __init__(self, threshold=0.5):
        super().__init__(threshold=threshold)


class Softsign(_Act):
    fn = staticmethod(F.softsign)


class Tanhshrink(_Act):
    fn = staticmethod(F.tanhshrink)


class ThresholdedReLU(_Act):
    fn = staticmethod(F.thresholded_relu)

    def __init__(self, threshold=1.0, value=0.0):
        super().__init__(threshold=threshold, value=value)


class LogSigmoid(_Act):
    fn = staticmethod(F.log_sigmoid)


class Softmax(_Act):
    fn = staticmethod(F.softmax)

    def __init__(self, axis=-1):
        super().__init__(axis=axis)


class LogSoftmax(_Act):
    fn = staticmethod(F.log_softmax)

    def __init__(self, axis=-1):
        super().__init__(axis=axis)


class Maxout(_Act):
    fn = staticmethod(F.maxout)

    def __init__(self, groups, axis=1):
        super().__init__(groups=groups, axis=axis)


class GLU(_Act):
    fn = staticmethod(F.glu)

    def __init__(self, axis=-1):
        super().__init__(axis=axis)


class Softmax2D(Layer):
    """Softmax over the channels of an NCHW tensor."""

    def forward(self, x):
        if x.dim() != 4:
            raise ValueError("Softmax2D expects a 4-D NCHW tensor")
        return F.softmax(x, axis=1)


__all__ = ["CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid",
           "Hardswish", "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax",
           "Maxout", "Mish", "PReLU", "RReLU", "ReLU", "ReLU6", "SELU",
           "SiLU", "Sigmoid", "Softmax", "Softmax2D", "Softplus",
           "Softshrink", "Softsign", "Swish", "Tanh", "Tanhshrink",
           "ThresholdedReLU"]
