"""MobileNetV2, the counterpart of ``paddle_tpu/vision/models/mobilenetv2.py``:
inverted residuals with ReLU6, a Dropout(0.2) head."""

from __future__ import annotations

from ...nn import (
    AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Linear, ReLU6,
    Sequential,
)
from ...nn.layers import Layer
from ...tensor import flatten
from ._ops import make_divisible, model_kw, no_pretrained, seeded


class ConvBNReLU(Sequential):
    def __init__(self, in_planes, out_planes, kernel_size=3, stride=1,
                 groups=1, device=None, dtype=None):
        kw = dict(device=device, dtype=dtype)
        super().__init__(
            Conv2D(in_planes, out_planes, kernel_size, stride,
                   (kernel_size - 1) // 2, groups=groups, bias_attr=False,
                   **kw),
            BatchNorm2D(out_planes, **kw), ReLU6())


class InvertedResidual(Layer):
    def __init__(self, inp, oup, stride, expand_ratio, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.stride = stride
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res_connect = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden_dim, kernel_size=1, **kw))
        layers.extend([
            ConvBNReLU(hidden_dim, hidden_dim, stride=stride,
                       groups=hidden_dim, **kw),
            Conv2D(hidden_dim, oup, 1, 1, 0, bias_attr=False, **kw),
            BatchNorm2D(oup, **kw)])
        self.conv = Sequential(*layers)

    def forward(self, x):
        if self.use_res_connect:
            return x + self.conv(x)
        return self.conv(x)


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, dtype=None, seed=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        kw = model_kw(device, dtype)
        setting = [[1, 16, 1, 1], [6, 24, 2, 2], [6, 32, 3, 2],
                   [6, 64, 4, 2], [6, 96, 3, 1], [6, 160, 3, 2],
                   [6, 320, 1, 1]]  # t, c, n, s
        input_channel = make_divisible(32 * scale)
        self.last_channel = make_divisible(1280 * max(1.0, scale))
        with seeded(seed):
            features = [ConvBNReLU(3, input_channel, stride=2, **kw)]
            for t, c, n, s in setting:
                output_channel = make_divisible(c * scale)
                for i in range(n):
                    features.append(InvertedResidual(
                        input_channel, output_channel, s if i == 0 else 1,
                        t, **kw))
                    input_channel = output_channel
            features.append(ConvBNReLU(input_channel, self.last_channel,
                                       kernel_size=1, **kw))
            self.features = Sequential(*features)
            if with_pool:
                self.pool2d_avg = AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.classifier = Sequential(
                    Dropout(0.2), Linear(self.last_channel, num_classes,
                                         **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
