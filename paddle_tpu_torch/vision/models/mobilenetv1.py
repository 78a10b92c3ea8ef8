"""MobileNetV1, the counterpart of ``paddle_tpu/vision/models/mobilenetv1.py``:
13 depthwise-separable blocks, channels ``max(int(c scale), 8)``."""

from __future__ import annotations

from ...nn import AdaptiveAvgPool2D, Linear, Sequential
from ...nn.layers import Layer
from ...tensor import flatten
from ._ops import ConvBNReLU, model_kw, no_pretrained, seeded


class _DepthwiseSeparable(Layer):
    def __init__(self, in_ch, out_ch, stride, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.depthwise = ConvBNReLU(in_ch, in_ch, 3, stride=stride,
                                    padding=1, groups=in_ch, **kw)
        self.pointwise = ConvBNReLU(in_ch, out_ch, 1, **kw)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class MobileNetV1(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, dtype=None, seed=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        kw = model_kw(device, dtype)

        def c(ch):
            return max(int(ch * scale), 8)

        cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
               (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
               (1024, 1)]  # (out, stride)
        with seeded(seed):
            layers = [ConvBNReLU(3, c(32), 3, stride=2, padding=1, **kw)]
            in_ch = c(32)
            for out, stride in cfg:
                layers.append(_DepthwiseSeparable(in_ch, c(out), stride,
                                                  **kw))
                in_ch = c(out)
            self.features = Sequential(*layers)
            if with_pool:
                self.avgpool = AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.fc = Linear(c(1024), num_classes, **kw)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)
