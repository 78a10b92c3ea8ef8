"""SqueezeNet 1.0 and 1.1, the counterpart of
``paddle_tpu/vision/models/squeezenet.py``."""

from __future__ import annotations

from ...nn import (
    AdaptiveAvgPool2D, Conv2D, Dropout, MaxPool2D, ReLU, Sequential,
)
from ...nn.layers import Layer
from ...tensor import concat, flatten
from ._ops import model_kw, no_pretrained, seeded


class Fire(Layer):
    def __init__(self, inplanes, squeeze_planes, expand1x1_planes,
                 expand3x3_planes, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.squeeze = Conv2D(inplanes, squeeze_planes, 1, **kw)
        self.relu = ReLU()
        self.expand1x1 = Conv2D(squeeze_planes, expand1x1_planes, 1, **kw)
        self.expand3x3 = Conv2D(squeeze_planes, expand3x3_planes, 3,
                                padding=1, **kw)

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return concat([self.relu(self.expand1x1(x)),
                       self.relu(self.expand3x3(x))], axis=1)


class SqueezeNet(Layer):
    def __init__(self, version="1.1", num_classes=1000, with_pool=True,
                 device=None, dtype=None, seed=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        kw = model_kw(device, dtype)
        if version not in ("1.0", "1.1"):
            raise ValueError(f"unsupported SqueezeNet version {version}")
        with seeded(seed):
            if version == "1.0":
                self.features = Sequential(
                    Conv2D(3, 96, 7, stride=2, **kw), ReLU(),
                    MaxPool2D(kernel_size=3, stride=2),
                    Fire(96, 16, 64, 64, **kw), Fire(128, 16, 64, 64, **kw),
                    Fire(128, 32, 128, 128, **kw),
                    MaxPool2D(kernel_size=3, stride=2),
                    Fire(256, 32, 128, 128, **kw),
                    Fire(256, 48, 192, 192, **kw),
                    Fire(384, 48, 192, 192, **kw),
                    Fire(384, 64, 256, 256, **kw),
                    MaxPool2D(kernel_size=3, stride=2),
                    Fire(512, 64, 256, 256, **kw))
            else:
                self.features = Sequential(
                    Conv2D(3, 64, 3, stride=2, **kw), ReLU(),
                    MaxPool2D(kernel_size=3, stride=2),
                    Fire(64, 16, 64, 64, **kw), Fire(128, 16, 64, 64, **kw),
                    MaxPool2D(kernel_size=3, stride=2),
                    Fire(128, 32, 128, 128, **kw),
                    Fire(256, 32, 128, 128, **kw),
                    MaxPool2D(kernel_size=3, stride=2),
                    Fire(256, 48, 192, 192, **kw),
                    Fire(384, 48, 192, 192, **kw),
                    Fire(384, 64, 256, 256, **kw),
                    Fire(512, 64, 256, 256, **kw))
            if num_classes > 0:
                self.classifier = Sequential(
                    Dropout(0.5), Conv2D(512, num_classes, 1, **kw), ReLU())
            if with_pool:
                self.avgpool = AdaptiveAvgPool2D((1, 1))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.avgpool(x)
        return flatten(x, 1)


def _squeezenet(version, pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet(version, **kwargs)


def squeezenet1_0(pretrained=False, **kwargs):
    return _squeezenet("1.0", pretrained, **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    return _squeezenet("1.1", pretrained, **kwargs)
