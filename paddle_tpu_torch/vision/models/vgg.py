"""VGG, the counterpart of ``paddle_tpu/vision/models/vgg.py``: the four
configurations, with or without BatchNorm after each convolution."""

from __future__ import annotations

from ...nn import (
    AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Linear, MaxPool2D,
    ReLU, Sequential,
)
from ...nn.layers import Layer
from ...tensor import flatten
from ._ops import model_kw, no_pretrained, seeded

cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
          "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
          512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False, device=None, dtype=None):
    kw = dict(device=device, dtype=dtype)
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
        else:
            layers.append(Conv2D(in_channels, v, 3, padding=1, **kw))
            if batch_norm:
                layers.append(BatchNorm2D(v, **kw))
            layers.append(ReLU())
            in_channels = v
    return Sequential(*layers)


class VGG(Layer):
    """``features`` from :func:`make_layers` (built on the model's device),
    an optional 7 x 7 adaptive pool and the three-Linear head."""

    def __init__(self, features, num_classes=1000, with_pool=True,
                 device=None, dtype=None, seed=None):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        kw = model_kw(device, dtype)
        with seeded(seed):
            if with_pool:
                self.avgpool = AdaptiveAvgPool2D((7, 7))
            if num_classes > 0:
                self.classifier = Sequential(
                    Linear(512 * 7 * 7, 4096, **kw), ReLU(), Dropout(),
                    Linear(4096, 4096, **kw), ReLU(), Dropout(),
                    Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def _vgg(cfg, batch_norm=False, pretrained=False, device=None, dtype=None,
         seed=None, **kwargs):
    no_pretrained(pretrained)
    kw = model_kw(device, dtype)
    with seeded(seed):
        features = make_layers(cfgs[cfg], batch_norm, **kw)
        return VGG(features, **kwargs, **kw)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
