"""AlexNet, the counterpart of ``paddle_tpu/vision/models/alexnet.py``."""

from __future__ import annotations

from ...nn import (
    AdaptiveAvgPool2D, Conv2D, Dropout, Linear, MaxPool2D, ReLU, Sequential,
)
from ...nn.layers import Layer
from ...tensor import flatten
from ._ops import model_kw, no_pretrained, seeded


class AlexNet(Layer):
    def __init__(self, num_classes=1000, device=None, dtype=None,
                 seed=None):
        super().__init__()
        self.num_classes = num_classes
        kw = model_kw(device, dtype)
        with seeded(seed):
            self.features = Sequential(
                Conv2D(3, 64, 11, stride=4, padding=2, **kw), ReLU(),
                MaxPool2D(3, 2),
                Conv2D(64, 192, 5, padding=2, **kw), ReLU(), MaxPool2D(3, 2),
                Conv2D(192, 384, 3, padding=1, **kw), ReLU(),
                Conv2D(384, 256, 3, padding=1, **kw), ReLU(),
                Conv2D(256, 256, 3, padding=1, **kw), ReLU(),
                MaxPool2D(3, 2))
            self.avgpool = AdaptiveAvgPool2D((6, 6))
            if num_classes > 0:
                self.classifier = Sequential(
                    Dropout(), Linear(256 * 6 * 6, 4096, **kw), ReLU(),
                    Dropout(), Linear(4096, 4096, **kw), ReLU(),
                    Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def alexnet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return AlexNet(**kwargs)
