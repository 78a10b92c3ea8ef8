"""GoogLeNet (Inception-v1), the counterpart of
``paddle_tpu/vision/models/googlenet.py``.  In training mode (with a
head) the forward returns ``(out, aux1, aux2)``, the two
``InceptionAux`` heads' logits after ``ince4a`` and ``ince4d``; in eval
mode the logits alone (``googlenet.py:81-97``)."""

from __future__ import annotations

from ...nn import (
    AdaptiveAvgPool2D, AvgPool2D, Dropout, Linear, MaxPool2D, ReLU,
    Sequential,
)
from ...nn.layers import Layer
from ...tensor import concat, flatten
from ._ops import ConvBNReLU, model_kw, no_pretrained, seeded


class Inception(Layer):
    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, proj, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.branch1 = ConvBNReLU(in_ch, c1, 1, **kw)
        self.branch2 = Sequential(ConvBNReLU(in_ch, c3r, 1, **kw),
                                  ConvBNReLU(c3r, c3, 3, padding=1, **kw))
        self.branch3 = Sequential(ConvBNReLU(in_ch, c5r, 1, **kw),
                                  ConvBNReLU(c5r, c5, 5, padding=2, **kw))
        self.branch4 = Sequential(
            MaxPool2D(kernel_size=3, stride=1, padding=1),
            ConvBNReLU(in_ch, proj, 1, **kw))

    def forward(self, x):
        return concat([self.branch1(x), self.branch2(x), self.branch3(x),
                       self.branch4(x)], axis=1)


class InceptionAux(Layer):
    def __init__(self, in_ch, num_classes, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.avgpool = AvgPool2D(kernel_size=5, stride=3)
        self.conv = ConvBNReLU(in_ch, 128, 1, **kw)
        self.fc1 = Linear(2048, 1024, **kw)
        self.relu = ReLU()
        self.dropout = Dropout(0.7)
        self.fc2 = Linear(1024, num_classes, **kw)

    def forward(self, x):
        x = flatten(self.conv(self.avgpool(x)), 1)
        return self.fc2(self.dropout(self.relu(self.fc1(x))))


class GoogLeNet(Layer):
    def __init__(self, num_classes=1000, with_pool=True, device=None,
                 dtype=None, seed=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        kw = model_kw(device, dtype)
        with seeded(seed):
            self.conv1 = ConvBNReLU(3, 64, 7, stride=2, padding=3, **kw)
            self.pool1 = MaxPool2D(kernel_size=3, stride=2, padding=1)
            self.conv2 = ConvBNReLU(64, 64, 1, **kw)
            self.conv3 = ConvBNReLU(64, 192, 3, padding=1, **kw)
            self.pool2 = MaxPool2D(kernel_size=3, stride=2, padding=1)
            self.ince3a = Inception(192, 64, 96, 128, 16, 32, 32, **kw)
            self.ince3b = Inception(256, 128, 128, 192, 32, 96, 64, **kw)
            self.pool3 = MaxPool2D(kernel_size=3, stride=2, padding=1)
            self.ince4a = Inception(480, 192, 96, 208, 16, 48, 64, **kw)
            self.ince4b = Inception(512, 160, 112, 224, 24, 64, 64, **kw)
            self.ince4c = Inception(512, 128, 128, 256, 24, 64, 64, **kw)
            self.ince4d = Inception(512, 112, 144, 288, 32, 64, 64, **kw)
            self.ince4e = Inception(528, 256, 160, 320, 32, 128, 128, **kw)
            self.pool4 = MaxPool2D(kernel_size=3, stride=2, padding=1)
            self.ince5a = Inception(832, 256, 160, 320, 32, 128, 128, **kw)
            self.ince5b = Inception(832, 384, 192, 384, 48, 128, 128, **kw)
            if num_classes > 0:
                self.aux1 = InceptionAux(512, num_classes, **kw)
                self.aux2 = InceptionAux(528, num_classes, **kw)
                self.dropout = Dropout(0.4)
                self.fc = Linear(1024, num_classes, **kw)
            if with_pool:
                self.avgpool = AdaptiveAvgPool2D((1, 1))

    def forward(self, x):
        heads = self.training and self.num_classes > 0
        x = self.pool1(self.conv1(x))
        x = self.pool2(self.conv3(self.conv2(x)))
        x = self.pool3(self.ince3b(self.ince3a(x)))
        x = self.ince4a(x)
        aux1 = self.aux1(x) if heads else None
        x = self.ince4d(self.ince4c(self.ince4b(x)))
        aux2 = self.aux2(x) if heads else None
        x = self.pool4(self.ince4e(x))
        x = self.ince5b(self.ince5a(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(flatten(x, 1)))
        return (x, aux1, aux2) if heads else x


def googlenet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return GoogLeNet(**kwargs)
