"""Inception-v3, the counterpart of ``paddle_tpu/vision/models/inceptionv3.py``
(299 px inputs): the stem, InceptionA-E and a Dropout(0.5) head."""

from __future__ import annotations

from ...nn import (
    AdaptiveAvgPool2D, AvgPool2D, Dropout, Linear, MaxPool2D, Sequential,
)
from ...nn.layers import Layer
from ...tensor import concat, flatten
from ._ops import ConvBNReLU, model_kw, no_pretrained, seeded


class InceptionA(Layer):
    def __init__(self, in_ch, pool_features, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.b1x1 = ConvBNReLU(in_ch, 64, 1, **kw)
        self.b5x5 = Sequential(ConvBNReLU(in_ch, 48, 1, **kw),
                               ConvBNReLU(48, 64, 5, padding=2, **kw))
        self.b3x3dbl = Sequential(ConvBNReLU(in_ch, 64, 1, **kw),
                                  ConvBNReLU(64, 96, 3, padding=1, **kw),
                                  ConvBNReLU(96, 96, 3, padding=1, **kw))
        self.bpool = Sequential(AvgPool2D(kernel_size=3, stride=1, padding=1),
                                ConvBNReLU(in_ch, pool_features, 1, **kw))

    def forward(self, x):
        return concat([self.b1x1(x), self.b5x5(x), self.b3x3dbl(x),
                       self.bpool(x)], axis=1)


class InceptionB(Layer):
    def __init__(self, in_ch, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.b3x3 = ConvBNReLU(in_ch, 384, 3, stride=2, **kw)
        self.b3x3dbl = Sequential(ConvBNReLU(in_ch, 64, 1, **kw),
                                  ConvBNReLU(64, 96, 3, padding=1, **kw),
                                  ConvBNReLU(96, 96, 3, stride=2, **kw))
        self.pool = MaxPool2D(kernel_size=3, stride=2)

    def forward(self, x):
        return concat([self.b3x3(x), self.b3x3dbl(x), self.pool(x)], axis=1)


class InceptionC(Layer):
    def __init__(self, in_ch, ch7, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.b1x1 = ConvBNReLU(in_ch, 192, 1, **kw)
        self.b7x7 = Sequential(
            ConvBNReLU(in_ch, ch7, 1, **kw),
            ConvBNReLU(ch7, ch7, (1, 7), padding=(0, 3), **kw),
            ConvBNReLU(ch7, 192, (7, 1), padding=(3, 0), **kw))
        self.b7x7dbl = Sequential(
            ConvBNReLU(in_ch, ch7, 1, **kw),
            ConvBNReLU(ch7, ch7, (7, 1), padding=(3, 0), **kw),
            ConvBNReLU(ch7, ch7, (1, 7), padding=(0, 3), **kw),
            ConvBNReLU(ch7, ch7, (7, 1), padding=(3, 0), **kw),
            ConvBNReLU(ch7, 192, (1, 7), padding=(0, 3), **kw))
        self.bpool = Sequential(AvgPool2D(kernel_size=3, stride=1, padding=1),
                                ConvBNReLU(in_ch, 192, 1, **kw))

    def forward(self, x):
        return concat([self.b1x1(x), self.b7x7(x), self.b7x7dbl(x),
                       self.bpool(x)], axis=1)


class InceptionD(Layer):
    def __init__(self, in_ch, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.b3x3 = Sequential(ConvBNReLU(in_ch, 192, 1, **kw),
                               ConvBNReLU(192, 320, 3, stride=2, **kw))
        self.b7x7x3 = Sequential(
            ConvBNReLU(in_ch, 192, 1, **kw),
            ConvBNReLU(192, 192, (1, 7), padding=(0, 3), **kw),
            ConvBNReLU(192, 192, (7, 1), padding=(3, 0), **kw),
            ConvBNReLU(192, 192, 3, stride=2, **kw))
        self.pool = MaxPool2D(kernel_size=3, stride=2)

    def forward(self, x):
        return concat([self.b3x3(x), self.b7x7x3(x), self.pool(x)], axis=1)


class InceptionE(Layer):
    def __init__(self, in_ch, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.b1x1 = ConvBNReLU(in_ch, 320, 1, **kw)
        self.b3x3_1 = ConvBNReLU(in_ch, 384, 1, **kw)
        self.b3x3_2a = ConvBNReLU(384, 384, (1, 3), padding=(0, 1), **kw)
        self.b3x3_2b = ConvBNReLU(384, 384, (3, 1), padding=(1, 0), **kw)
        self.b3x3dbl_1 = Sequential(ConvBNReLU(in_ch, 448, 1, **kw),
                                    ConvBNReLU(448, 384, 3, padding=1, **kw))
        self.b3x3dbl_2a = ConvBNReLU(384, 384, (1, 3), padding=(0, 1), **kw)
        self.b3x3dbl_2b = ConvBNReLU(384, 384, (3, 1), padding=(1, 0), **kw)
        self.bpool = Sequential(AvgPool2D(kernel_size=3, stride=1, padding=1),
                                ConvBNReLU(in_ch, 192, 1, **kw))

    def forward(self, x):
        b3 = self.b3x3_1(x)
        b3 = concat([self.b3x3_2a(b3), self.b3x3_2b(b3)], axis=1)
        bd = self.b3x3dbl_1(x)
        bd = concat([self.b3x3dbl_2a(bd), self.b3x3dbl_2b(bd)], axis=1)
        return concat([self.b1x1(x), b3, bd, self.bpool(x)], axis=1)


class InceptionV3(Layer):
    def __init__(self, num_classes=1000, with_pool=True, device=None,
                 dtype=None, seed=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        kw = model_kw(device, dtype)
        with seeded(seed):
            self.stem = Sequential(
                ConvBNReLU(3, 32, 3, stride=2, **kw),
                ConvBNReLU(32, 32, 3, **kw),
                ConvBNReLU(32, 64, 3, padding=1, **kw),
                MaxPool2D(kernel_size=3, stride=2),
                ConvBNReLU(64, 80, 1, **kw), ConvBNReLU(80, 192, 3, **kw),
                MaxPool2D(kernel_size=3, stride=2))
            self.blocks = Sequential(
                InceptionA(192, 32, **kw), InceptionA(256, 64, **kw),
                InceptionA(288, 64, **kw), InceptionB(288, **kw),
                InceptionC(768, 128, **kw), InceptionC(768, 160, **kw),
                InceptionC(768, 160, **kw), InceptionC(768, 192, **kw),
                InceptionD(768, **kw), InceptionE(1280, **kw),
                InceptionE(2048, **kw))
            if with_pool:
                self.avgpool = AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.dropout = Dropout(0.5)
                self.fc = Linear(2048, num_classes, **kw)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(flatten(x, 1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return InceptionV3(**kwargs)
