"""DenseNet, the counterpart of ``paddle_tpu/vision/models/densenet.py``:
121, 161, 169, 201 and 264 layers, BN-ReLU-conv dense layers with
``dropout`` after each, transitions that halve the channels."""

from __future__ import annotations

from ...nn import (
    AdaptiveAvgPool2D, AvgPool2D, BatchNorm2D, Conv2D, Dropout, Linear,
    MaxPool2D, ReLU, Sequential,
)
from ...nn.layers import Layer
from ...tensor import concat, flatten
from ._ops import model_kw, no_pretrained, seeded


class _DenseLayer(Layer):
    def __init__(self, num_input_features, growth_rate, bn_size, drop_rate,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = BatchNorm2D(num_input_features, **kw)
        self.relu = ReLU()
        self.conv1 = Conv2D(num_input_features, bn_size * growth_rate, 1,
                            bias_attr=False, **kw)
        self.norm2 = BatchNorm2D(bn_size * growth_rate, **kw)
        self.conv2 = Conv2D(bn_size * growth_rate, growth_rate, 3, padding=1,
                            bias_attr=False, **kw)
        self.dropout = Dropout(drop_rate)

    def forward(self, x):
        out = self.conv1(self.relu(self.norm1(x)))
        out = self.dropout(self.conv2(self.relu(self.norm2(out))))
        return concat([x, out], axis=1)


class _DenseBlock(Layer):
    def __init__(self, num_layers, num_input_features, bn_size, growth_rate,
                 drop_rate, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.block = Sequential(*[
            _DenseLayer(num_input_features + i * growth_rate, growth_rate,
                        bn_size, drop_rate, **kw) for i in range(num_layers)])

    def forward(self, x):
        return self.block(x)


class _Transition(Layer):
    def __init__(self, num_input_features, num_output_features, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = BatchNorm2D(num_input_features, **kw)
        self.relu = ReLU()
        self.conv = Conv2D(num_input_features, num_output_features, 1,
                           bias_attr=False, **kw)
        self.pool = AvgPool2D(kernel_size=2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.norm(x))))


_CFG = {121: (32, (6, 12, 24, 16)), 161: (48, (6, 12, 36, 24)),
        169: (32, (6, 12, 32, 32)), 201: (32, (6, 12, 48, 32)),
        264: (32, (6, 12, 64, 48))}


class DenseNet(Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True, device=None, dtype=None, seed=None):
        super().__init__()
        growth_rate, block_config = _CFG[layers]
        num_init_features = 2 * growth_rate
        self.num_classes = num_classes
        self.with_pool = with_pool
        kw = model_kw(device, dtype)
        with seeded(seed):
            self.conv0 = Conv2D(3, num_init_features, 7, stride=2, padding=3,
                                bias_attr=False, **kw)
            self.norm0 = BatchNorm2D(num_init_features, **kw)
            self.relu = ReLU()
            self.pool0 = MaxPool2D(kernel_size=3, stride=2, padding=1)
            blocks = []
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                blocks.append(_DenseBlock(num_layers, num_features, bn_size,
                                          growth_rate, dropout, **kw))
                num_features += num_layers * growth_rate
                if i != len(block_config) - 1:
                    blocks.append(_Transition(num_features,
                                              num_features // 2, **kw))
                    num_features //= 2
            self.features = Sequential(*blocks)
            self.norm5 = BatchNorm2D(num_features, **kw)
            if with_pool:
                self.avgpool = AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.classifier = Linear(num_features, num_classes, **kw)

    def forward(self, x):
        x = self.pool0(self.relu(self.norm0(self.conv0(x))))
        x = self.relu(self.norm5(self.features(x)))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def _densenet(layers, pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _densenet(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _densenet(264, pretrained, **kwargs)
