"""MobileNetV3 Small and Large, the counterpart of
``paddle_tpu/vision/models/mobilenetv3.py``: bneck blocks (expansion,
depthwise, optional squeeze-excite with hardsigmoid, projection) with
ReLU or hardswish, a Linear-hardswish-Dropout(0.2)-Linear head."""

from __future__ import annotations

from ...nn import (
    AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Hardsigmoid, Hardswish,
    Linear, ReLU, Sequential,
)
from ...nn.layers import Layer
from ...tensor import flatten
from ._ops import make_divisible, model_kw, no_pretrained, seeded


class _ConvBNAct(Layer):
    def __init__(self, in_ch, out_ch, kernel, stride=1, groups=1, act=None,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv = Conv2D(in_ch, out_ch, kernel, stride=stride,
                           padding=kernel // 2, groups=groups,
                           bias_attr=False, **kw)
        self.bn = BatchNorm2D(out_ch, **kw)
        self.act = act() if act else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class SqueezeExcite(Layer):
    def __init__(self, ch, reduction=4, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        squeeze = make_divisible(ch // reduction)
        self.avgpool = AdaptiveAvgPool2D((1, 1))
        self.fc1 = Conv2D(ch, squeeze, 1, **kw)
        self.relu = ReLU()
        self.fc2 = Conv2D(squeeze, ch, 1, **kw)
        self.hsig = Hardsigmoid()

    def forward(self, x):
        s = self.avgpool(x)
        return x * self.hsig(self.fc2(self.relu(self.fc1(s))))


class _Bneck(Layer):
    def __init__(self, in_ch, exp, out_ch, kernel, stride, use_se, act,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.use_res = stride == 1 and in_ch == out_ch
        layers = []
        if exp != in_ch:
            layers.append(_ConvBNAct(in_ch, exp, 1, act=act, **kw))
        layers.append(_ConvBNAct(exp, exp, kernel, stride=stride, groups=exp,
                                 act=act, **kw))
        if use_se:
            layers.append(SqueezeExcite(exp, **kw))
        layers.append(_ConvBNAct(exp, out_ch, 1, act=None, **kw))
        self.block = Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


# (kernel, exp, out, SE, act, stride)
_LARGE = [
    (3, 16, 16, False, ReLU, 1), (3, 64, 24, False, ReLU, 2),
    (3, 72, 24, False, ReLU, 1), (5, 72, 40, True, ReLU, 2),
    (5, 120, 40, True, ReLU, 1), (5, 120, 40, True, ReLU, 1),
    (3, 240, 80, False, Hardswish, 2), (3, 200, 80, False, Hardswish, 1),
    (3, 184, 80, False, Hardswish, 1), (3, 184, 80, False, Hardswish, 1),
    (3, 480, 112, True, Hardswish, 1), (3, 672, 112, True, Hardswish, 1),
    (5, 672, 160, True, Hardswish, 2), (5, 960, 160, True, Hardswish, 1),
    (5, 960, 160, True, Hardswish, 1),
]
_SMALL = [
    (3, 16, 16, True, ReLU, 2), (3, 72, 24, False, ReLU, 2),
    (3, 88, 24, False, ReLU, 1), (5, 96, 40, True, Hardswish, 2),
    (5, 240, 40, True, Hardswish, 1), (5, 240, 40, True, Hardswish, 1),
    (5, 120, 48, True, Hardswish, 1), (5, 144, 48, True, Hardswish, 1),
    (5, 288, 96, True, Hardswish, 2), (5, 576, 96, True, Hardswish, 1),
    (5, 576, 96, True, Hardswish, 1),
]


class MobileNetV3(Layer):
    def __init__(self, cfg, last_channel, scale=1.0, num_classes=1000,
                 with_pool=True, device=None, dtype=None, seed=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        kw = model_kw(device, dtype)

        def c(ch):
            return make_divisible(ch * scale)

        with seeded(seed):
            layers = [_ConvBNAct(3, c(16), 3, stride=2, act=Hardswish, **kw)]
            in_ch = c(16)
            for kernel, exp, out, se, act, stride in cfg:
                layers.append(_Bneck(in_ch, c(exp), c(out), kernel, stride,
                                     se, act, **kw))
                in_ch = c(out)
            last_conv = c(cfg[-1][1])
            layers.append(_ConvBNAct(in_ch, last_conv, 1, act=Hardswish,
                                     **kw))
            self.features = Sequential(*layers)
            if with_pool:
                self.avgpool = AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.classifier = Sequential(
                    Linear(last_conv, last_channel, **kw), Hardswish(),
                    Dropout(0.2), Linear(last_channel, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_LARGE, 1280, scale, num_classes, with_pool, **kw)


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_SMALL, 1024, scale, num_classes, with_pool, **kw)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)
