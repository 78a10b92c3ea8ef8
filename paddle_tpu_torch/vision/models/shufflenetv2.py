"""ShuffleNetV2, the counterpart of
``paddle_tpu/vision/models/shufflenetv2.py``: the six widths, stride-2
blocks with two branches and stride-1 blocks that split the channels,
each followed by a two-group channel shuffle.  ``act`` is ``"relu"``
(JAX's only one) or ``"swish"`` (upstream Paddle's other, which JAX
refuses; ROADMAP.md Queue 3)."""

from __future__ import annotations

from ...nn import (
    AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear, MaxPool2D, ReLU,
    Sequential, Swish,
)
from ...nn import functional as F
from ...nn.layers import Layer
from ...tensor import concat, flatten
from ._ops import model_kw, no_pretrained, seeded

_ACTS = {"relu": ReLU, "swish": Swish}


def channel_shuffle(x, groups):
    return F.channel_shuffle(x, groups)


class InvertedResidual(Layer):
    def __init__(self, in_ch, out_ch, stride, act="relu", device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        act = _ACTS[act]
        self.stride = stride
        branch_ch = out_ch // 2
        if stride != 1:
            self.branch1 = Sequential(
                Conv2D(in_ch, in_ch, 3, stride=stride, padding=1,
                       groups=in_ch, bias_attr=False, **kw),
                BatchNorm2D(in_ch, **kw),
                Conv2D(in_ch, branch_ch, 1, bias_attr=False, **kw),
                BatchNorm2D(branch_ch, **kw), act())
        first = branch_ch if stride == 1 else in_ch
        self.branch2 = Sequential(
            Conv2D(first, branch_ch, 1, bias_attr=False, **kw),
            BatchNorm2D(branch_ch, **kw), act(),
            Conv2D(branch_ch, branch_ch, 3, stride=stride, padding=1,
                   groups=branch_ch, bias_attr=False, **kw),
            BatchNorm2D(branch_ch, **kw),
            Conv2D(branch_ch, branch_ch, 1, bias_attr=False, **kw),
            BatchNorm2D(branch_ch, **kw), act())

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            out = concat([x[:, :c], self.branch2(x[:, c:])], axis=1)
        else:
            out = concat([self.branch1(x), self.branch2(x)], axis=1)
        return channel_shuffle(out, 2)


_STAGE_OUT = {
    "0.25x": (24, 48, 96, 192, 1024),
    "0.33x": (24, 32, 64, 128, 1024),
    "0.5x": (24, 48, 96, 192, 1024),
    "1.0x": (24, 116, 232, 464, 1024),
    "1.5x": (24, 176, 352, 704, 1024),
    "2.0x": (24, 244, 488, 976, 2048),
}
_STAGE_REPEATS = (4, 8, 4)


class ShuffleNetV2(Layer):
    def __init__(self, scale="1.0x", act="relu", num_classes=1000,
                 with_pool=True, device=None, dtype=None, seed=None):
        super().__init__()
        if act not in _ACTS:
            raise NotImplementedError(f"ShuffleNetV2 act={act!r} not "
                                      "supported (relu or swish)")
        self.num_classes = num_classes
        self.with_pool = with_pool
        chs = _STAGE_OUT[scale]
        kw = model_kw(device, dtype)
        with seeded(seed):
            self.conv1 = Sequential(
                Conv2D(3, chs[0], 3, stride=2, padding=1, bias_attr=False,
                       **kw),
                BatchNorm2D(chs[0], **kw), _ACTS[act]())
            self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
            stages = []
            in_ch = chs[0]
            for i, repeats in enumerate(_STAGE_REPEATS):
                out_ch = chs[i + 1]
                blocks = [InvertedResidual(in_ch, out_ch, 2, act, **kw)]
                blocks += [InvertedResidual(out_ch, out_ch, 1, act, **kw)
                           for _ in range(repeats - 1)]
                stages.append(Sequential(*blocks))
                in_ch = out_ch
            self.stages = Sequential(*stages)
            self.conv5 = Sequential(
                Conv2D(in_ch, chs[-1], 1, bias_attr=False, **kw),
                BatchNorm2D(chs[-1], **kw), _ACTS[act]())
            if with_pool:
                self.avgpool = AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.fc = Linear(chs[-1], num_classes, **kw)

    def forward(self, x):
        x = self.conv5(self.stages(self.maxpool(self.conv1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def _shufflenet(scale, pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return ShuffleNetV2(scale=scale, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _shufflenet("0.25x", pretrained, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _shufflenet("0.33x", pretrained, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _shufflenet("0.5x", pretrained, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _shufflenet("1.0x", pretrained, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _shufflenet("1.5x", pretrained, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _shufflenet("2.0x", pretrained, **kwargs)
