"""LeNet, the counterpart of ``paddle_tpu/vision/models/lenet.py``: 1 x 28 x
28 inputs, two convolution stages and a three-Linear head."""

from __future__ import annotations

from ...nn import Conv2D, Flatten, Linear, MaxPool2D, ReLU, Sequential
from ...nn.layers import Layer
from ._ops import model_kw, seeded


class LeNet(Layer):
    def __init__(self, num_classes=10, device=None, dtype=None, seed=None):
        super().__init__()
        self.num_classes = num_classes
        kw = model_kw(device, dtype)
        with seeded(seed):
            self.features = Sequential(
                Conv2D(1, 6, 3, stride=1, padding=1, **kw), ReLU(),
                MaxPool2D(2, 2),
                Conv2D(6, 16, 5, stride=1, padding=0, **kw), ReLU(),
                MaxPool2D(2, 2))
            if num_classes > 0:
                self.fc = Sequential(Flatten(), Linear(400, 120, **kw),
                                     Linear(120, 84, **kw),
                                     Linear(84, num_classes, **kw))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(x)
        return x
