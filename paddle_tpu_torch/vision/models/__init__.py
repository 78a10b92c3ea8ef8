"""The vision model zoo, the counterparts of ``paddle_tpu/vision/models/``:
every constructor JAX exports, with the JAX models' layer names so
``load_state_dict`` (or ``convert.state_from_jax``) maps one
``state_dict`` onto the other key for key.  Each model is built on ``device`` (``cuda`` unless the
caller passes ``"cpu"``) in ``dtype``, its initial values drawn from the
port's counter stream (with ``seed``, from a private stream seeded by
it) by JAX's initialisers: convolutions U(-1/sqrt(fan_in),
1/sqrt(fan_in)), Linear weights Xavier-normal and biases 0, BatchNorm
weight 1 and bias 0.  ``pretrained=True`` raises.  Convolutions run on
cuDNN through ``nn.functional``; the rest is plain torch: the JAX
package computes all of it outside any Pallas kernel."""

from .alexnet import AlexNet, alexnet
from .densenet import (
    DenseNet, densenet121, densenet161, densenet169, densenet201,
    densenet264,
)
from .googlenet import GoogLeNet, googlenet
from .inceptionv3 import InceptionV3, inception_v3
from .lenet import LeNet
from .mobilenetv1 import MobileNetV1, mobilenet_v1
from .mobilenetv2 import MobileNetV2, mobilenet_v2
from .mobilenetv3 import (
    MobileNetV3Large, MobileNetV3Small, mobilenet_v3_large,
    mobilenet_v3_small,
)
from .resnet import (
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152, resnext50_32x4d, resnext101_64x4d,
    wide_resnet50_2, wide_resnet101_2,
)
from .shufflenetv2 import (
    ShuffleNetV2, shufflenet_v2_x0_25, shufflenet_v2_x0_33,
    shufflenet_v2_x0_5, shufflenet_v2_x1_0, shufflenet_v2_x1_5,
    shufflenet_v2_x2_0,
)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19

__all__ = [
    "AlexNet", "BasicBlock", "BottleneckBlock", "DenseNet", "GoogLeNet",
    "InceptionV3", "LeNet", "MobileNetV1", "MobileNetV2", "MobileNetV3Large",
    "MobileNetV3Small", "ResNet", "ShuffleNetV2", "SqueezeNet", "VGG",
    "alexnet", "densenet121", "densenet161", "densenet169", "densenet201",
    "densenet264", "googlenet", "inception_v3", "mobilenet_v1",
    "mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small", "resnet18",
    "resnet34", "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
    "resnext101_64x4d", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0", "squeezenet1_0", "squeezenet1_1", "vgg11",
    "vgg13", "vgg16", "vgg19", "wide_resnet50_2", "wide_resnet101_2",
]
