"""The port's vision model zoo (port of ``paddle_tpu/vision/models``):
LeNet, MobileNet v1 / v2, ResNet and VGG, under the JAX package's
names."""

from .lenet import LeNet  # noqa: F401
from .mobilenet import (MobileNetV1, MobileNetV2,  # noqa: F401
                        mobilenet_v1, mobilenet_v2)
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     wide_resnet50_2)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
