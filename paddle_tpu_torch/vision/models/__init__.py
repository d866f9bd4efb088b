"""The port's vision model zoo; ResNet only so far (the other models of
``paddle_tpu/vision/models`` are not yet ported, see ROADMAP.md)."""

from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     wide_resnet50_2)
