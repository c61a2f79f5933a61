"""Models: FCN-32s and FCN-8s, their support-pruned blocks, the int8
serving forward, the JAX weight bridge, the reference checkpoint format
(import, export) and VGG16 import; DeepLab-v2 ResNet-101 with the SZN
heads (serving)."""

from zeroshotsemanticsegmentation_tpu_torch.models.deeplab import (
    DeepLabV2ResNet101)
from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
from zeroshotsemanticsegmentation_tpu_torch.models.fcn8s import FCN8s

__all__ = ["DeepLabV2ResNet101", "FCN32s", "FCN8s"]
