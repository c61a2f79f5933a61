"""Models: FCN-32s and FCN-8s, their support-pruned blocks, the int8
serving forward, the JAX weight bridge, the reference checkpoint format
(import, export) and VGG16 import."""

from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
from zeroshotsemanticsegmentation_tpu_torch.models.fcn8s import FCN8s

__all__ = ["FCN32s", "FCN8s"]
