"""Data layer: class metadata, embedding assets, image transforms, the
datasets and the batched loader."""

from zeroshotsemanticsegmentation_tpu_torch.data.assets import (
    class_names, load_class_embeddings, load_split_ids)
from zeroshotsemanticsegmentation_tpu_torch.data.context import PascalContext
from zeroshotsemanticsegmentation_tpu_torch.data.pascal import PascalVOC
from zeroshotsemanticsegmentation_tpu_torch.data.pipeline import (
    BatchLoader, SyntheticDataset)
from zeroshotsemanticsegmentation_tpu_torch.data.transforms import (
    MEAN_BGR, pad_to_bucket, transform_image, untransform_image)

__all__ = [
    "load_class_embeddings", "load_split_ids", "class_names",
    "MEAN_BGR", "transform_image", "untransform_image", "pad_to_bucket",
    "PascalVOC", "PascalContext", "BatchLoader", "SyntheticDataset",
]
