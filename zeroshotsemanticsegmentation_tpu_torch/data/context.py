"""PASCAL-Context dataset, 33 classes (reference parity) or 59 (extension);
the JAX package's data/context.py.

Reference parity, n_classes=33 (context_dataset.py:15-159): labels are
1-indexed PNGs under ``context/33_context_labels`` shifted by -1; images come
from VOC2012; images containing any invalid (-1) pixel are dropped from every
split (context_dataset.py:85-93).

Extension, n_classes=59: the standard PASCAL-Context 59-class protocol
(Mottaghi et al. 2014's most-frequent subset — the evaluation vocabulary of
the FCN/DeepLab lineage; NOT in the reference, which ships only the 33-class
labels). Labels are 1-indexed PNGs under ``context/59_context_labels``
produced by ``scripts/make_context59_labels.py`` from the official full
annotations; pixel value 0 = not one of the 59 classes. Because nearly every
image contains some unmapped pixel under this vocabulary, the 33-class
drop-invalid-images rule would empty the splits — instead unmapped pixels map
to the ignore label (-1), which every loss/metric already masks (the same
convention the protocol's standard evaluations use).
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from zeroshotsemanticsegmentation_tpu_torch.data.assets import class_names
from zeroshotsemanticsegmentation_tpu_torch.data.base import SegDatasetBase


class PascalContext(SegDatasetBase):
    dataset_name = "context"

    def __init__(self, split: str, *, n_classes: int = 33, **kw):
        # class_names must be set before SegDatasetBase scans labels (the
        # presence matrix is sized off it)
        self.n_classes = int(n_classes)
        self.class_names = class_names("context", self.n_classes)
        super().__init__(split, **kw)

    def _cache_key(self) -> str:
        # 33 keeps the legacy key (existing caches stay valid)
        return "context" if self.n_classes == 33 else \
            f"context{self.n_classes}"

    def _needs_presence(self) -> bool:
        # the 33-class protocol drops invalid-pixel images in EVERY split
        # (context_dataset.py:85-93), so val needs the presence matrix too
        return self.n_classes == 33 or super()._needs_presence()

    def _keep_mask(self, presence):
        keep = super()._keep_mask(presence)
        if self.n_classes == 33:
            # reference: every split drops images with invalid pixels
            # (column 0 of the presence matrix) — context_dataset.py:85-93
            keep = keep & ~presence[:, 0]
        return keep

    def image_path(self, did: str) -> str:
        return osp.join(self.data_dir, "pascal", "VOCdevkit", "VOC2012",
                        "JPEGImages", f"{did}.jpg")

    def label_path(self, did: str) -> str:
        return osp.join(self.data_dir, "context",
                        f"{self.n_classes}_context_labels", f"{did}.png")

    def native_label_kwargs(self) -> dict:
        return {"value_offset": -1, "map255_to_ignore": False}

    def _load_image(self, did: str) -> np.ndarray:
        import PIL.Image
        return np.asarray(PIL.Image.open(self.image_path(did)).convert("RGB"),
                          dtype=np.uint8)

    def _load_label(self, did: str) -> np.ndarray:
        import PIL.Image
        lbl = np.asarray(PIL.Image.open(self.label_path(did)), dtype=np.int32)
        return lbl - 1  # 1-indexed -> 0-indexed, invalid/unmapped -> -1
