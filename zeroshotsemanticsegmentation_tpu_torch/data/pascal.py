"""PASCAL VOC 2012 / SBD dataset, 21 classes with background (the JAX
package's data/pascal.py).

Reference parity (pascal_dataset.py:15-154): train/train_seen read SBD
``benchmark_RELEASE`` .mat labels, val reads VOC2012 PNG labels; 255 → -1
ignore remap; zero-shot filtering per base class. The per-pixel embedding
lookup happens on the device in the train/eval steps (the reference
gathers on the host per sample, pascal_dataset.py:122-128; shipping labels
instead of embedding volumes cuts host-to-device bytes by the embedding
dim).
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from zeroshotsemanticsegmentation_tpu_torch.data.assets import (
    PASCAL_CLASS_NAMES)
from zeroshotsemanticsegmentation_tpu_torch.data.base import SegDatasetBase


class PascalVOC(SegDatasetBase):
    class_names = PASCAL_CLASS_NAMES
    dataset_name = "pascal"

    def _sbd_dir(self) -> str:
        return osp.join(self.data_dir, "pascal", "benchmark_RELEASE", "dataset")

    def _voc_dir(self) -> str:
        return osp.join(self.data_dir, "pascal", "VOCdevkit", "VOC2012")

    def image_path(self, did: str) -> str:
        if self.split in ("train", "train_seen"):
            return osp.join(self._sbd_dir(), "img", f"{did}.jpg")
        return osp.join(self._voc_dir(), "JPEGImages", f"{did}.jpg")

    def label_path(self, did: str) -> str:
        if self.split in ("train", "train_seen"):
            return osp.join(self._sbd_dir(), "cls", f"{did}.mat")
        return osp.join(self._voc_dir(), "SegmentationClass", f"{did}.png")

    def _load_image(self, did: str) -> np.ndarray:
        import PIL.Image
        return np.asarray(PIL.Image.open(self.image_path(did)).convert("RGB"),
                          dtype=np.uint8)

    def _load_label(self, did: str) -> np.ndarray:
        if self.split in ("train", "train_seen"):
            lbl = load_sbd_label(self.label_path(did))
        else:
            import PIL.Image
            lbl = np.asarray(PIL.Image.open(self.label_path(did)),
                             dtype=np.int32)
        lbl = lbl.astype(np.int32)
        lbl[lbl == 255] = -1  # reference pascal_dataset.py:120
        return lbl


def load_sbd_label(path: str) -> np.ndarray:
    """Decode an SBD GTcls .mat segmentation (reference pascal_dataset.py:70-71)."""
    import scipy.io
    mat = scipy.io.loadmat(path)
    return mat["GTcls"][0]["Segmentation"][0].astype(np.int32)
