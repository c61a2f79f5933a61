"""Shared dataset machinery: split filtering with a class-presence cache
(the JAX package's data/base.py).

The reference's zero-shot split filtering re-decodes *every* training label at
dataset construction just to test class membership (pascal_dataset.py:62-84 —
its cold-start hot spot). Here each (dataset, split) gets a cached per-image
class-presence matrix, computed once and reused for any unseen-class
combination.

Filtering semantics preserved exactly:
  * 'train'      : drop images containing any val_unseen pixel
                   (pascal_dataset.py:78-80)
  * 'train_seen' : drop images containing any train_unseen ∪ val_unseen pixel
                   (pascal_dataset.py:81-83)
  * context adds: drop images containing invalid (-1) pixels in *every* split
                   (context_dataset.py:85-93)
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from zeroshotsemanticsegmentation_tpu_torch.data.assets import load_split_ids
from zeroshotsemanticsegmentation_tpu_torch.data.native import (
    DecodeError, NativeLoader)
from zeroshotsemanticsegmentation_tpu_torch.data.transforms import (
    DEFAULT_BUCKET, transform_image)

_SPLITS = ("train", "train_seen", "val")


class SegDatasetBase:
    """Iterable of {image float32 HWC (BGR, mean-sub), label int32 HW, id, size}."""

    class_names: tuple[str, ...] = ()
    dataset_name: str = ""

    def __init__(self, split: str, *, data_dir: str,
                 train_unseen: list[int] | None = None,
                 val_unseen: list[int] | None = None,
                 assets_dir: str | None = None,
                 use_presence_cache: bool = True):
        if split not in _SPLITS:
            raise ValueError(f"unexpected split {split!r} for "
                             f"{self.dataset_name} dataset")
        self.split = split
        self.data_dir = data_dir
        self.train_unseen = list(train_unseen or [])
        self.val_unseen = list(val_unseen or [])
        all_ids = load_split_ids(self.dataset_name, split,
                                 assets_dir=assets_dir)
        if self._needs_presence():
            presence = self._presence_matrix(all_ids, use_presence_cache)
            keep = self._keep_mask(presence)
            self.ids = [d for d, k in zip(all_ids, keep) if k]
        else:
            # nothing to filter (e.g. pascal val): skip the full label scan —
            # decoding every label here is exactly the reference cold-start
            # hot spot this cache exists to avoid (pascal_dataset.py:62-84)
            self.ids = list(all_ids)

    # -- filtering ---------------------------------------------------------

    def _drop_classes(self) -> list[int]:
        """Class ids whose presence in an image drops it from this split."""
        if self.split == "train":
            return self.val_unseen
        if self.split == "train_seen":
            return self.train_unseen + self.val_unseen
        return []

    def _needs_presence(self) -> bool:
        """Whether `_keep_mask` will actually read the presence matrix;
        subclasses with split-independent drop rules (context's invalid-pixel
        rule) override."""
        return bool(self._drop_classes())

    def _keep_mask(self, presence: np.ndarray) -> np.ndarray:
        drop = self._drop_classes()
        if not drop:
            return np.ones(presence.shape[0], dtype=bool)
        # presence column j holds class id j-1 (column 0 = invalid label -1)
        cols = np.asarray(drop, dtype=np.int64) + 1
        return ~presence[:, cols].any(axis=1)

    def _cache_key(self) -> str:
        """Presence-cache identity; variants with different label
        vocabularies (context 33 vs 59) must not share a cache."""
        return self.dataset_name

    def _presence_matrix(self, ids: list[str], use_cache: bool) -> np.ndarray:
        """(n_images, 1 + n_class) bool: column 0 = has-invalid(-1), then classes."""
        n_class = len(self.class_names)
        cache_path = osp.join(self.data_dir, "cache",
                              f"{self._cache_key()}_{self.split}_presence.npz")
        if use_cache and osp.exists(cache_path):
            try:
                with np.load(cache_path, allow_pickle=False) as z:
                    if list(z["ids"]) == ids:
                        return z["presence"]
            except Exception:
                pass  # corrupt/truncated cache (killed writer): recompute
        presence = np.zeros((len(ids), 1 + n_class), dtype=bool)
        for i, did in enumerate(ids):
            lbl = self._scan_label(did)
            u = np.unique(lbl)
            u = u[(u >= -1) & (u < n_class)]
            presence[i, u + 1] = True
        if use_cache:
            os.makedirs(osp.dirname(cache_path), exist_ok=True)
            # atomic publish: a crash mid-write (or a concurrent writer) must
            # never leave a truncated .npz that poisons every later startup
            tmp = f"{cache_path}.{os.getpid()}.tmp.npz"  # savez appends .npz
            np.savez_compressed(tmp, ids=np.asarray(ids), presence=presence)
            os.replace(tmp, cache_path)
        return presence

    def _scan_label(self, did: str) -> np.ndarray:
        """One label for the presence scan: through the native decoder
        where the dataset has `native_label_kwargs` (the scan then needs no
        PIL; the values are `_load_label`'s), cropped to the size it
        reports, else `_load_label`."""
        if not hasattr(self, "native_label_kwargs"):
            return self._load_label(did)
        kwargs = self.native_label_kwargs()
        loader, path = NativeLoader.get(), self.label_path(did)
        try:
            lbl, (h, w) = loader.decode_label(path, DEFAULT_BUCKET, **kwargs)
        except DecodeError as e:
            if e.rc != -2:  # -2: larger than the bucket; its size is known
                raise
            lbl, (h, w) = loader.decode_label(path, e.size, **kwargs)
        return lbl[:h, :w]

    # -- to be provided by subclasses --------------------------------------

    def _load_label(self, did: str) -> np.ndarray:
        raise NotImplementedError

    def _load_image(self, did: str) -> np.ndarray:
        raise NotImplementedError

    # -- access ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.ids)

    # when True (set by BatchLoader(compact=True)) images stay raw uint8 RGB
    # and are normalized on the device (transforms.prepare_images)
    raw_images: bool = False

    def __getitem__(self, index: int) -> dict:
        did = self.ids[index]
        img = self._load_image(did)
        lbl = self._load_label(did)
        return {
            "image": img if self.raw_images else transform_image(img),
            "label": lbl.astype(np.int32),
            "id": did,
            "size": (lbl.shape[0], lbl.shape[1]),
        }
