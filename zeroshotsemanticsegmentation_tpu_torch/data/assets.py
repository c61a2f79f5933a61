"""Bundled class metadata: names and embedding matrices.

Embeddings are the reference's word2vec-derived class matrices, stored as
``.npy`` data files under the repository's ``assets/<dataset>/embeddings/``.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

_ASSETS_DIR = osp.join(
    osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))), "assets")

# reference pascal_dataset.py:16-38
PASCAL_CLASS_NAMES = (
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "potted plant", "sheep", "sofa", "train", "tv/monitor",
)

# reference context_dataset.py:16-50 (33 classes, no background)
CONTEXT_CLASS_NAMES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor", "sky", "grass",
    "ground", "road", "building", "tree", "water", "mountain", "wall",
    "floor", "track", "keyboard", "ceiling",
)

# PASCAL-Context 59-class vocabulary (alphabetical; label id = index + 1)
CONTEXT59_CLASS_NAMES = (
    "aeroplane", "bag", "bed", "bedclothes", "bench", "bicycle", "bird",
    "boat", "book", "bottle", "building", "bus", "cabinet", "car", "cat",
    "ceiling", "chair", "cloth", "computer", "cow", "cup", "curtain", "dog",
    "door", "fence", "floor", "flower", "food", "grass", "ground", "horse",
    "keyboard", "light", "motorbike", "mountain", "mouse", "person", "plate",
    "platform", "pottedplant", "road", "rock", "sheep", "shelves",
    "sidewalk", "sign", "sky", "snow", "sofa", "table", "track", "train",
    "tree", "truck", "tvmonitor", "wall", "water", "window", "wood",
)

_NUM_CLASSES = {"pascal": 21, "context": 33}


def class_names(dataset: str,
                n_classes: int | None = None) -> tuple[str, ...]:
    if dataset == "pascal":
        return PASCAL_CLASS_NAMES
    if dataset == "context":
        if n_classes in (None, 33):
            return CONTEXT_CLASS_NAMES
        if n_classes == 59:
            return CONTEXT59_CLASS_NAMES
        raise ValueError(f"context supports 33 or 59 classes, "
                         f"got {n_classes}")
    raise ValueError(f"unknown dataset {dataset!r}")


def load_class_embeddings(dataset: str, embed_dim: int, *,
                          one_hot: bool = False,
                          assets_dir: str | None = None,
                          n_classes: int | None = None) -> np.ndarray:
    """(n_class, embed_dim) float32 class-embedding matrix.

    `n_classes` selects a vocabulary variant (context 59: suffix `_59` on
    the asset file names); the default is the reference vocabulary."""
    assets_dir = assets_dir or _ASSETS_DIR
    n = _NUM_CLASSES[dataset]
    suffix = ""
    if n_classes is not None and n_classes != n:
        n = len(class_names(dataset, n_classes))  # validates the variant
        suffix = f"_{n}"
    if one_hot:
        if embed_dim != n:
            raise ValueError(
                f"one-hot embeddings for {dataset} require embed_dim={n}, "
                f"got {embed_dim}")
        path = osp.join(assets_dir, dataset, "embeddings",
                        f"one_hot_{n}_dim.npy")
    else:
        path = osp.join(assets_dir, dataset, "embeddings",
                        f"norm_embed_arr_{embed_dim}{suffix}.npy")
    if not osp.exists(path):
        raise FileNotFoundError(f"{path} not found: embedding matrix is not "
                                "bundled")
    arr = np.load(path).astype(np.float32)
    if arr.shape != (n, embed_dim):
        raise ValueError(f"bad embedding matrix {path}: {arr.shape}")
    return arr
