"""Metric helpers. Only what serving needs so far."""

from __future__ import annotations

import numpy as np


def unseen_mask_vector(num_classes: int,
                       unseen: list[int] | tuple[int, ...]) -> np.ndarray:
    """(num_classes,) bool vector with True at unseen class ids."""
    v = np.zeros((num_classes,), dtype=bool)
    if unseen:
        v[np.asarray(list(unseen), dtype=np.int64)] = True
    return v
