"""Metric helpers: the confusion histogram and class-set masks."""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(label_true: torch.Tensor, label_pred: torch.Tensor,
                     num_classes: int,
                     sample_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(num_classes, num_classes) int32 histogram, rows = true, cols = pred.

    Pixels whose true label lies outside [0, num_classes) are dropped (the
    reference's _fast_hist), as are those outside `sample_mask`. The counts
    are a scatter-add into an extra "dropped" bucket, so the function needs
    no host sync on the card."""
    n = num_classes
    valid = (label_true >= 0) & (label_true < n)
    if sample_mask is not None:
        valid = valid & sample_mask
    idx = label_true.long() * n + label_pred.long()
    idx = torch.where(valid & (idx >= 0) & (idx < n * n), idx,
                      torch.full_like(idx, n * n)).reshape(-1)
    hist = torch.zeros(n * n + 1, dtype=torch.int64, device=idx.device)
    hist.scatter_add_(0, idx, torch.ones_like(idx))
    return hist[:n * n].reshape(n, n).to(torch.int32)


def unseen_mask_vector(num_classes: int,
                       unseen: list[int] | tuple[int, ...]) -> np.ndarray:
    """(num_classes,) bool vector with True at unseen class ids."""
    v = np.zeros((num_classes,), dtype=bool)
    if unseen:
        v[np.asarray(list(unseen), dtype=np.int64)] = True
    return v
