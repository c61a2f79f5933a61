"""Nearest-neighbor-embedding (NNE) zero-shot inference, plain PyTorch.

Reference semantics (utils.py:156-205): per-pixel cosine similarity between
the regressed embedding and each class embedding, argmax over classes. For
seen/unseen stitching the reference zeroes the other partition's embedding
rows; a zeroed row scores exactly 0 (its norm is guarded to 1) and still
takes part in the argmax. So the restricted argmax here masks similarities
to 0.0, not -inf. `torch.argmax` returns the first maximum, as the JAX
package's argmax does.
"""

from __future__ import annotations

import torch


def cosine_similarities(score: torch.Tensor,
                        embeddings: torch.Tensor) -> torch.Tensor:
    """(..., C) x (K, C) -> (..., K) fp32 cosine similarities.

    Zero-norm embeddings get norm 1 (reference utils.py:175); zero-norm
    score vectors likewise (the reference would produce NaNs there)."""
    s = score.to(torch.float32)
    e = embeddings.to(torch.float32)
    sims = torch.einsum("...c,kc->...k", s, e)
    s_norm2 = torch.sum(s * s, dim=-1, keepdim=True)
    e_norm2 = torch.sum(e * e, dim=-1)
    s_norm = torch.sqrt(torch.where(s_norm2 == 0, torch.ones_like(s_norm2),
                                    s_norm2))
    e_norm = torch.sqrt(torch.where(e_norm2 == 0, torch.ones_like(e_norm2),
                                    e_norm2))
    return sims / (s_norm * e_norm)


def _restricted_argmax(sims: torch.Tensor,
                       class_mask: torch.Tensor | None) -> torch.Tensor:
    """Argmax over classes; masked-out classes score exactly 0.0."""
    if class_mask is not None:
        sims = torch.where(class_mask, sims, torch.zeros_like(sims))
    return torch.argmax(sims, dim=-1).to(torch.int32)


def infer_labels(score: torch.Tensor, embeddings: torch.Tensor,
                 class_mask: torch.Tensor | None = None) -> torch.Tensor:
    """NNE label map: (B, H, W, C) score x (K, C) -> (B, H, W) int32."""
    return _restricted_argmax(cosine_similarities(score, embeddings),
                              class_mask)


def infer_labels_stitched(score: torch.Tensor, embeddings: torch.Tensor,
                          unseen_class_mask: torch.Tensor,
                          pixel_unseen_mask: torch.Tensor) -> torch.Tensor:
    """Seen-restricted NNE where the pixel is predicted seen, unseen-
    restricted NNE where predicted unseen (reference utils.py:201-205)."""
    unseen_class_mask = unseen_class_mask.to(torch.bool)
    sims = cosine_similarities(score, embeddings)
    seen_lbl = _restricted_argmax(sims, ~unseen_class_mask)
    unseen_lbl = _restricted_argmax(sims, unseen_class_mask)
    return torch.where(pixel_unseen_mask, unseen_lbl, seen_lbl)


def infer_labels_szn(fcn_score: torch.Tensor, seenmask_score: torch.Tensor,
                     embeddings: torch.Tensor,
                     unseen_class_mask: torch.Tensor) -> torch.Tensor:
    """Full SZN inference (reference utils.py:195-199): the seenmask head's
    argmax (1 = seen) gates which class partition each pixel uses."""
    pixel_unseen = torch.argmax(seenmask_score, dim=-1) == 0
    return infer_labels_stitched(fcn_score, embeddings, unseen_class_mask,
                                 pixel_unseen)


def infer_labels_forced_unseen(score: torch.Tensor, target: torch.Tensor,
                               embeddings: torch.Tensor,
                               unseen_class_mask) -> torch.Tensor:
    """Oracle stitching from ground-truth membership (reference
    utils.py:188-192): a pixel whose true class is unseen takes the
    unseen-restricted NNE, every other pixel the seen-restricted one."""
    k = embeddings.shape[0]
    mask = torch.as_tensor(unseen_class_mask, dtype=torch.bool,
                           device=score.device)
    pixel_unseen = mask[target.clamp(0, k - 1).long()] & (target >= 0)
    return infer_labels_stitched(score, embeddings, mask, pixel_unseen)
