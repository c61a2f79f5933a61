"""Masked segmentation losses (the JAX package's ops/losses.py; reference
semantics utils.py:19-102).

Scores are NHWC with integer (B, H, W) labels; label < 0 means "ignore".
Every loss sums over all pixels it is given and normalises by the count of
valid pixels, so padding with label -1 leaves it unchanged. Accumulation is
fp32 whatever the score's dtype. These are the plain branch of the train
step and the plain version of the fused cosine tail (`ops.costail_fused`).
"""

from __future__ import annotations

import torch


def _valid_mask(target: torch.Tensor) -> torch.Tensor:
    # ignore -1 (unknown classes / padding); class 0 counts
    return target >= 0


def cross_entropy2d(score: torch.Tensor, target: torch.Tensor, *,
                    size_average: bool = False) -> torch.Tensor:
    """Masked pixelwise cross-entropy: the NLL summed over valid pixels,
    divided by their count iff `size_average`."""
    logp = torch.log_softmax(score.to(torch.float32), dim=-1)
    valid = _valid_mask(target)
    tgt = torch.where(valid, target, torch.zeros_like(target)).long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    loss = torch.sum(torch.where(valid, nll, torch.zeros_like(nll)))
    if size_average:
        loss = loss / valid.sum().clamp(min=1).to(torch.float32)
    return loss


def mse_loss(score: torch.Tensor, target: torch.Tensor,
             target_embed: torch.Tensor) -> torch.Tensor:
    """Squared error summed over the channels of valid pixels, divided by
    the number of valid pixels (not pixel-channels)."""
    valid = _valid_mask(target)
    d2 = torch.sum((score.to(torch.float32)
                    - target_embed.to(torch.float32)) ** 2, dim=-1)
    n = valid.sum().clamp(min=1).to(torch.float32)
    return torch.sum(torch.where(valid, d2, torch.zeros_like(d2))) / n


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / |x| over the last axis with 0/0 := 0. The double where keeps the
    square root away from 0, so the gradient stays finite at zero vectors
    (padding regions)."""
    norm2 = torch.sum(x * x, dim=-1, keepdim=True)
    norm = torch.sqrt(torch.where(norm2 == 0, torch.ones_like(norm2), norm2))
    return x / norm


def cosine_loss(score: torch.Tensor, target: torch.Tensor,
                target_embed: torch.Tensor) -> torch.Tensor:
    """(n_valid - sum over valid pixels of cos(score, target_embed)) /
    max(n_valid, 1)."""
    s = l2_normalize(score.to(torch.float32))
    t = l2_normalize(target_embed.to(torch.float32))
    valid = _valid_mask(target)
    cos = torch.sum(s * t, dim=-1)
    nv = valid.sum().to(torch.float32)
    return (nv - torch.sum(torch.where(valid, cos, torch.zeros_like(cos)))) \
        / nv.clamp(min=1)


def embed_targets(label: torch.Tensor, embeddings: torch.Tensor
                  ) -> torch.Tensor:
    """Per-pixel embeddings[label] in fp32, zero where the label is outside
    [0, K) (the JAX package's one-hot select of clip(label, 0))."""
    k = embeddings.shape[0]
    e = embeddings.to(torch.float32)
    rows = e[label.clamp(0, k - 1).long()]
    return torch.where((label < k)[..., None], rows, torch.zeros_like(rows))
