"""How far a served label lies from the reference's own choice.

SZN labels a pixel in two steps (the reference's utils.py:156-205): the
seenmask gate picks the unseen classes where its channel 0 is not below
channel 1, else the seen classes; then the label is the first maximum of
the cosine similarities with all classes, those outside the partition
scoring exactly 0 (their embedding rows zeroed).

The cost of a label L under a partition P, from the reference's fp32
scores: for L in P, P's best masked score minus L's score; for L outside
P, P's best masked score if L is the first class outside P (the first
maximum among the zeros when every class of P scores at most 0), else
never. With R the partition the reference's gate picks and Q the other,
a pixel's `label_gap` is

- 0 where cost_R <= `tolerance` (the reference's own decision, up to a
  class near-tie);
- the reference's gate margin |s0 - s1| where only cost_Q <= `tolerance`
  (the program overturned the gate, by that margin);
- `UNEXPLAINED` where neither explains the label (a wrong answer);

`label_gap` is the widest over the pixels, `label_gap_mean` the mean
(with `pixels` and `gap_sum` to pool it over images); `class_gap`, the
widest min(cost_R, cost_Q), is read beside them. The near-tie
`tolerance` is a cell's limit on `class_gap`: a pixel whose class gap
exceeds it is unexplained.
"""

from __future__ import annotations

import torch

from benchmark.reference.fcn import cosine

# a label that no gate and no class near-tie explains
UNEXPLAINED = 1000.0


def _partitions(k: int, unseen: list[int], device):
    is_unseen = torch.zeros(k, dtype=torch.bool, device=device)
    is_unseen[list(unseen)] = True
    return ~is_unseen, is_unseen  # seen, unseen


def stitched_labels(score: torch.Tensor, seen: torch.Tensor,
                    emb: torch.Tensor, unseen: list[int]) -> torch.Tensor:
    """(B, H, W) int32 SZN labels of the NCHW heads (the reference's
    inference)."""
    sims = cosine(score, emb)
    p_seen, p_unseen = _partitions(sims.shape[1], unseen, sims.device)
    zero = torch.zeros_like(sims)
    m_seen = torch.where(p_seen[None, :, None, None], sims, zero)
    m_unseen = torch.where(p_unseen[None, :, None, None], sims, zero)
    pick_unseen = seen[:, 0] >= seen[:, 1]
    return torch.where(pick_unseen, m_unseen.argmax(1),
                       m_seen.argmax(1)).to(torch.int32)


def _cost(sims, lab, part):
    """(B, H, W) cost of labels `lab` under partition `part` (K,)."""
    m = torch.where(part[None, :, None, None], sims, torch.zeros_like(sims))
    best = m.amax(1)
    inside = part[lab]
    fill = int(torch.nonzero(~part)[0]) if bool((~part).any()) else -1
    own = best - sims.gather(1, lab[:, None])[:, 0]
    out = torch.where(lab == fill, best, torch.full_like(best, float("inf")))
    return torch.where(inside, own, out)


def label_gaps(score: torch.Tensor, seen: torch.Tensor, emb: torch.Tensor,
               unseen: list[int], labels: torch.Tensor,
               tolerance: float) -> dict:
    """The numbers above of `labels` (B, H, W) under the
    reference heads `score` (B, C, H, W) and `seen` (B, 2, H, W), a class
    near-tie up to `tolerance` explaining a label. A label outside [0, K)
    is unexplained."""
    k = emb.shape[0]
    lab = labels.to(torch.int64)
    n = lab.numel()
    if not n:
        return {"label_gap": 0.0, "class_gap": 0.0, "gap_sum": 0.0,
                "pixels": 0}
    if int(lab.min()) < 0 or int(lab.max()) >= k:
        return {"label_gap": UNEXPLAINED, "class_gap": UNEXPLAINED,
                "gap_sum": UNEXPLAINED * n, "pixels": n}
    sims = cosine(score, emb)
    p_seen, p_unseen = _partitions(k, unseen, sims.device)
    c_seen, c_unseen = _cost(sims, lab, p_seen), _cost(sims, lab, p_unseen)
    d = seen[:, 0] - seen[:, 1]
    ref_unseen = d >= 0
    c_ref = torch.where(ref_unseen, c_unseen, c_seen)
    c_other = torch.where(ref_unseen, c_seen, c_unseen)
    gap = torch.where(c_other <= tolerance, d.abs(),
                      torch.full_like(d, UNEXPLAINED))
    gap = torch.where(c_ref <= tolerance, torch.zeros_like(d), gap)
    cls = torch.minimum(c_ref, c_other).clamp(max=UNEXPLAINED)
    return {"label_gap": float(gap.max()), "class_gap": float(cls.max()),
            "gap_sum": float(gap.double().sum()), "pixels": n}
