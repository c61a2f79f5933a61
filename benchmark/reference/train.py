"""Plain fp32 reference of the first training steps of both stages.

Stage 1 (the SZN reference's config 14): the "fcn" forward with channel
dropout after fc6 and fc7, the cosine loss of each image (its valid
pixels' mean of 1 - cos(score, target embedding); label -1 is ignored),
summed over the batch and divided by the number of images, and Adam with
the reference's groups: conv weights at `lr`, biases at 2 x `lr`, the
seenmask head and its upsample left out. Stage 2: the trunk frozen (no
gradient, dropout still drawn), the seenmask head's pixelwise
cross-entropy against "the pixel's class is seen" (unlabelled pixels are
unseen, bucket padding ignored), averaged over each image's valid pixels,
summed over the batch and divided by its images; Adam at one `lr` on
`seenmask_score` and `seenmask_upscore`. `quant="fp8"` (or "int8")
computes the convolutions in that precision (`fcn.fake_fp8`,
`fcn.fake_int8`): the correctness control.

Adam is torch's rule (betas 0.9 and 0.999, eps 1e-8 outside the square
root, bias-corrected), written out here. The batch goes through in
chunks of images whose gradients add up to the batch's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import fcn as ref

BETAS = (0.9, 0.999)
EPS = 1e-8
STAGE2_PARAMS = ("seenmask_score.weight", "seenmask_score.bias",
                 "seenmask_upscore.weight")


def trainable(stage: int, names) -> list[str]:
    if stage == 2:
        return [n for n in names if n in STAGE2_PARAMS]
    return [n for n in names if n.split(".")[0] not in
            ("seenmask_score", "seenmask_upscore")]


def lr_of(stage: int, name: str, lr: float) -> float:
    return 2.0 * lr if stage == 1 and name.endswith(".bias") else lr


def _l2n(x: torch.Tensor) -> torch.Tensor:
    n2 = (x * x).sum(1, keepdim=True)
    return x / torch.sqrt(torch.where(n2 == 0, torch.ones_like(n2), n2))


def cosine_losses(score, label, emb) -> torch.Tensor:
    """(B,) per-image cosine losses of NCHW `score` against `label`."""
    valid = label >= 0
    t = emb[label.clamp(min=0).long()].permute(0, 3, 1, 2)
    cos = (_l2n(score) * _l2n(t)).sum(1)
    nv = valid.sum((1, 2)).to(torch.float32)
    s = torch.where(valid, cos, torch.zeros_like(cos)).sum((1, 2))
    return (nv - s) / nv.clamp(min=1)


def seen_target(label, sizes, unseen) -> torch.Tensor:
    """1 where the class is seen, 0 where unseen or unlabelled, -1 on the
    bucket padding."""
    k_unseen = torch.zeros(256, dtype=torch.bool, device=label.device)
    k_unseen[list(unseen)] = True
    seen = (label >= 0) & ~k_unseen[label.clamp(min=0).long()]
    tgt = seen.to(torch.int64)
    rows = torch.arange(label.shape[1], device=label.device)[None, :, None]
    cols = torch.arange(label.shape[2], device=label.device)[None, None, :]
    sz = sizes.to(label.device)
    pad = (rows >= sz[:, 0, None, None]) | (cols >= sz[:, 1, None, None])
    return torch.where(pad, torch.full_like(tgt, -1), tgt)


def ce_losses(score, target) -> torch.Tensor:
    """(B,) per-image cross-entropy of NCHW `score`, mean over valid
    pixels."""
    logp = F.log_softmax(score, dim=1)
    valid = target >= 0
    nll = -logp.gather(1, target.clamp(min=0)[:, None])[:, 0]
    s = torch.where(valid, nll, torch.zeros_like(nll)).sum((1, 2))
    return s / valid.sum((1, 2)).clamp(min=1).to(torch.float32)


def run_steps(cfg: dict, stage: int, weights: dict, batches: list,
              masks: list, emb: torch.Tensor, lr: float, unseen,
              chunk: int = 4, quant=None, half: bool = False) -> dict:
    """The first len(batches) steps from `weights`. batches: [(uint8
    images (B, H, W, 3), int labels (B, H, W), sizes (B, 2))]; masks:
    [(fc6 keep, fc7 keep)] a step. Returns the losses, the first step's
    gradient norms and the change of each trained parameter over the
    steps (norms, fp64), by name, and the first step's full-resolution
    head that the loss reads (`scores`, NCHW: the embedding score in stage
    1, the seenmask score in stage 2). `half` leaves out the second half
    of each batch and divides by the first half's images: a planted
    fault."""
    names = trainable(stage, weights)
    p = {n: t.detach().clone() for n, t in weights.items()}
    for n in names:
        p[n].requires_grad_(True)
    m = {n: torch.zeros_like(p[n]) for n in names}
    v = {n: torch.zeros_like(p[n]) for n in names}
    losses, g1, scores = [], {}, []
    for step, ((img, lbl, sizes), mk) in enumerate(zip(batches, masks), 1):
        dev = img.device
        b = img.shape[0] // 2 if half else img.shape[0]
        total = torch.zeros((), dtype=torch.float64, device=dev)
        for a in range(0, b, chunk):
            sl = slice(a, min(a + chunk, b))
            x = ref.normalize(img[sl], sizes[sl])
            lb = lbl[sl].to(torch.int64)
            mm = (mk[0][sl], mk[1][sl])
            if stage == 1:
                score, _ = ref.heads(cfg, p, x, mm, quant, mode="fcn")
                part = cosine_losses(score, lb, emb).sum() / b
            else:
                with torch.no_grad():
                    h, _, _ = ref.trunk(cfg, p, x, mm, quant)
                _, seen = seen_heads(cfg, p, h, x.shape[2], x.shape[3],
                                     quant)
                part = ce_losses(seen, seen_target(lb, sizes[sl],
                                                   unseen)).sum() / b
            if step == 1:
                scores.append((score if stage == 1 else seen).detach())
            part.backward()
            total += part.detach().to(torch.float64)
        losses.append(float(total))
        with torch.no_grad():
            for n in names:
                g = p[n].grad
                if step == 1:
                    g1[n] = float(g.double().norm())
                m[n].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[n].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                mh = m[n] / (1 - BETAS[0] ** step)
                vh = v[n] / (1 - BETAS[1] ** step)
                p[n].sub_(lr_of(stage, n, lr) * mh / (vh.sqrt() + EPS))
                p[n].grad = None
    delta = {n: float((p[n].detach().double() - weights[n].double()).norm())
             for n in names}
    return {"losses": losses, "g1": g1, "delta": delta,
            "scores": torch.cat(scores)}


def seen_heads(cfg, p, h, in_h, in_w, quant=None):
    """The seenmask head and its x32 upsample from the trunk's output."""
    g = ref.conv(h, p["seenmask_score.weight"], p["seenmask_score.bias"],
                 0, quant)
    st, crop = cfg["upsample_stride"], cfg["crop"]
    if "seenmask_upscore.weight" in p:
        s = F.conv_transpose2d(g, p["seenmask_upscore.weight"], stride=st)
        return None, s[:, :, crop:crop + in_h, crop:crop + in_w]
    return None, ref.upsample(g, st, cfg["upsample_kernel"], crop, in_h,
                              in_w)
