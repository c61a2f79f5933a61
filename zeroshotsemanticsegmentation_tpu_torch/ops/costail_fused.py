"""Fused stage-1 tail: masked cosine loss + NNE confusion histogram + score
sum in one pass over the full-resolution score, with a recompute backward.

`fused_cos_tail` is the train step's entry point (the JAX package's
ops/costail_fused.fused_cos_tail):

* on a CPU tensor it runs `cos_tail_plain`, the plain PyTorch version:
  per-sample `ops.losses.cosine_loss`, `ops.metrics.confusion_matrix` of
  `ops.nne.infer_labels`, and the sum, differentiated by autograd;
* on a CUDA tensor it runs `CosTail`, whose forward launches K5
  (`cos_tail_forward`, csrc/costail_fused.cu) and whose backward launches
  K6 (`cos_tail_backward`).

The kernels take the embedding rows already normalised (`l2_normalize`);
selecting a normalised row equals normalising the selected target. Only
`score` is differentiable: losses and score sum carry gradients, the
histogram does not, the embeddings are constants.
"""

from __future__ import annotations

import torch

from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
from zeroshotsemanticsegmentation_tpu_torch.ops.losses import (
    cosine_loss, embed_targets, l2_normalize)
from zeroshotsemanticsegmentation_tpu_torch.ops.metrics import (
    confusion_matrix)
from zeroshotsemanticsegmentation_tpu_torch.ops.nne import infer_labels

_MAX_C = 32              # the kernels' per-pixel register arrays (kMaxC)
_FWD_ARGTYPES = [_kernels.P] * 11 + [_kernels.I] * 6 + [_kernels.P]
_BWD_ARGTYPES = [_kernels.P] * 7 + [_kernels.I] * 4 + [_kernels.P]


def cos_tail_plain(score, label, target_embeddings, infer_embeddings,
                   num_classes: int):
    """Plain version of K5 (its autograd is the plain version of K6):
    (per-sample cosine losses (B,), hist (n, n) int32, score sum)."""
    temb = target_embeddings.to(score.device)
    losses = torch.stack([
        cosine_loss(score[i:i + 1], label[i:i + 1],
                    embed_targets(label[i:i + 1], temb))
        for i in range(score.shape[0])])
    pred = infer_labels(score.detach(), infer_embeddings.to(score.device))
    hist = confusion_matrix(label, pred, num_classes)
    return losses, hist, torch.sum(score.to(torch.float32))


def cos_tail_plain_backward(score, label, target_embeddings,
                            infer_embeddings, num_classes: int, g_losses,
                            g_ssum):
    """Plain version of K6: d score of `cos_tail_plain` by autograd."""
    with torch.enable_grad():
        s = score.detach().requires_grad_()
        losses, _, ssum = cos_tail_plain(s, label, target_embeddings,
                                         infer_embeddings, num_classes)
        return torch.autograd.grad((losses, ssum), s, (g_losses, g_ssum))[0]


def _check(score, label, temb_n) -> None:
    if not score.is_cuda:
        raise ValueError(f"cos_tail launches a CUDA kernel; score is on "
                         f"{score.device}")
    if score.dim() != 4 or score.dtype != torch.float32:
        raise ValueError(f"cos_tail: score must be float32 (B, H, W, C), "
                         f"got {score.dtype} {tuple(score.shape)}")
    b, h, w, c = score.shape
    if tuple(label.shape) != (b, h, w) or label.device != score.device:
        raise ValueError(f"cos_tail: label {tuple(label.shape)} on "
                         f"{label.device} does not match score "
                         f"{tuple(score.shape)}")
    k = temb_n.shape[0]
    if c > _MAX_C or temb_n.shape != (k, c):
        raise ValueError(f"cos_tail: C={c} with tables {tuple(temb_n.shape)}"
                         f"; the kernels take C <= {_MAX_C}")


def cos_tail_forward(score, label, temb_n, iemb_n, num_classes: int):
    """K5 wrapper (CUDA tensors only): (losses (B,), hist (n, n) int32,
    score sum (), valid counts (B,) fp32)."""
    _check(score, label, temb_n)
    b, h, w, c = score.shape
    k, n, hw = temb_n.shape[0], num_classes, h * w
    dev = score.device
    score = score.contiguous()
    label = label.to(torch.int32).contiguous()
    temb_n = temb_n.to(dev, torch.float32).contiguous()
    iemb_n = iemb_n.to(dev, torch.float32).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    losses = torch.empty((b,), **f32)
    nv = torch.empty((b,), **f32)
    ssum = torch.empty((), **f32)
    hist = torch.zeros((n, n), dtype=torch.int32, device=dev)
    if score.numel() == 0:
        return losses.zero_(), hist, ssum.zero_(), nv.zero_()
    # the kernel sizes its grid: `parts` blocks per sample
    parts = _kernels.function("costail_fused", "costail_forward_parts",
                              [_kernels.I] * 3)(b, hw, dev.index)
    if parts < 0:
        _kernels.check("costail_fused", -parts)
    cos_part = torch.empty((b, parts), **f32)
    nv_part = torch.empty((b, parts), dtype=torch.int32, device=dev)
    ssum_part = torch.empty((b, parts), **f32)
    fn = _kernels.function("costail_fused", "costail_forward", _FWD_ARGTYPES)
    p = _kernels.ptr
    rc = fn(p(score), p(label), p(temb_n), p(iemb_n), p(cos_part),
            p(nv_part), p(ssum_part), p(losses), p(nv), p(ssum), p(hist),
            b, hw, c, k, n, parts, _kernels.P(_kernels.stream_handle(dev)))
    _kernels.check("costail_fused", rc)
    _kernels.launch_counts["costail_fwd"] += 1
    return losses, hist, ssum, nv


def cos_tail_backward(score, label, temb_n, g_losses, nv, g_ssum):
    """K6 wrapper (CUDA tensors only): d score (B, H, W, C) fp32."""
    _check(score, label, temb_n)
    b, h, w, c = score.shape
    k = temb_n.shape[0]
    dev = score.device
    score = score.contiguous()
    label = label.to(torch.int32).contiguous()
    temb_n = temb_n.to(dev, torch.float32).contiguous()
    g_losses = g_losses.to(dev, torch.float32).reshape(b).contiguous()
    nv = nv.to(dev, torch.float32).reshape(b).contiguous()
    g_ssum = g_ssum.to(dev, torch.float32).reshape(1).contiguous()
    ds = torch.empty_like(score)
    if score.numel() == 0:
        return ds
    fn = _kernels.function("costail_fused", "costail_backward",
                           _BWD_ARGTYPES)
    p = _kernels.ptr
    rc = fn(p(score), p(label), p(temb_n), p(g_losses), p(nv), p(g_ssum),
            p(ds), b, h * w, c, k, _kernels.P(_kernels.stream_handle(dev)))
    _kernels.check("costail_fused", rc)
    _kernels.launch_counts["costail_bwd"] += 1
    return ds


class CosTail(torch.autograd.Function):
    """K5 forward, K6 backward (the JAX package's `_cos_tail` custom_vjp).
    Inputs: score, label, normalised target and infer tables, n."""

    @staticmethod
    def forward(ctx, score, label, temb_n, iemb_n, num_classes):
        losses, hist, ssum, nv = cos_tail_forward(score, label, temb_n,
                                                  iemb_n, num_classes)
        ctx.save_for_backward(score, label, temb_n, nv)
        ctx.mark_non_differentiable(hist)
        return losses, hist, ssum

    @staticmethod
    def backward(ctx, g_losses, _g_hist, g_ssum):
        score, label, temb_n, nv = ctx.saved_tensors
        ds = cos_tail_backward(score, label, temb_n, g_losses, nv, g_ssum)
        return ds, None, None, None, None


def fused_cos_tail(score, label, target_embeddings, infer_embeddings,
                   num_classes: int):
    """(per-sample cosine losses (B,), confusion hist (n, n) int32, score
    sum ()) from an NHWC fp32 score, differentiable in `score`:

      losses[b] == cosine_loss(score[b], label[b], E_target[label[b]])
      hist      == confusion_matrix(label, infer_labels(score, E_infer), n)
      score sum == score.sum()

    `target_embeddings` and `infer_embeddings`: (n, C) arrays or tensors.
    The kernels on a CUDA tensor, the plain version on a CPU tensor."""
    dev = score.device
    temb = torch.as_tensor(target_embeddings, dtype=torch.float32,
                           device=dev)
    iemb = torch.as_tensor(infer_embeddings, dtype=torch.float32, device=dev)
    if num_classes != temb.shape[0] or num_classes != iemb.shape[0]:
        raise ValueError(f"num_classes {num_classes} != embedding rows "
                         f"{temb.shape[0]}/{iemb.shape[0]}")
    if num_classes > 127:
        raise ValueError("int8 label feed caps classes at 127")
    if not score.is_cuda:
        return cos_tail_plain(score, label, temb, iemb, num_classes)
    return CosTail.apply(score, label, l2_normalize(temb),
                         l2_normalize(iemb), num_classes)
