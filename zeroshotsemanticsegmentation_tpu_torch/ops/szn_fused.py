"""Fused SZN inference: class projection + x32 bilinear upsample + stitched
argmax from the 1/32-resolution heads; the full-resolution score volume
never exists.

Algebra (as in the JAX package): the upscore is linear and per channel, and
the class projection is linear per pixel, so they commute,

    upsample(score) . e_k / |e_k|  ==  upsample(score . e_k / |e_k|),

and the per-pixel score norm does not change an argmax. The seenmask gate
likewise: sign(upsample(s0 - s1)) decides the seenmask argmax. So:

  1. pre-stage (plain PyTorch, tiny tensors): fp32 projection of the raw
     head onto the row-normalized embeddings, the gate s0 - s1 appended as
     row K -> `aug` (B, h32, w32, K+1);
  2. `szn_labels`: the kernel `csrc/szn_fused.cu` (on a CUDA tensor) or its
     plain version `szn_labels_plain` (on a CPU tensor) upsamples each row
     to the output size and takes the masked seen/unseen first-max argmaxes
     (fill 0.0 for excluded classes, -1e30 for the gate row) and the gate
     select, emitting int32 labels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
from zeroshotsemanticsegmentation_tpu_torch.ops.bilinear import (
    upsample_matrix)

_UPSAMPLE_STRIDE = 32
_UPSAMPLE_KERNEL = 64
_CROP_OFFSET = 19
_GATE_FILL = -1e30
_MAX_SMEM_BYTES = 48 * 1024

_ARGTYPES = [_kernels.P] * 9 + [_kernels.I] * 6 + [_kernels.P]


def _matrix(in_len: int, out_len: int, device) -> torch.Tensor:
    return torch.tensor(upsample_matrix(
        in_len, _UPSAMPLE_STRIDE, _UPSAMPLE_KERNEL, _CROP_OFFSET,
        out_len), device=device)


@functools.lru_cache(maxsize=64)
def _taps(in_len: int, out_len: int, device: str):
    """The interpolation matrix as a 2-tap table: first input index (int32,
    (out_len,)) and the two weights (fp32, (2, out_len)), on `device`.
    Raises if a row has taps that are not two adjacent entries."""
    m = upsample_matrix(in_len, _UPSAMPLE_STRIDE, _UPSAMPLE_KERNEL,
                        _CROP_OFFSET, out_len)
    nz = m != 0
    i0 = np.where(nz.any(axis=1), nz.argmax(axis=1), 0)
    i1 = np.minimum(i0 + 1, in_len - 1)
    o = np.arange(out_len)
    w = np.zeros((2, out_len), np.float32)
    w[0] = m[o, i0]
    w[1] = np.where(i0 + 1 < in_len, m[o, i1], 0.0)
    recon = np.zeros_like(m)
    recon[o, i0] = w[0]
    recon[o, i1] += w[1]
    if not np.array_equal(recon, m):
        raise ValueError("upsample matrix has more than two adjacent taps "
                         f"per row (in_len={in_len}, out_len={out_len})")
    return (torch.from_numpy(i0.astype(np.int32)).to(device),
            torch.from_numpy(w).to(device))


def szn_labels_plain(aug: torch.Tensor, seen: torch.Tensor,
                     unseen: torch.Tensor, fill: torch.Tensor,
                     out_h: int, out_w: int) -> torch.Tensor:
    """Plain version of the kernel: interpolation-matrix upsample of every
    row of `aug` (B, h32, w32, K+1) to (B, out_h, out_w, K+1) in fp32,
    masked first-max argmaxes, gate select -> (B, out_h, out_w) int32."""
    _, h32, w32, _ = aug.shape
    up = torch.einsum("oh,bhwk->bowk", _matrix(h32, out_h, aug.device), aug)
    up = torch.einsum("pw,bowk->bopk", _matrix(w32, out_w, aug.device), up)
    seen_arg = torch.argmax(torch.where(seen != 0, up, fill), dim=-1)
    unseen_arg = torch.argmax(torch.where(unseen != 0, up, fill), dim=-1)
    return torch.where(up[..., -1] >= 0, unseen_arg, seen_arg).to(
        torch.int32)


def szn_labels(aug: torch.Tensor, seen: torch.Tensor, unseen: torch.Tensor,
               fill: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Kernel wrapper: launches `csrc/szn_fused.cu` on a CUDA tensor; a CPU
    tensor takes `szn_labels_plain`."""
    if not aug.is_cuda:
        return szn_labels_plain(aug, seen, unseen, fill, out_h, out_w)
    if aug.dim() != 4 or aug.dtype != torch.float32 \
            or not aug.is_contiguous():
        raise ValueError("szn_labels: aug must be a contiguous float32 "
                         f"(B, h32, w32, K+1) tensor, got {aug.dtype} "
                         f"{tuple(aug.shape)}")
    b, h32, w32, kp1 = aug.shape
    dev = aug.device
    for name, t, dt in (("seen", seen, torch.int32),
                        ("unseen", unseen, torch.int32),
                        ("fill", fill, torch.float32)):
        if t.shape != (kp1,) or t.dtype != dt or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"szn_labels: {name} must be a contiguous {dt} "
                             f"({kp1},) tensor on {dev}")
    smem = 4 * (kp1 * w32 + 3 * kp1)
    if smem > _MAX_SMEM_BYTES or b > 65535:
        raise ValueError(f"szn_labels: shape {tuple(aug.shape)} -> "
                         f"({out_h}, {out_w}) exceeds the kernel's limits")
    row_i0, row_w = _taps(h32, out_h, str(dev))
    col_i0, col_w = _taps(w32, out_w, str(dev))
    out = torch.empty((b, out_h, out_w), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    fn = _kernels.function("szn_fused", "szn_fused_labels", _ARGTYPES)
    p = _kernels.ptr
    rc = fn(p(aug), p(seen), p(unseen), p(fill), p(row_i0), p(row_w),
            p(col_i0), p(col_w), p(out), b, h32, w32, kp1, out_h, out_w,
            _kernels.P(_kernels.stream_handle(dev)))
    _kernels.check("szn_fused", rc)
    _kernels.launch_counts["szn_fused"] += 1
    return out


def _embed_scaled(embeddings, device) -> torch.Tensor:
    e = torch.as_tensor(embeddings, dtype=torch.float32, device=device)
    norm2 = torch.sum(e * e, dim=1, keepdim=True)
    return e / torch.sqrt(torch.where(norm2 == 0, torch.ones_like(norm2),
                                      norm2))


def _aug(score_small: torch.Tensor, gate_small: torch.Tensor,
         embed_scaled: torch.Tensor) -> torch.Tensor:
    """Pre-stage: fp32 class projection with the gate appended as row K."""
    sims = torch.einsum("bhwc,kc->bhwk", score_small.to(torch.float32),
                        embed_scaled)
    return torch.cat([sims, gate_small[..., None]], dim=-1).contiguous()


def _partition(cls_seen: torch.Tensor, cls_unseen: torch.Tensor):
    """(seen, unseen, fill) over K+1 rows; row K (the gate) is in neither
    partition and fills with -1e30 so it never wins an argmax."""
    dev = cls_seen.device
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    k = cls_seen.shape[0]
    seen = torch.cat([cls_seen.to(torch.int32), zero])
    unseen = torch.cat([cls_unseen.to(torch.int32), zero])
    fill = torch.cat([torch.zeros((k,), dtype=torch.float32, device=dev),
                      torch.full((1,), _GATE_FILL, dtype=torch.float32,
                                 device=dev)])
    return seen, unseen, fill


def infer_labels_szn_fused(score_small: torch.Tensor,
                           seenmask_small: torch.Tensor, embeddings,
                           unseen_class_mask, out_hw: tuple[int, int]
                           ) -> torch.Tensor:
    """SZN labels from the raw (1/32-res) heads (model mode='raw').

    score_small (B, h32, w32, C), seenmask_small (B, h32, w32, 2) ->
    (B, out_h, out_w) int32. Equivalent to upsampling both heads and running
    `ops.nne.infer_labels_szn`."""
    dev = score_small.device
    e = _embed_scaled(embeddings, dev)
    if e.shape[1] != score_small.shape[-1]:
        raise ValueError(f"embeddings {tuple(e.shape)} do not match the "
                         f"score width {score_small.shape[-1]}")
    uv = torch.as_tensor(np.asarray(unseen_class_mask, dtype=bool),
                         device=dev)
    seen, unseen, fill = _partition(~uv, uv)
    gate = (seenmask_small[..., 0] - seenmask_small[..., 1]).to(torch.float32)
    return szn_labels(_aug(score_small, gate, e), seen, unseen, fill,
                      int(out_hw[0]), int(out_hw[1]))


def infer_labels_nne_fused(score_small: torch.Tensor, embeddings,
                           out_hw: tuple[int, int]) -> torch.Tensor:
    """Plain (unstitched) NNE over all classes from the raw head, through
    the same kernel: an always-negative gate (the upsample of a constant -1
    stays < 0) makes every pixel take the seen partition, here all classes.
    Equivalent to `ops.nne.infer_labels(upsample(score), embeddings)`."""
    dev = score_small.device
    e = _embed_scaled(embeddings, dev)
    k = e.shape[0]
    seen, unseen, fill = _partition(
        torch.ones((k,), dtype=torch.bool, device=dev),
        torch.zeros((k,), dtype=torch.bool, device=dev))
    gate = torch.full(score_small.shape[:-1], -1.0, dtype=torch.float32,
                      device=dev)
    return szn_labels(_aug(score_small, gate, e), seen, unseen, fill,
                      int(out_hw[0]), int(out_hw[1]))
