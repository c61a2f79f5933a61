"""int8 SZN serving forward, opt-in and approximate (the JAX package's
models/quantized.py).

Every convolution of the FCN-32s forward to the raw heads runs as an
int8 x int8 -> int32 product. The scheme is the standard symmetric dynamic
one, as in the JAX package:

* weights: per-output-channel symmetric scales s_w[o] = max|K[o]| / 127
  (zero scales set to 1), quantised once per call from the fp32 weights;
* activations: one dynamic scale per tensor, s_a = max|a| / 127, computed
  on the device; `round` (half to even), then `clip` to +-127, in the
  activation's dtype (bf16 between layers);
* int32 accumulation, dequantised as o * (s_a * s_w) + b in fp32, cast to
  bf16, ReLU except on the two heads.

The int8 product is `torch._int_mm` over a patch matrix (NHWC, taps in
(kh, kw, c) order), the counterpart of XLA's int8 `conv_general_dilated`
with `preferred_element_type=int32`: a library GEMM, not a port of a Pallas
kernel. On the card it wants M > 16 and K, N multiples of 8, so the patch
matrix and the weights are zero-padded (exact): M to at least 17, K and N
to multiples of 16, which keeps every int8 row 16-byte aligned. No shape is
routed to a floating-point product. The patch matrices are built a chunk of images
at a time, each chunk's within about 1 GiB.

The blocks run on the support-pruned pad-100 geometry (`models.pruned`)
through its `conv_relu` hook: the ring-constant chain and the frame probe
stay fp32, every data-path convolution quantises its ring-padded input.
Unpruned blocks pool with ceil mode; fc6, fc7 and the heads are VALID.
Serving only; not a training path.

On a mesh (`parallel.mesh`) every scale is the one-device tensor's, so
the labels equal the one-device int8 labels (the products are exact in
int32): each activation scale is a MAX all-reduce over 'data' (the rank's
batch rows or its band of rows, with the halo and ring rows its
convolution reads: the bands' union is the one-device tensor); fc7 is
split over 'model' on its input channels, so its input's scale is a MAX
over 'model' too, its per-output-channel weight scale a MAX over 'model',
and its int32 partial products are summed over 'model' before they are
dequantised (its bias added once). fc6, split on its output channels,
needs neither.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import (
    _PAD_CONV1, _VGG_BLOCKS, block_weights)
from zeroshotsemanticsegmentation_tpu_torch.models.pruned import (
    NUM_PRUNED_BLOCKS, plan_blocks, prunable, run_pruned_blocks)
from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, all_reduce_max)

# the largest patch matrix (int8 bytes) built at once
PATCH_CHUNK_BYTES = 1 << 30


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_conv(ai: torch.Tensor, ki: torch.Tensor,
              padding: int = 0) -> torch.Tensor:
    """int8 NHWC activations (B, H, W, C) x int8 OIHW weights (O, C, kh,
    kw) -> int32 NHWC (B, Ho, Wo, O): a stride-1 convolution with `padding`
    zeros on each side, as `torch._int_mm` over the patch matrix."""
    o_ch, c_in, kh, kw = ki.shape
    if padding:
        ai = F.pad(ai, (0, 0, padding, padding, padding, padding))
    b, h, w, c = ai.shape
    if c != c_in:
        raise ValueError(f"int8_conv: {c} input channels, kernel takes "
                         f"{c_in}")
    ho, wo = h - kh + 1, w - kw + 1
    k = kh * kw * c
    kp, np_ = _round_up(k, 16), _round_up(o_ch, 16)
    wmat = F.pad(ki.permute(0, 2, 3, 1).reshape(o_ch, k),
                 (0, kp - k, 0, np_ - o_ch))              # (Np, Kp)
    out = torch.empty((b, ho, wo, o_ch), dtype=torch.int32, device=ai.device)
    per_image = ho * wo * kp
    step = max(1, PATCH_CHUNK_BYTES // per_image)
    for i in range(0, b, step):
        x = ai[i:i + step]
        n = x.shape[0]
        if kh == kw == 1:
            rows = x.reshape(n * ho * wo, c)
        else:  # (n, ho, wo, c, kh, kw) view -> (M, kh*kw*c) rows
            rows = x.unfold(1, kh, 1).unfold(2, kw, 1).permute(
                0, 1, 2, 4, 5, 3).reshape(n * ho * wo, k)
        m = rows.shape[0]
        mp = max(m, 17)
        if kp != k or mp != m:
            rows = F.pad(rows, (0, kp - k, 0, mp - m))
        res = torch._int_mm(rows.contiguous(), wmat.t())   # (Mp, Np)
        out[i:i + n] = res[:m, :o_ch].reshape(n, ho, wo, o_ch)
    return out


def _qconv(a: torch.Tensor, k: torch.Tensor, b: torch.Tensor, *,
           padding: int = 0, relu: bool = True,
           dtype=torch.bfloat16, mesh=None,
           row_parallel: bool = False) -> torch.Tensor:
    """int8 convolution of NHWC `a` with the OIHW fp32 kernel `k` and bias
    `b`, with a dynamic activation scale and per-channel weight scales ->
    NHWC in `dtype`. The quantise and dequantise arithmetic follows the
    JAX `_qconv` step for step (the activation's scale and rounding in its
    own dtype: integers up to 127 are exact in bf16).

    `mesh`: the activation scale is the maximum over 'data'. With
    `row_parallel` the layer's input channels are split over 'model' (fc7):
    the activation and weight scales are maxima over 'model' too, and the
    int32 products are summed over 'model' before dequantising."""
    k = k.to(torch.float32)
    model = row_parallel and mesh is not None and mesh.model_size > 1
    over = (DATA_AXIS, MODEL_AXIS) if model else (DATA_AXIS,)
    amax_w = torch.amax(torch.abs(k), dim=(1, 2, 3))
    if model:
        amax_w = all_reduce_max(amax_w, mesh, (MODEL_AXIS,))
    s_w = amax_w / 127.0
    s_w = torch.where(s_w == 0, torch.ones_like(s_w), s_w)
    ki = torch.round(k / s_w[:, None, None, None]).to(torch.int8)
    s_a = (all_reduce_max(torch.amax(torch.abs(a)), mesh, over)
           / 127.0).to(torch.float32)
    s_a = torch.where(s_a == 0, torch.ones_like(s_a), s_a)
    ai = torch.clamp(torch.round(a / s_a.to(a.dtype)), -127,
                     127).to(torch.int8)
    o = int8_conv(ai, ki, padding)
    if model:
        mesh.all_reduce(o, (MODEL_AXIS,))
    o = (o.to(torch.float32) * (s_a * s_w)
         + b.to(torch.float32)).to(dtype)
    return torch.relu(o) if relu else o


def _nchw_hook(mesh):
    """`run_pruned_blocks`' conv_relu hook: the VALID int8 conv + ReLU of
    its NCHW data path (scales over `mesh`'s 'data' axis)."""
    def hook(a: torch.Tensor, k: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
        return _qconv(a.permute(0, 2, 3, 1), k, b,
                      mesh=mesh).permute(0, 3, 1, 2)
    return hook


def _max_pool_ceil(h: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool with ceil mode on NHWC."""
    return F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2,
                        ceil_mode=True).permute(0, 2, 3, 1)


def quantized_raw_forward(model_or_state, x: torch.Tensor, *, mesh=None,
                          bands=None):
    """int8 forward to the raw 1/32-resolution heads -> (f_small (B, h, w,
    C), s_small (B, h, w, 2)), bf16.

    `model_or_state`: an FCN32s or its `state_dict` (fp32 weights, the
    reference's key names). x: (B, H, W, 3) fp32 BGR mean-subtracted
    images. The geometry is FCN32s mode="raw"'s (pad 100, ceil pools, VALID
    fc6); the leading blocks run support-pruned where `plan_blocks` allows
    it, as on the fp path.

    `mesh`: x is this rank's rows of the batch (or, with `bands`, the whole
    images) and the state its shards (fc6 and fc7 split over 'model');
    `bands` (`parallel.spatial.Bands`): this rank computes its band of rows
    and gets the whole heads. The scales are the one-device ones (above).
    """
    sd: Mapping[str, torch.Tensor] = (
        model_or_state.state_dict() if isinstance(model_or_state,
                                                  torch.nn.Module)
        else model_or_state)

    def wb(name):
        return sd[f"{name}.weight"], sd[f"{name}.bias"]

    if bands is not None:
        mesh = bands.mesh
    _, in_h, in_w, _ = x.shape
    x = x.to(torch.float32)
    start = 0
    h = x
    nb = None
    if bands is not None:
        nb = bands.plan.pruned
    elif prunable(in_h, in_w):
        nb = next((d for d in range(NUM_PRUNED_BLOCKS, 2, -1)
                   if plan_blocks(in_h, in_w, _PAD_CONV1, d)), None)
    if nb is not None:
        h = run_pruned_blocks(block_weights(wb, nb), x, _PAD_CONV1,
                              torch.float32, conv_relu=_nchw_hook(mesh),
                              band=bands)
        h = h.permute(0, 2, 3, 1)
        if bands is not None:
            h = bands.settle(h, nb, dim=1)
        start = nb
    for bi in range(start, len(_VGG_BLOCKS)):
        on_bands = bands is not None and bands.conv_on_bands(bi)
        for ci, (name, _) in enumerate(_VGG_BLOCKS[bi]):
            if on_bands:  # rows from the neighbours, zero columns
                h = _qconv(F.pad(bands.rows3x3(h, 1), (0, 0, 1, 1)),
                           *wb(name), mesh=mesh)
                continue
            pad = _PAD_CONV1 if (bi == 0 and ci == 0) else 1
            h = _qconv(h, *wb(name), padding=pad, mesh=mesh)
        h = _max_pool_ceil(h)
        if bands is not None:
            h = bands.settle(h, bi + 1, dim=1)
    if bands is not None and bands.kept(5):
        h = bands.fc6_input(h, dim=1)
    h = _qconv(h, *wb("fc6"), mesh=mesh)
    h = _qconv(h, *wb("fc7"), mesh=mesh, row_parallel=True)
    f_small = _qconv(h, *wb("score_fr"), relu=False, mesh=mesh)
    s_small = _qconv(h, *wb("seenmask_score"), relu=False, mesh=mesh)
    if bands is not None:
        f_small = bands.whole(f_small, 6, dim=1)
        s_small = bands.whole(s_small, 6, dim=1)
    return f_small, s_small
