"""VALID convolution with a padding-free input gradient: fc6 (the JAX
package's `ops/conv7x7.py`).

Autograd would differentiate fc6's input as a full convolution of the
zero-padded cotangent: at the 512x512 geometry (17x17 output from a 23x23
input, 7x7 kernel) 83% of that padded area is zeros. `ConvValidMMGrad`
computes the same input gradient without them,

    dx[b, ih, iw, ci] = sum_{dh, dw, co} g[b, ih-dh, iw-dw, co] W[co, ci, dh, dw]

as one dense (B*OH*OW, CO) @ (CO, KH*KW*CI) product (the forward's FLOP
count), rounded once to the input dtype, then a KH*KW-tap overlap-add in
fp32 with one rounding at the end, as the JAX op does. The product runs
through K7 (`ops.pdot.pdot`, fp32 out) under the dot-free mode and through
`torch.matmul` in the compute dtype otherwise, where the JAX package leaves
it to a plain XLA dot. The weight gradient is the standard convolution
weight gradient (cuDNN), as the JAX op keeps XLA's. The mode is read once
per forward and kept for the backward.

The forward is `F.conv2d` (cuDNN), except where `runs_igemm` holds: bf16
input on the card, Cin a multiple of 64, Cout of 256, a 16-byte-aligned
input, and the weight packed. There it is `conv7x7_igemm`, a hand-written
implicit-GEMM kernel on the tensor cores (`csrc/conv7x7_igemm.cu`). The
packed weight (`pack_weight`, made by `weight_for` on the kernel's route:
one pass from the fp32 parameter in place of the cast) is the kernel in
channels_last memory, i.e. the (CO, KH, KW, CI) matrix the kernel reads;
the same matrix is the input gradient's (CO, KH*KW*CI) operand, which the
backward then takes as a view. `conv7x7_igemm_plain` is the kernel's plain
version: the fp32 product of the (dh, dw, ci)-ordered patch matrix and the
packed weight, rounded once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
from zeroshotsemanticsegmentation_tpu_torch.ops.conv1x1 import nhwc_rows
from zeroshotsemanticsegmentation_tpu_torch.ops.dotpolicy import dot_free
from zeroshotsemanticsegmentation_tpu_torch.ops.pdot import pdot

IGEMM_BM = 128         # the kernel's tile of output pixels
IGEMM_BN = 256         # its tile of output channels: Cout's granule
IGEMM_CIN = 64         # input channels a k-step: Cin's granule
_IGEMM_ARGTYPES = [_kernels.P] * 3 + [_kernels.I] * 7 + [_kernels.P]


def igemm_takes(dtype, is_cuda: bool, cin: int, cout: int,
                aligned: bool) -> bool:
    """Whether fc6's forward runs on `conv7x7_igemm`: a bf16 input on the
    card, Cin a multiple of IGEMM_CIN, Cout of IGEMM_BN and the input's
    base 16-byte aligned. Everything else stays `F.conv2d`."""
    return (dtype == torch.bfloat16 and is_cuda and cin % IGEMM_CIN == 0
            and cout % IGEMM_BN == 0 and aligned)


def igemm_route(x: torch.Tensor, cout: int) -> bool:
    """`igemm_takes` for the NCHW input `x` and `cout` output channels."""
    return igemm_takes(x.dtype, x.is_cuda, x.shape[1], cout,
                       x.data_ptr() % 16 == 0)


def pack_weight(w: torch.Tensor, dtype) -> torch.Tensor:
    """The (CO, CI, KH, KW) kernel in `dtype` and channels_last memory: the
    contiguous (CO, KH, KW, CI) matrix `conv7x7_igemm` reads, which
    F.conv2d takes as it stands. One copy kernel (cast and layout in one
    pass) from `w`, differentiable back to it."""
    return w.to(dtype, memory_format=torch.channels_last)


def weight_for(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """`w` in `dtype` as the forward on `x` takes it: packed on the
    kernel's route, the plain cast elsewhere."""
    if igemm_route(x, w.shape[0]):
        return pack_weight(w, dtype)
    return w.to(dtype)


def runs_igemm(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether `conv_valid_mmgrad(x, w)` runs on `conv7x7_igemm`: `x` on
    the kernel's route and `w` packed in its dtype."""
    return (igemm_route(x, w.shape[0]) and w.dtype == x.dtype
            and w.is_contiguous(memory_format=torch.channels_last))


def _geometry(x: torch.Tensor, wp: torch.Tensor):
    b, ci, ih, iw = x.shape
    co, wci, kh, kw = wp.shape
    if wci != ci or kh > ih or kw > iw:
        raise ValueError(f"conv7x7: input {tuple(x.shape)} and packed "
                         f"kernel {tuple(wp.shape)} do not match")
    return b, ci, ih, iw, co, kh, kw


def patches(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """The (B*OH*OW, KH*KW*CI) patch matrix of the NCHW `x`, columns in
    (dh, dw, ci) order: the implicit GEMM's A operand, materialised."""
    b, ci, _, _ = x.shape
    p = x.permute(0, 2, 3, 1).unfold(1, kh, 1).unfold(2, kw, 1)
    # (B, OH, OW, CI, KH, KW) -> (B, OH, OW, KH, KW, CI)
    return p.permute(0, 1, 2, 4, 5, 3).reshape(-1, kh * kw * ci)


def conv7x7_igemm_plain(x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """Plain version of `conv7x7_igemm`: the fp32 product of the patch
    matrix and the packed kernel, rounded once to x's dtype; (B, CO, OH,
    OW) in channels_last memory."""
    b, _, ih, iw, co, kh, kw = _geometry(x, wp)
    km = wp.to(torch.float32).permute(0, 2, 3, 1).reshape(co, -1)
    y = torch.matmul(patches(x.to(torch.float32), kh, kw), km.t())
    return y.to(x.dtype).view(b, ih - kh + 1, iw - kw + 1, co).permute(
        0, 3, 1, 2)


def conv7x7_igemm(x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """The VALID stride-1 convolution of the NCHW `x` with the packed
    kernel `wp` (`pack_weight`), -> (B, CO, OH, OW) in channels_last
    memory: `csrc/conv7x7_igemm.cu` on CUDA tensors (bf16, the shapes
    `igemm_takes` admits, else ValueError), the plain version on CPU
    tensors."""
    b, ci, ih, iw, co, kh, kw = _geometry(x, wp)
    if not x.is_cuda:
        return conv7x7_igemm_plain(x, wp)
    if not (x.dtype == wp.dtype == torch.bfloat16 and wp.device == x.device
            and wp.is_contiguous(memory_format=torch.channels_last)
            and igemm_takes(x.dtype, True, ci, co, x.data_ptr() % 16 == 0)):
        raise ValueError(
            f"conv7x7_igemm takes bf16 NCHW input with Cin % {IGEMM_CIN} and "
            f"a packed kernel with Cout % {IGEMM_BN} on one "
            f"card; got {x.dtype} {tuple(x.shape)} and {wp.dtype} "
            f"{tuple(wp.shape)}")
    xn = x.permute(0, 2, 3, 1)
    if not xn.is_contiguous():
        xn = xn.contiguous()
    oh, ow = ih - kh + 1, iw - kw + 1
    out = torch.empty((b, oh, ow, co), dtype=x.dtype, device=x.device)
    fn = _kernels.function("conv7x7_igemm", "conv7x7_igemm_launch",
                           _IGEMM_ARGTYPES)
    p = _kernels.ptr
    rc = fn(p(xn), p(wp), p(out), b, ih, iw, ci, kh, kw, co,
            _kernels.P(_kernels.stream_handle(x.device)))
    _kernels.check("conv7x7_igemm", rc)
    _kernels.launch_counts["conv7x7_igemm"] += 1
    return out.permute(0, 3, 1, 2)


def _input_grad(g: torch.Tensor, w: torch.Tensor, x_shape, dtype,
                use_pdot: bool) -> torch.Tensor:
    """dx (B, CI, IH, IW) in channels_last memory from g (B, CO, OH, OW)."""
    co, ci, kh, kw = w.shape
    b, _, oh, ow = g.shape
    # (CO, KH*KW*CI): columns in (dh, dw, ci) order, so each tap's slice of
    # the product is a run of CI contiguous values; a view of a packed w
    km = w.permute(0, 2, 3, 1).reshape(co, kh * kw * ci)
    g2 = nhwc_rows(g)
    if use_pdot:
        col = pdot(g2, km, out_dtype=torch.float32).to(dtype)
    else:
        col = torch.matmul(g2, km)
    col = col.view(b, oh, ow, kh, kw, ci)
    dx = torch.zeros((b, x_shape[2], x_shape[3], ci), dtype=torch.float32,
                     device=g.device)
    for dh in range(kh):
        for dw in range(kw):
            dx[:, dh:dh + oh, dw:dw + ow] += col[:, :, :, dh, dw].to(
                torch.float32)
    return dx.to(dtype).permute(0, 3, 1, 2)


class ConvValidMMGrad(torch.autograd.Function):
    """`F.conv2d(x, w)`, stride 1, no padding, with the padding-free input
    gradient (the JAX package's `conv_valid_mmgrad` custom_vjp); the
    forward on `conv7x7_igemm` where `runs_igemm` holds."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.use_pdot = dot_free()
        ctx.save_for_backward(x, w)
        return conv7x7_igemm(x, w) if runs_igemm(x, w) else F.conv2d(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x, w.shape, g)
        if ctx.needs_input_grad[0]:
            dx = _input_grad(g, w, x.shape, x.dtype, ctx.use_pdot)
        return dx, dw


def conv_valid_mmgrad(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NCHW VALID stride-1 convolution of `x` with the (CO, CI, KH, KW)
    kernel `w`, both in the compute dtype (no bias); `weight_for` gives
    `w` the layout the kernel's route takes."""
    return ConvValidMMGrad.apply(x, w)
