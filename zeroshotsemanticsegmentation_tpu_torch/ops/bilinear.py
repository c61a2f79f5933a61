"""Fixed bilinear x-stride upsampling and the trained seenmask upscore.

The reference upsamples FCN scores with a ConvTranspose2d(kernel=64,
stride=32, bias=False) initialized to a separable bilinear filter and cropped
at offset 19 (reference models.py:11-24, 93-98, 145-151). That fixed map is a
separable linear operator: along each axis, an (out_len, in_len)
interpolation matrix with at most two nonzero taps per row. Here it is
evaluated as two fp32 matrix products (rows, then columns), the form the JAX
package's `upsample_bilinear_cropped` is bit-identical to.

`upscore_conv_transpose_cropped` is the TRAINED seenmask upscore (the
reference's stage 2 optimizes it): a real transposed convolution with an
arbitrary kernel, then the same crop.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from zeroshotsemanticsegmentation_tpu_torch import device_const


def bilinear_filter_1d(kernel_size: int) -> np.ndarray:
    """1-D bilinear interpolation filter, reference models.py:11-24."""
    factor = (kernel_size + 1) // 2
    if kernel_size % 2 == 1:
        center = factor - 1.0
    else:
        center = factor - 0.5
    og = np.arange(kernel_size, dtype=np.float64)
    return 1.0 - np.abs(og - center) / factor


def bilinear_upsampling_kernel(channels: int, kernel_size: int,
                               dtype=np.float32) -> np.ndarray:
    """(K, K, C, C) HWIO transposed-conv kernel, diagonal across channels
    (reference get_upsampling_weight). `.transpose(2, 3, 0, 1)` gives the
    (C, C, K, K) weight of a torch ConvTranspose2d."""
    f = bilinear_filter_1d(kernel_size)
    filt2 = np.outer(f, f)
    w = np.zeros((kernel_size, kernel_size, channels, channels), dtype=dtype)
    idx = np.arange(channels)
    w[:, :, idx, idx] = filt2[:, :, None]
    return w


@functools.lru_cache(maxsize=128)
def upsample_matrix(in_len: int, stride: int, kernel_size: int,
                    crop_offset: int, out_len: int) -> np.ndarray:
    """(out_len, in_len) matrix M with M @ x == conv_transpose(x)[crop:crop+out].

    conv_transpose (zero padding, full output (in_len-1)*stride + kernel_size):
        y[o] = sum_i x[i] * f[o - stride*i]  for 0 <= o - stride*i < K.
    """
    full = (in_len - 1) * stride + kernel_size
    if crop_offset + out_len > full:
        raise ValueError(
            f"crop [{crop_offset}:{crop_offset + out_len}] exceeds "
            f"transposed-conv output length {full} (in_len={in_len}, "
            f"stride={stride}, K={kernel_size})")
    f = bilinear_filter_1d(kernel_size)
    o = np.arange(out_len, dtype=np.int64)[:, None] + crop_offset
    i = np.arange(in_len, dtype=np.int64)[None, :]
    taps = o - stride * i
    valid = (taps >= 0) & (taps < kernel_size)
    m = np.where(valid, f[np.clip(taps, 0, kernel_size - 1)], 0.0)
    m = m.astype(np.float32)
    m.setflags(write=False)  # cached: must stay immutable
    return m


def upsample_bilinear_cropped(x: torch.Tensor, *, stride: int,
                              kernel_size: int, crop_offset: int,
                              out_h: int, out_w: int,
                              rows: tuple | None = None) -> torch.Tensor:
    """Fixed bilinear x-stride upsample + crop of a (B, h, w, C) map -> fp32
    (B, out_h, out_w, C), as two interpolation-matrix products; with `rows`
    = (r0, r1) only output rows [r0, r1)."""
    x = x.to(torch.float32)

    def matrix(in_len: int, out_len: int) -> torch.Tensor:
        args = (in_len, stride, kernel_size, crop_offset, out_len)
        return device_const(("upsample_matrix", *args),
                            lambda: upsample_matrix(*args).copy(), x.device)

    mh, mw = matrix(x.shape[1], out_h), matrix(x.shape[2], out_w)
    if rows is not None:
        mh = mh[rows[0]:rows[1]]
    y = torch.einsum("oh,bhwc->bowc", mh, x)
    return torch.einsum("pw,bowc->bopc", mw, y)


def upscore_conv_transpose_cropped(x: torch.Tensor, weight: torch.Tensor, *,
                                   stride: int, crop_offset: int,
                                   out_h: int, out_w: int,
                                   rows: tuple | None = None
                                   ) -> torch.Tensor:
    """TRAINED-upscore upsample: ConvTranspose2d with `weight` (Cin, Cout,
    K, K), the torch layout, no bias, then the reference crop.

    x: (B, h, w, Cin) -> fp32 (B, out_h, out_w, Cout). Equal to
    `upsample_bilinear_cropped` when `weight` is the bilinear init. With
    `rows` = (r0, r1) only output rows [r0, r1), from the input rows that
    reach them."""
    kh, kw = weight.shape[2], weight.shape[3]
    full_h = (x.shape[1] - 1) * stride + kh
    full_w = (x.shape[2] - 1) * stride + kw
    if crop_offset + out_h > full_h or crop_offset + out_w > full_w:
        raise ValueError(
            f"crop [{crop_offset}:+{out_h}x{out_w}] exceeds transposed-conv "
            f"output {full_h}x{full_w}")
    top, n_rows = crop_offset, out_h
    if rows is not None:
        # output row o takes input rows i with 0 <= o - stride * i < kh
        r0, r1 = rows
        i0 = max(0, -(-(crop_offset + r0 - kh + 1) // stride))
        i1 = min(x.shape[1], (crop_offset + r1 - 1) // stride + 1)
        x = x[:, i0:i1]
        top, n_rows = crop_offset + r0 - stride * i0, r1 - r0
    y = F.conv_transpose2d(x.to(torch.float32).permute(0, 3, 1, 2),
                           weight.to(torch.float32), stride=stride)
    y = y[:, :, top:top + n_rows, crop_offset:crop_offset + out_w]
    return y.permute(0, 2, 3, 1)
