"""relu(conv(a, w) + b): the FCN trunk's 3x3 convolutions with their bias
and ReLU (every VGG conv outside the fused block-1 kernel, and those of
the frame probe of `models.pruned`).

* On the card, where autograd would not record the call (grad mode off,
  or none of `a`, `w`, `b` requires grad): one cuDNN call,
  `torch.cudnn_convolution_relu`, which adds the bias in fp32 in the
  convolution's epilogue and applies the ReLU before its one store in the
  compute dtype. It has no backward.
* Everywhere else (the CPU, and every forward that records a backward:
  stage 1, `remat`): the three ops, F.conv2d with its bias, then
  `torch.relu`.

The fused call takes the weight in channels_last memory, as cuDNN runs a
channels_last input (the data path's, from the ring pads on); its output
is channels_last. Each call is one `model.conv` span (`utils.profiling`,
CUDA events on the card) with the work `flops` (2 x B x Ho x Wo x Cout x
Cin x kh x kw) and `fused` (1 on the cuDNN call, 0 on the three ops), and
counts into `_kernels.launch_counts` as `conv_fused` or `conv_plain`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import span


def _on_card(a: torch.Tensor) -> bool:
    return a.is_cuda


def fused_takes(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether `conv_bias_relu` makes the one cuDNN call: `a` on the card
    and nothing for autograd to record."""
    return _on_card(a) and not (torch.is_grad_enabled() and (
        a.requires_grad or w.requires_grad or b.requires_grad))


def conv_bias_relu(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   dtype, padding=0) -> torch.Tensor:
    """relu(conv2d(a, w, padding) + b) in `dtype`: NCHW `a` (any memory
    format), OIHW `w` and (Cout,) `b` in any dtype, `padding` an int or
    an (h, w) pair; stride and dilation 1."""
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    n, _, ih, iw = a.shape
    co, ci, kh, kw = w.shape
    fused = fused_takes(a, w, b)
    with span("model.conv", device=True, flops=2 * n * co * ci * kh * kw
              * (ih + 2 * ph - kh + 1) * (iw + 2 * pw - kw + 1),
              fused=int(fused)):
        if fused:
            _kernels.launch_counts["conv_fused"] += 1
            return torch.cudnn_convolution_relu(
                a, w.to(dtype, memory_format=torch.channels_last),
                b.to(dtype), (1, 1), (ph, pw), (1, 1), 1)
        _kernels.launch_counts["conv_plain"] += 1
        return torch.relu(F.conv2d(a, w.to(dtype), b.to(dtype),
                                   padding=padding))
