"""FCN-32s with dual heads (reference models.py:27-193), as an nn.Module.

A VGG16 stack with the pad-100 / crop-19 geometry, fc6/fc7 as convolutions
with channel dropout, a `score_fr` head into the joint embedding space and a
2-channel `seenmask_score` head. Submodule names equal the reference's
(`conv1_1` ... `seenmask_score`, plus the trainable `seenmask_upscore`), so
`state_dict` keys match it.

As in the JAX package: the x32 FCN upscore is a fixed bilinear function
(`ops.bilinear.upsample_bilinear_cropped`), the seenmask upscore a real
ConvTranspose2d weight; blocks 1-4 run support-pruned (`models.pruned`) when
`prune_pad` is set, and block 1 through the fused kernel when `fused_block1`
is set. Parameters stay fp32; convolutions run in `dtype`. The module is
built on the card unless `device="cpu"` is passed.

`forward(..., train=True, generator=g)` is the training forward: channel
dropout after fc6 and fc7 (flax `nn.Dropout(broadcast_dims=(1, 2))`: whole
channels per sample, kept ones scaled by 1/(1 - rate)) draws its masks from
the explicit `torch.Generator` `g`; without `train` there is no dropout.

Public layouts are NHWC: images (B, H, W, 3) in, heads (B, h, w, C) out.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from zeroshotsemanticsegmentation_tpu_torch import resolve_device
from zeroshotsemanticsegmentation_tpu_torch.models.pruned import (
    NUM_PRUNED_BLOCKS, plan_blocks, prunable, run_pruned_blocks)
from zeroshotsemanticsegmentation_tpu_torch.ops.bilinear import (
    bilinear_upsampling_kernel, upsample_bilinear_cropped,
    upscore_conv_transpose_cropped)

_PAD_CONV1 = 100
_UPSAMPLE_STRIDE = 32
_UPSAMPLE_KERNEL = 64
_CROP_OFFSET = 19

_VGG_BLOCKS = (
    (("conv1_1", 64), ("conv1_2", 64)),
    (("conv2_1", 128), ("conv2_2", 128)),
    (("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256)),
    (("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512)),
    (("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)),
)

# reference module names holding Conv2d weight + bias (models.py:43-98)
CONV_MODULES = (
    "conv1_1", "conv1_2",
    "conv2_1", "conv2_2",
    "conv3_1", "conv3_2", "conv3_3",
    "conv4_1", "conv4_2", "conv4_3",
    "conv5_1", "conv5_2", "conv5_3",
    "fc6", "fc7", "score_fr", "seenmask_score",
)


class FCN32s(nn.Module):
    RAW_HEADS = True  # exposes mode="raw" for the fused serving kernel

    def __init__(self, num_classes: int, *, dtype=torch.float32,
                 dropout_rate: float = 0.5, channel_scale: float = 1.0,
                 prune_pad: bool = True, fused_block1: bool = False,
                 generator: torch.Generator | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.num_classes = num_classes
        self.dtype = dtype
        self.channel_scale = channel_scale
        self.prune_pad = prune_pad
        self.fused_block1 = fused_block1
        in_f = 3
        for blk in _VGG_BLOCKS:
            for name, features in blk:
                f = self.width(features)
                self.add_module(name, nn.Conv2d(in_f, f, 3, device=device))
                in_f = f
        self.fc6 = nn.Conv2d(in_f, self.width(4096), 7, device=device)
        self.fc7 = nn.Conv2d(self.width(4096), self.width(4096), 1,
                             device=device)
        self.score_fr = nn.Conv2d(self.width(4096), num_classes, 1,
                                  device=device)
        self.seenmask_score = nn.Conv2d(self.width(4096), 2, 1, device=device)
        self.seenmask_upscore = nn.ConvTranspose2d(
            2, 2, _UPSAMPLE_KERNEL, stride=_UPSAMPLE_STRIDE, bias=False,
            device=device)
        self.dropout_rate = dropout_rate
        self.reset_parameters(generator)

    def width(self, f: int) -> int:
        return max(8, int(f * self.channel_scale))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """LeCun-normal conv kernels and zero biases (the JAX package's
        initializers), drawn from `generator`; the seenmask upscore starts
        at its bilinear init (reference models.py:102-112)."""
        for name in CONV_MODULES:
            conv = getattr(self, name)
            fan_in = conv.weight[0].numel()
            w = torch.randn(conv.weight.shape, generator=generator)
            conv.weight.copy_(w / math.sqrt(fan_in))
            conv.bias.zero_()
        up = bilinear_upsampling_kernel(2, _UPSAMPLE_KERNEL)
        self.seenmask_upscore.weight.copy_(
            torch.from_numpy(np.ascontiguousarray(up.transpose(2, 3, 0, 1))))

    def _conv(self, name: str, h: torch.Tensor, padding: int = 0):
        conv = getattr(self, name)
        return F.conv2d(h, conv.weight.to(self.dtype),
                        conv.bias.to(self.dtype), padding=padding)

    def _blocks(self, x: torch.Tensor) -> torch.Tensor:
        """VGG blocks 1-5 on the (B, H, W, 3) image -> NCHW pool5."""
        in_h, in_w = x.shape[1], x.shape[2]
        start = 0
        h = None
        if self.prune_pad and prunable(in_h, in_w):
            for nb in range(NUM_PRUNED_BLOCKS, 2, -1):
                if plan_blocks(in_h, in_w, _PAD_CONV1, nb):
                    kbs = [[(getattr(self, n).weight, getattr(self, n).bias)
                            for n, _ in _VGG_BLOCKS[bi]] for bi in range(nb)]
                    h = run_pruned_blocks(kbs, x, _PAD_CONV1, self.dtype,
                                          self.fused_block1)
                    start = nb
                    break
        if h is None:
            h = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
        for bi in range(start, len(_VGG_BLOCKS)):
            for ci, (name, _) in enumerate(_VGG_BLOCKS[bi]):
                pad = _PAD_CONV1 if (bi == 0 and ci == 0) else 1
                h = torch.relu(self._conv(name, h, pad))
            h = F.max_pool2d(h, 2, 2, ceil_mode=True)
        return h

    def _dropout(self, h: torch.Tensor, train: bool,
                 generator: torch.Generator | None) -> torch.Tensor:
        """Channel dropout on NCHW `h`: one keep draw per (sample, channel)
        from `generator`, kept channels scaled by 1/(1 - rate)."""
        rate = self.dropout_rate
        if not train or rate == 0.0:
            return h
        if rate >= 1.0:
            return torch.zeros_like(h)
        if generator is None:
            raise ValueError("FCN32s: a training forward with dropout needs "
                             "an explicit torch.Generator")
        keep = 1.0 - rate
        mask = torch.rand((h.shape[0], h.shape[1], 1, 1), generator=generator,
                          device=h.device) < keep
        return torch.where(mask, h / keep, torch.zeros_like(h))

    def forward(self, x: torch.Tensor, *, mode: str = "both",
                train: bool = False,
                generator: torch.Generator | None = None):
        """mode in {fcn, seenmask, both, raw}; 'raw' returns the 1/32-res
        heads (B, h, w, C) and (B, h, w, 2) for the fused serving kernel.
        The upsampled heads are fp32 (B, H, W, C). `train` turns on the
        channel dropout, drawn from `generator` (on the input's device)."""
        if mode not in ("fcn", "seenmask", "both", "raw"):
            raise ValueError(f"unexpected forward mode: {mode!r}")
        in_h, in_w = x.shape[1], x.shape[2]
        h = self._blocks(x)
        h = self._dropout(torch.relu(self._conv("fc6", h)), train, generator)
        h = self._dropout(torch.relu(self._conv("fc7", h)), train, generator)
        # only the heads the mode returns are computed
        f_small = s_small = None
        if mode != "seenmask":
            f_small = self._conv("score_fr", h).permute(0, 2, 3, 1)
        if mode != "fcn":
            s_small = self._conv("seenmask_score", h).permute(0, 2, 3, 1)
        if mode == "raw":
            return f_small, s_small

        def up(s):
            return upsample_bilinear_cropped(
                s, stride=_UPSAMPLE_STRIDE, kernel_size=_UPSAMPLE_KERNEL,
                crop_offset=_CROP_OFFSET, out_h=in_h, out_w=in_w)

        def up_seen(s):
            return upscore_conv_transpose_cropped(
                s, self.seenmask_upscore.weight, stride=_UPSAMPLE_STRIDE,
                crop_offset=_CROP_OFFSET, out_h=in_h, out_w=in_w)

        if mode == "fcn":
            return up(f_small)
        if mode == "seenmask":
            return up_seen(s_small)
        return up(f_small), up_seen(s_small)
