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
is set. fc6 runs through `ops.conv7x7.conv_valid_mmgrad` (its input
gradient is one matmul and an overlap-add; in bf16 on the card its forward
is the implicit-GEMM kernel), fc7 and both heads through
`ops.conv1x1.conv1x1_mmwgrad` (weight gradient on K7 under the dot-free
mode); their biases are added in the compute dtype. Every 3x3 VGG conv
with its bias and ReLU is `ops.conv_relu.conv_bias_relu`: one cuDNN call
on the card where nothing records a backward, else the three ops.
Parameters stay fp32; convolutions run in `dtype`. The module is built on
the card unless `device="cpu"` is passed.

`forward(..., train=True, generator=g)` is the training forward: channel
dropout after fc6 and fc7 (flax `nn.Dropout(broadcast_dims=(1, 2))`: whole
channels per sample, kept ones scaled by 1/(1 - rate)) draws its masks from
the explicit `torch.Generator` `g`; without `train` there is no dropout.
`frozen_trunk=True` runs blocks 1-5, fc6 and fc7 without autograd (stage
2's frozen backbone: no backbone backward is built, and block 1 takes its
no-gradient kernel).

`remat=True` rematerializes the conv blocks in the backward, with the JAX
modules' segments: the support-pruned run is one segment (its
`jax.checkpoint`), each later block one more (`nn.remat`); a segment keeps
only its input for the backward and runs its forward again there
(`torch.utils.checkpoint`, non-reentrant). Only where autograd records:
serving, eval, the frozen trunk and the height-sharded bands are unchanged.
No random draw lies inside a segment (dropout follows fc6), so the RNG
state is not stashed.

On a mesh (`parallel.mesh.shard_model` sets `mesh` and splits fc6 / fc7)
the forward runs this rank's rows with fc6 on its output-channel shard
(input through `copy_to_model`: its gradient is all-reduced over 'model')
and fc7 on its input-channel shard (product all-reduced over 'model', then
the replicated bias, once). Dropout draws the GLOBAL (batch, channel) mask
from the generator on every rank and keeps this rank's rows and channels,
so a mesh step draws the masks of the one-device step.

Public layouts are NHWC: images (B, H, W, 3) in, heads (B, h, w, C) out.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from zeroshotsemanticsegmentation_tpu_torch import resolve_device
from zeroshotsemanticsegmentation_tpu_torch.models.pruned import (
    NUM_PRUNED_BLOCKS, plan_blocks, prunable, run_pruned_blocks)
from zeroshotsemanticsegmentation_tpu_torch.ops.bilinear import (
    bilinear_upsampling_kernel, upsample_bilinear_cropped,
    upscore_conv_transpose_cropped)
from zeroshotsemanticsegmentation_tpu_torch.ops.conv1x1 import (
    conv1x1_mmwgrad)
from zeroshotsemanticsegmentation_tpu_torch.ops.conv7x7 import (
    conv_valid_mmgrad, runs_igemm, weight_for)
from zeroshotsemanticsegmentation_tpu_torch.ops.conv_relu import (
    conv_bias_relu)
from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
    copy_to_model, reduce_from_model)
from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import span

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


def block_weights(wb, num_blocks: int) -> list:
    """[[(weight, bias), ...] per block] of the first `num_blocks` VGG
    blocks, the form `run_pruned_blocks` takes; `wb(name)` gives a conv's
    (weight, bias)."""
    return [[wb(name) for name, _ in _VGG_BLOCKS[bi]]
            for bi in range(num_blocks)]


class VGGTrunk(nn.Module):
    """What FCN-32s and FCN-8s share: the VGG16 convolutions, fc6 / fc7 with
    their channel dropout, and the `score_fr` / `seenmask_score` heads, with
    the reference's module names. A subclass adds its upsampling heads, sets
    `PRUNED_DEPTH` (the deepest support-pruned run it takes) and calls
    `reset_parameters`."""

    PRUNED_DEPTH = NUM_PRUNED_BLOCKS

    def __init__(self, num_classes: int, *, dtype=torch.float32,
                 dropout_rate: float = 0.5, channel_scale: float = 1.0,
                 remat: bool = False, prune_pad: bool = True,
                 fused_block1: bool = False,
                 device: str | torch.device = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.num_classes = num_classes
        self.dtype = dtype
        self.channel_scale = channel_scale
        self.remat = remat
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
        self.dropout_rate = dropout_rate
        self.mesh = None  # set by parallel.mesh.shard_model

    def width(self, f: int) -> int:
        return max(8, int(f * self.channel_scale))

    @torch.no_grad()
    def _reset_convs(self, generator: torch.Generator | None) -> None:
        """LeCun-normal conv kernels and zero biases (the JAX package's
        initializers), drawn from `generator` in `CONV_MODULES` order."""
        for name in CONV_MODULES:
            conv = getattr(self, name)
            fan_in = conv.weight[0].numel()
            w = torch.randn(conv.weight.shape, generator=generator)
            conv.weight.copy_(w / math.sqrt(fan_in))
            conv.bias.zero_()

    def _fc(self, name: str, h: torch.Tensor) -> torch.Tensor:
        """fc6 (7x7) or a 1x1 layer (fc7 and the heads) through its
        matmul-gradient op, + bias in the compute dtype; on a mesh fc6 and
        fc7 are its TP layers. fc6's product is the `model.fc6` span
        (`utils.profiling`), counting the operations it is given and, as
        `igemm` (1 or 0), whether it ran on the implicit-GEMM kernel
        (`ops.conv7x7.runs_igemm`)."""
        conv = getattr(self, name)
        mesh = self.mesh
        if name == "fc6":
            if mesh is not None:
                h = copy_to_model(h, mesh)
            w = weight_for(h, conv.weight, self.dtype)
            co, ci, kh, kw = w.shape
            b, _, ih, iw = h.shape
            with span("model.fc6", device=True, flops=2 * b * co * ci * kh
                      * kw * (ih - kh + 1) * (iw - kw + 1),
                      igemm=int(runs_igemm(h, w))):
                y = conv_valid_mmgrad(h, w)
        else:
            y = conv1x1_mmwgrad(h, conv.weight.to(self.dtype))
        if mesh is not None and name == "fc7":
            y = reduce_from_model(y, mesh)
        return y + conv.bias.to(self.dtype)[:, None, None]

    def _weight_bias(self, name: str):
        conv = getattr(self, name)
        return conv.weight, conv.bias

    def _segment(self, fn, *args):
        """fn(*args), rematerialized in the backward when `remat` is set
        and autograd records."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(*args)

    def _block(self, h: torch.Tensor, bi: int, bands=None) -> torch.Tensor:
        """VGG block `bi` (its convs + ReLU, then the ceil-mode pool) on
        NCHW `h`; with `bands` on this rank's rows."""
        on_bands = bands is not None and bands.conv_on_bands(bi)
        for ci, (name, _) in enumerate(_VGG_BLOCKS[bi]):
            if on_bands:  # rows from the neighbours, zero columns
                h = conv_bias_relu(bands.rows3x3(h, 2),
                                   *self._weight_bias(name), self.dtype,
                                   (0, 1))
                continue
            pad = _PAD_CONV1 if (bi == 0 and ci == 0) else 1
            h = conv_bias_relu(h, *self._weight_bias(name), self.dtype, pad)
        h = F.max_pool2d(h, 2, 2, ceil_mode=True)
        if bands is not None:
            h = bands.settle(h, bi + 1, dim=2)
        return h

    def _blocks(self, x: torch.Tensor, bands=None) -> dict:
        """VGG blocks 1-5 on the (B, H, W, 3) image -> {block index: NCHW
        pool output} for every block it materialises: the last block of
        the support-pruned run (at most `PRUNED_DEPTH` deep) and each block
        after it. With `bands` (`parallel.spatial.Bands`) each is this
        rank's band of rows, or the whole array from the plan's `depth`
        on. Without bands, the pruned run and each later block are the
        `remat` segments."""
        in_h, in_w = x.shape[1], x.shape[2]
        pools = {}
        start = 0
        h = None
        if bands is not None:
            nb = bands.plan.pruned
            h = bands.settle(run_pruned_blocks(
                block_weights(self._weight_bias, nb), x, _PAD_CONV1,
                self.dtype, self.fused_block1, band=bands), nb, dim=2)
            start = nb
            pools[nb - 1] = h
        elif self.prune_pad and prunable(in_h, in_w):
            for nb in range(self.PRUNED_DEPTH, 2, -1):
                if plan_blocks(in_h, in_w, _PAD_CONV1, nb):
                    h = self._segment(
                        run_pruned_blocks,
                        block_weights(self._weight_bias, nb), x,
                        _PAD_CONV1, self.dtype, self.fused_block1)
                    start = nb
                    pools[nb - 1] = h
                    break
        if h is None:
            h = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
        for bi in range(start, len(_VGG_BLOCKS)):
            h = (self._block(h, bi, bands) if bands is not None
                 else self._segment(self._block, h, bi))
            pools[bi] = h
        return pools

    def _dropout(self, h: torch.Tensor, train: bool,
                 generator: torch.Generator | None,
                 split_channels: bool = False) -> torch.Tensor:
        """Channel dropout on NCHW `h`: one keep draw per (sample, channel)
        from `generator`, kept channels scaled by 1/(1 - rate). On a mesh
        the draw covers the global batch (and, with `split_channels`, all
        model ranks' channels) and this rank's part of it is kept."""
        rate = self.dropout_rate
        if not train or rate == 0.0:
            return h
        if rate >= 1.0:
            return torch.zeros_like(h)
        if generator is None:
            raise ValueError(f"{type(self).__name__}: a training forward "
                             "with dropout needs an explicit torch.Generator")
        keep = 1.0 - rate
        b, c = h.shape[0], h.shape[1]
        mesh = self.mesh
        if mesh is None:
            mask = torch.rand((b, c, 1, 1), generator=generator,
                              device=h.device) < keep
        else:
            ms = mesh.model_size if split_channels else 1
            mr = mesh.model_rank if split_channels else 0
            mask = torch.rand((b * mesh.data_size, c * ms, 1, 1),
                              generator=generator, device=h.device) < keep
            mask = mask[mesh.data_rank * b:(mesh.data_rank + 1) * b,
                        mr * c:(mr + 1) * c]
        return torch.where(mask, h / keep, torch.zeros_like(h))

    def _trunk(self, x: torch.Tensor, train: bool,
               generator: torch.Generator | None, frozen: bool = False,
               bands=None):
        """Blocks 1-5, fc6 and fc7 with their dropout -> (NCHW fc7 output,
        the pools of `_blocks`); `frozen` runs it without autograd. With
        `bands` (serving only) the output is this rank's band when fc6 runs
        on bands, else whole."""
        if bands is not None and train:
            raise ValueError("the height-sharded forward serves; it does "
                             "not train")
        with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
            pools = self._blocks(x, bands)
            h = pools[4]
            if bands is not None and bands.kept(5):
                h = bands.fc6_input(h, dim=2)
            h = self._dropout(torch.relu(self._fc("fc6", h)), train,
                              generator, split_channels=True)
            h = self._dropout(torch.relu(self._fc("fc7", h)), train,
                              generator)
        return h, pools


class FCN32s(VGGTrunk):
    RAW_HEADS = True  # exposes mode="raw" for the fused serving kernel

    def __init__(self, num_classes: int, *, dtype=torch.float32,
                 dropout_rate: float = 0.5, channel_scale: float = 1.0,
                 remat: bool = False, prune_pad: bool = True,
                 fused_block1: bool = False,
                 generator: torch.Generator | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__(num_classes, dtype=dtype, dropout_rate=dropout_rate,
                         channel_scale=channel_scale, remat=remat,
                         prune_pad=prune_pad, fused_block1=fused_block1,
                         device=device)
        self.seenmask_upscore = nn.ConvTranspose2d(
            2, 2, _UPSAMPLE_KERNEL, stride=_UPSAMPLE_STRIDE, bias=False,
            device=self.fc6.weight.device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """The convolutions' init from `generator`; the seenmask upscore
        starts at its bilinear init (reference models.py:102-112)."""
        self._reset_convs(generator)
        up = bilinear_upsampling_kernel(2, _UPSAMPLE_KERNEL)
        self.seenmask_upscore.weight.copy_(
            torch.from_numpy(np.ascontiguousarray(up.transpose(2, 3, 0, 1))))

    def forward(self, x: torch.Tensor, *, mode: str = "both",
                train: bool = False,
                generator: torch.Generator | None = None,
                frozen_trunk: bool = False, bands=None):
        """mode in {fcn, seenmask, both, raw}; 'raw' returns the 1/32-res
        heads (B, h, w, C) and (B, h, w, 2) for the fused serving kernel.
        The upsampled heads are fp32 (B, H, W, C). `train` turns on the
        channel dropout, drawn from `generator` (on the input's device).
        `frozen_trunk` runs everything before the heads without autograd.
        `bands` (`parallel.spatial.Bands`, mode 'raw' only): this rank
        computes its rows and gets the whole raw heads."""
        if mode not in ("fcn", "seenmask", "both", "raw"):
            raise ValueError(f"unexpected forward mode: {mode!r}")
        if bands is not None and mode != "raw":
            raise ValueError("FCN32s: the height-sharded forward returns "
                             "the raw heads (mode='raw')")
        in_h, in_w = x.shape[1], x.shape[2]
        h, _ = self._trunk(x, train, generator, frozen_trunk, bands)
        # only the heads the mode returns are computed
        f_small = s_small = None
        if mode != "seenmask":
            f_small = self._fc("score_fr", h).permute(0, 2, 3, 1)
        if mode != "fcn":
            s_small = self._fc("seenmask_score", h).permute(0, 2, 3, 1)
        if mode == "raw":
            if bands is not None:
                f_small = bands.whole(f_small, 6, dim=1)
                s_small = bands.whole(s_small, 6, dim=1)
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
