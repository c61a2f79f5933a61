"""FCN-8s: the skip-fusion variant of FCN-32s (the JAX package's
models/fcn8s.py), as an nn.Module.

    fc7 -> score_fr -> x2 bilinear ----------------------------------+
    pool4 -> 1x1 score_pool4 (zero init) -> crop 5 ------------------ add
      -> x2 bilinear --------------------------------------------------+
    pool3 -> 1x1 score_pool3 (zero init) -> crop 9 ------------------ add
      -> x8 bilinear, crop 31 to the input size

Every bilinear upsample is a fixed interpolation-matrix product (as the
FCN-32s upscore is); the skips are added in fp32. The zero-initialised skip
heads make a fresh FCN-8s's skips contribute nothing. The 2-channel seenmask
head keeps the coarse x32 path with a FIXED bilinear upsample, so the model
has no `seenmask_upscore` and stage 2 trains `seenmask_score` alone.

The trunk is FCN-32s's (`models.fcn32s.VGGTrunk`: the same module names,
init, dropout, fc6/fc7 ops and fused block 1), with the support-pruned run
at most 3 blocks deep: the full virtual pool3 it returns is the skip tap.
There is no mode="raw": the fcn head fuses pool3/pool4 at several
resolutions, so there is no pre-upsample head pair for the fused serving
kernel, and serving takes the unfused full-resolution route.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import VGGTrunk
from zeroshotsemanticsegmentation_tpu_torch.models.pruned import (
    NUM_PRUNED_BLOCKS_SKIP)
from zeroshotsemanticsegmentation_tpu_torch.ops.bilinear import (
    upsample_bilinear_cropped)

_CROP_POOL4 = 5
_CROP_POOL3 = 9
_CROP_FINAL = 31
SKIP_MODULES = ("score_pool3", "score_pool4")


def _up_full(t: torch.Tensor, stride: int, kernel: int) -> torch.Tensor:
    """Uncropped fixed bilinear upsample of (B, h, w, C): the transposed
    convolution's whole output, (in - 1) * stride + kernel a side, fp32."""
    return upsample_bilinear_cropped(
        t, stride=stride, kernel_size=kernel, crop_offset=0,
        out_h=(t.shape[1] - 1) * stride + kernel,
        out_w=(t.shape[2] - 1) * stride + kernel)


def _crop_to(t: torch.Tensor, offset: int, like: torch.Tensor):
    return t[:, offset:offset + like.shape[1], offset:offset + like.shape[2]]


class FCN8s(VGGTrunk):
    RAW_HEADS = False
    PRUNED_DEPTH = NUM_PRUNED_BLOCKS_SKIP

    def __init__(self, num_classes: int, *, dtype=torch.float32,
                 dropout_rate: float = 0.5, channel_scale: float = 1.0,
                 prune_pad: bool = True, fused_block1: bool = False,
                 generator: torch.Generator | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__(num_classes, dtype=dtype, dropout_rate=dropout_rate,
                         channel_scale=channel_scale, prune_pad=prune_pad,
                         fused_block1=fused_block1, device=device)
        dev = self.fc6.weight.device
        self.score_pool3 = nn.Conv2d(self.width(256), num_classes, 1,
                                     device=dev)
        self.score_pool4 = nn.Conv2d(self.width(512), num_classes, 1,
                                     device=dev)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """The convolutions' init from `generator` (FCN-32s's draws); the
        skip heads at zero, weights and biases (JAX `conv1x1(...,
        zero_init=True)`)."""
        self._reset_convs(generator)
        for name in SKIP_MODULES:
            getattr(self, name).weight.zero_()
            getattr(self, name).bias.zero_()

    def forward(self, x: torch.Tensor, *, mode: str = "both",
                train: bool = False,
                generator: torch.Generator | None = None,
                frozen_trunk: bool = False, bands=None):
        """mode in {fcn, seenmask, both}: fp32 (B, H, W, C) and/or
        (B, H, W, 2). `train`, `generator` and `frozen_trunk` as in
        `FCN32s.forward`. `bands` (`parallel.spatial.Bands`): this rank
        computes its rows of the trunk, gathers the score maps at 1/32,
        1/16 and 1/8 resolution and returns its rows of the output
        (`bands.out_rows()`)."""
        if mode not in ("fcn", "seenmask", "both"):
            raise ValueError(f"unexpected forward mode: {mode!r}")
        in_h, in_w = x.shape[1], x.shape[2]
        h, pools = self._trunk(x, train, generator, frozen_trunk, bands)
        rows = None if bands is None else bands.out_rows()

        def head(name, t, level):
            t = self._fc(name, t).permute(0, 2, 3, 1)
            return t if bands is None else bands.whole(t, level, dim=1)

        def fcn_head():
            u2 = _up_full(head("score_fr", h, 6), 2, 4)
            p4 = head("score_pool4", pools[3], 4).to(torch.float32)
            u4 = _up_full(u2 + _crop_to(p4, _CROP_POOL4, u2), 2, 4)
            p3 = head("score_pool3", pools[2], 3).to(torch.float32)
            return upsample_bilinear_cropped(
                u4 + _crop_to(p3, _CROP_POOL3, u4), stride=8,
                kernel_size=16, crop_offset=_CROP_FINAL, out_h=in_h,
                out_w=in_w, rows=rows)

        def seenmask_head():
            # the coarse x32 path of FCN-32s, with the fixed bilinear taps
            return upsample_bilinear_cropped(
                head("seenmask_score", h, 6), stride=32, kernel_size=64,
                crop_offset=19, out_h=in_h, out_w=in_w, rows=rows)

        if mode == "fcn":
            return fcn_head()
        if mode == "seenmask":
            return seenmask_head()
        return fcn_head(), seenmask_head()
