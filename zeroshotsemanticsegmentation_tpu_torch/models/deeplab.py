"""DeepLab-v2 ResNet-101 (ASPP-L) with the SZN heads, as an nn.Module.

The backbone is MSRA's ResNet-101 (He et al., arXiv:1512.03385) as
DeepLab-v2 runs it (Chen et al., arXiv:1606.00915): a 7x7/2 stem with a
3x3/2 ceil-mode max-pool, then 3, 4, 23 and 3 bottleneck blocks
(1x1 -> 3x3 -> 1x1, each with frozen batch norm, the shortcut added before
the last ReLU). The first block of `layer2` strides by 2 on its first 1x1
and its downsample (MSRA's Caffe placement); `layer3` and `layer4` keep
stride 1 and dilate their 3x3s by 2 and 4, so the trunk ends at output
stride 8 (a 512 side gives 64). The ASPP heads replace DeepLab's
classifier with SZN's: `aspp_score` (four 3x3 convolutions at dilation 6,
12, 18 and 24 into the `num_classes` embedding dims, summed) and
`aspp_seenmask` (the same into 2 gate channels).

Module names follow torchvision's ResNet (`conv1`, `bn1`, `layer3.7.conv2`,
`layer1.0.downsample.0` / `.1`), so a published state dict maps key for
key. Batch norm is frozen: each `FrozenBatchNorm2d` keeps its weight,
bias, running mean and running variance as buffers, and the forward
folds them, in fp32, into the convolution before it, once per load of
weights (`load_state_dict`, a move of the module); a request reuses the
folded weights. `_kernels.launch_counts["bn_folds"]` counts the folds.

The forward runs channels_last in `dtype` over fp32 parameters: each
convolution takes its folded weight and bias in `dtype`; on the card a
convolution and its bias and ReLU are one cuDNN call
(`torch.cudnn_convolution_relu`), and a block's last 1x1 with its bias,
the shortcut and the ReLU another (`torch.cudnn_convolution_add_relu`),
where separate bias, add and ReLU passes took half of a B=16 forward's
device time at 512^2 (32.1 against 15.2 ms, NVIDIA H100). The two heads
run as one convolution a rate (their rows stacked and padded to a
multiple of 8 output channels), summed in fp32. `mode="raw"` returns the
1/8 heads NHWC, (B, h8, w8, C) and (B, h8, w8, 2), for the fused labels
kernel with the upsample geometry `UPSAMPLE` (stride, kernel, crop);
`mode="both"` upsamples both with those fixed bilinear taps (FCN's
transposed-conv filter, kernel 16, crop 4) to the input's size, fp32
NHWC.

Spans (`utils.profiling`, CUDA events on the card): `model.stem`,
`model.layer1` ... `model.layer4` and `model.aspp`, each around its
stage's kernels, with the work `batch`, `h`, `w` (its output's) and
`dilation` (the stage's; the ASPP rates for `model.aspp`).

Serving only: the model has no training forward.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from zeroshotsemanticsegmentation_tpu_torch import resolve_device
from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
from zeroshotsemanticsegmentation_tpu_torch.ops.bilinear import (
    upsample_bilinear_cropped)
from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import span

BLOCKS = (3, 4, 23, 3)
WIDTHS = ((64, 256), (128, 512), (256, 1024), (512, 2048))  # (inner, out)
STRIDES = (1, 2, 1, 1)
DILATIONS = (1, 1, 2, 4)
ASPP_RATES = (6, 12, 18, 24)
STEM = 64
BN_EPS = 1e-5
_HEAD_ALIGN = 8  # the stacked heads' output channels, padded


def _conv_relu(h, w, b, stride=1, padding=0, dilation=1):
    """relu(conv(h, w) + b): one cuDNN call on the card (its fused
    convolution, bias and ReLU), three passes elsewhere."""
    if h.is_cuda:
        return torch.cudnn_convolution_relu(h, w, b, (stride, stride),
                                            (padding, padding),
                                            (dilation, dilation), 1)
    return F.conv2d(h, w, b, stride, padding, dilation).relu_()


def _conv_add_relu(h, w, b, z):
    """relu(conv1x1(h, w) + b + z), the block's end: one cuDNN call on the
    card, as `_conv_relu`."""
    if h.is_cuda:
        return torch.cudnn_convolution_add_relu(h, w, z, 1.0, b, (1, 1),
                                                (0, 0), (1, 1), 1)
    return F.conv2d(h, w, b).add_(z).relu_()


def _shapes(sp, t: torch.Tensor) -> None:
    """A recorded span's work: the batch and sides of its output `t`."""
    if sp is not None:
        sp.work.update(batch=t.shape[0], h=t.shape[2], w=t.shape[3])


class FrozenBatchNorm2d(nn.Module):
    """Batch norm with fixed statistics and affine: four buffers, no
    running update (torchvision's FrozenBatchNorm2d). A state dict's
    `num_batches_tracked` is dropped on load."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        for name, fill in (("weight", 1.0), ("bias", 0.0),
                           ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full((channels,), fill,
                                                  device=device))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def scale_shift(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(scale, shift) with bn(x) == x * scale + shift, fp32."""
        scale = self.weight.float() * torch.rsqrt(
            self.running_var.float() + BN_EPS)
        return scale, self.bias.float() - self.running_mean.float() * scale


class Bottleneck(nn.Module):
    def __init__(self, cin: int, inner: int, cout: int, stride: int,
                 dilation: int, device=None):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.conv1 = nn.Conv2d(cin, inner, 1, stride=stride, bias=False,
                               device=device)
        self.bn1 = FrozenBatchNorm2d(inner, device)
        self.conv2 = nn.Conv2d(inner, inner, 3, padding=dilation,
                               dilation=dilation, bias=False, device=device)
        self.bn2 = FrozenBatchNorm2d(inner, device)
        self.conv3 = nn.Conv2d(inner, cout, 1, bias=False, device=device)
        self.bn3 = FrozenBatchNorm2d(cout, device)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride=stride, bias=False,
                          device=device),
                FrozenBatchNorm2d(cout, device))


class DeepLabV2ResNet101(nn.Module):
    RAW_HEADS = True  # mode="raw" feeds the fused labels kernel
    OUTPUT_STRIDE = 8
    UPSAMPLE = (8, 16, 4)  # (stride, kernel, crop) of the bilinear x8

    def __init__(self, num_classes: int, *, dtype=torch.float32,
                 channel_scale: float = 1.0, blocks: tuple = BLOCKS,
                 generator: torch.Generator | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.num_classes = num_classes
        self.dtype = dtype
        self.channel_scale = channel_scale
        self.blocks = tuple(blocks)
        stem = self.width(STEM)
        self.conv1 = nn.Conv2d(3, stem, 7, stride=2, padding=3, bias=False,
                               device=device)
        self.bn1 = FrozenBatchNorm2d(stem, device)
        cin = stem
        for si, (n, (inner, out)) in enumerate(zip(self.blocks, WIDTHS)):
            inner, out = self.width(inner), self.width(out)
            layer = nn.Sequential(*(
                Bottleneck(cin if bi == 0 else out, inner, out,
                           STRIDES[si] if bi == 0 else 1, DILATIONS[si],
                           device) for bi in range(n)))
            self.add_module(f"layer{si + 1}", layer)
            cin = out
        self.aspp_score = nn.ModuleList(
            nn.Conv2d(cin, num_classes, 3, padding=r, dilation=r,
                      device=device) for r in ASPP_RATES)
        self.aspp_seenmask = nn.ModuleList(
            nn.Conv2d(cin, 2, 3, padding=r, dilation=r, device=device)
            for r in ASPP_RATES)
        self._folded = None
        self.register_load_state_dict_post_hook(
            lambda module, incompatible: module.refold())
        self.reset_parameters(generator)

    def width(self, f: int) -> int:
        return max(1, int(round(f * self.channel_scale)))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """LeCun-normal kernels from `generator` and zero head biases; the
        batch norms' buffers are left as they are (the identity when
        built)."""
        for name, p in self.named_parameters():
            if name.endswith(".weight"):
                w = torch.randn(p.shape, generator=generator)
                p.copy_(w / math.sqrt(p[0].numel()))
            else:
                p.zero_()
        self.refold()

    def refold(self) -> None:
        """Drop the folded weights: the next forward folds the batch norms
        again (after a load of weights, or a change made in place)."""
        self._folded = None

    def _apply(self, fn, *args, **kwargs):
        self.refold()
        return super()._apply(fn, *args, **kwargs)

    def _fold(self) -> dict:
        """{conv name: (weight, bias)} in `dtype`, channels_last, with
        each frozen batch norm folded in fp32; made once per load."""
        def fold(conv: nn.Conv2d, bn: FrozenBatchNorm2d):
            scale, shift = bn.scale_shift()
            w = conv.weight.float() * scale[:, None, None, None]
            return (w.to(self.dtype, memory_format=torch.channels_last),
                    shift.to(self.dtype))

        out = {"conv1": fold(self.conv1, self.bn1)}
        for si in range(len(self.blocks)):
            for bi, blk in enumerate(getattr(self, f"layer{si + 1}")):
                pre = f"layer{si + 1}.{bi}."
                for c in ("1", "2", "3"):
                    out[pre + "conv" + c] = fold(getattr(blk, "conv" + c),
                                                 getattr(blk, "bn" + c))
                if blk.downsample is not None:
                    out[pre + "downsample"] = fold(*blk.downsample)
        pad = -(self.num_classes + 2) % _HEAD_ALIGN
        bias = 0.0
        for r, (cs, cm) in enumerate(zip(self.aspp_score,
                                         self.aspp_seenmask)):
            w = F.pad(torch.cat([cs.weight, cm.weight]).float(),
                      (0, 0, 0, 0, 0, 0, 0, pad))
            out[f"aspp{r}"] = (
                w.to(self.dtype, memory_format=torch.channels_last), None)
            bias = bias + torch.cat([cs.bias, cm.bias]).float()
        out["aspp_bias"] = F.pad(bias, (0, pad))
        _kernels.launch_counts["bn_folds"] += 1
        return out

    def folded(self) -> dict:
        if self._folded is None:
            with torch.inference_mode(False), torch.no_grad():
                self._folded = self._fold()
        return self._folded

    def _stage(self, h: torch.Tensor, si: int, fw: dict) -> torch.Tensor:
        for bi, blk in enumerate(getattr(self, f"layer{si + 1}")):
            pre = f"layer{si + 1}.{bi}."
            shortcut = h
            if blk.downsample is not None:
                shortcut = F.conv2d(h, *fw[pre + "downsample"],
                                    stride=blk.stride)
            o = _conv_relu(h, *fw[pre + "conv1"], stride=blk.stride)
            o = _conv_relu(o, *fw[pre + "conv2"], padding=blk.dilation,
                           dilation=blk.dilation)
            h = _conv_add_relu(o, *fw[pre + "conv3"], shortcut)
        return h

    def _stages(self, fw: dict) -> list:
        """[(span name, dilation, fn)] of the six stages, image to heads:
        the stem takes the (B, H, W, 3) image, the ASPP stage returns the
        stacked heads (B, 24, h8, w8) fp32."""
        def stem(x):
            h = x.permute(0, 3, 1, 2).to(self.dtype,
                                         memory_format=torch.channels_last)
            h = _conv_relu(h, *fw["conv1"], stride=2, padding=3)
            return F.max_pool2d(h, 3, 2, ceil_mode=True)

        def layer(si):
            return lambda h: self._stage(h, si, fw)

        def aspp(h):
            y = None
            for r, rate in enumerate(ASPP_RATES):
                t = F.conv2d(h, *fw[f"aspp{r}"], padding=rate,
                             dilation=rate).float()
                y = t if y is None else y.add_(t)
            return y.add_(fw["aspp_bias"][:, None, None])

        return ([("model.stem", 1, stem)]
                + [(f"model.layer{si + 1}", DILATIONS[si], layer(si))
                   for si in range(len(self.blocks))]
                + [("model.aspp", ASPP_RATES, aspp)])

    def forward(self, x: torch.Tensor, *, mode: str = "both", bands=None):
        """(B, H, W, 3) float32 BGR mean-subtracted images -> the heads:
        mode "raw", the 1/8 heads (B, h8, w8, C) and (B, h8, w8, 2) in
        fp32; mode "both", both upsampled x8 to (B, H, W, C) and
        (B, H, W, 2), fp32. There is no height-sharded forward (`bands`
        must be None)."""
        if mode not in ("raw", "both"):
            raise ValueError(f"DeepLabV2ResNet101 serves mode 'raw' or "
                             f"'both', got {mode!r}")
        if bands is not None:
            raise ValueError("DeepLabV2ResNet101 has no height-sharded "
                             "forward")
        in_h, in_w = x.shape[1], x.shape[2]
        y = x
        for name, dilation, fn in self._stages(self.folded()):
            with span(name, device=True, dilation=dilation) as sp:
                y = fn(y)
                _shapes(sp, y)
        y = y.permute(0, 2, 3, 1)
        k = self.num_classes
        score, seen = y[..., :k], y[..., k:k + 2]
        if mode == "raw":
            return score, seen
        stride, kernel, crop = self.UPSAMPLE
        return tuple(upsample_bilinear_cropped(
            s, stride=stride, kernel_size=kernel, crop_offset=crop,
            out_h=in_h, out_w=in_w) for s in (score, seen))
