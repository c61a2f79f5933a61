"""Plain fp32 PyTorch reference of the benchmark's DeepLab-v2 configuration.

DeepLab-v2's ResNet-101 ASPP-L model (Chen et al., arXiv:1606.00915) on
MSRA's ResNet-101 (He et al., arXiv:1512.03385), written from the papers
and the configuration file alone; it imports nothing of the program under
test. A 7x7/2 stem (pad 3) with batch norm and ReLU, a 3x3/2 max-pool
(ceil mode, pad 0), then `blocks` bottlenecks a stage: 1x1 -> BN -> ReLU
-> 3x3 -> BN -> ReLU -> 1x1 -> BN, plus the shortcut (a 1x1 + BN
downsample in each stage's first block), then ReLU. The stage's stride sits
on its first block's first 1x1 and downsample (MSRA's Caffe placement);
each 3x3 pads by its stage's dilation. Batch norm is applied as it stands
(`F.batch_norm`, inference statistics, eps 1e-5), never folded. The ASPP
heads are four 3x3 convolutions with bias at dilation (= padding) 6, 12,
18 and 24, summed, each head on its own. Every tensor is fp32; layouts are
NCHW.

Departures from the published model:
- the heads are SZN's: `aspp_score` regresses the 20-d pascal class
  embedding (not 21 logits), and a second, 2-channel head `aspp_seenmask`
  gates seen against unseen classes;
- the x8 upsample of both heads is FCN's fixed bilinear transposed
  convolution (kernel 16, stride 8, crop 4: half-pixel taps), where
  DeepLab's Caffe `Interp` layer aligns corners.

`quant` ("int8" or "fp8") fake-quantises every convolution's input and
weight as `reference.fcn.conv` does: the reference computed below the
configuration's bf16, the correctness control. `calibrate=True` sets each
batch norm's running mean and variance to the statistics of its input in
this batch (unbiased variance, as a running estimate of momentum 1 would)
before applying it: how the seeded weights get statistics that keep the
activations O(1) through 33 residual blocks. `trunk` and `heads` run with
TF32 off (`allow_tf32` False for cuBLAS and cuDNN, restored after), so
fp32 is computed in full on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# normalize: the images' BGR mean subtraction, DeepLab's Caffe models' too
from benchmark.reference.fcn import (  # noqa: F401
    fake_fp8, fake_int8, normalize, upsample)

BN_EPS = 1e-5
BN_TENSORS = ("weight", "bias", "running_mean", "running_var")


class NoTF32:
    """TF32 off for cuBLAS and cuDNN inside the block, as it was after."""

    def __enter__(self):
        self.flags = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.flags
        return False


def width(cfg: dict, f: int) -> int:
    """A published width at the configuration's `channel_scale` (1 unless
    a CPU test thins the model)."""
    return max(1, int(round(f * cfg.get("channel_scale", 1.0))))


def block_names(cfg: dict) -> list[tuple]:
    """[(prefix, stage index, block index)] of every bottleneck."""
    return [(f"layer{si + 1}.{bi}.", si, bi)
            for si, n in enumerate(cfg["blocks"]) for bi in range(n)]


def param_shapes(cfg: dict) -> dict[str, tuple]:
    """name -> shape of every tensor of the model, in draw order: convs
    (OIHW, no bias in the trunk), each batch norm's four tensors, then the
    ASPP heads' weights and biases. Names are torchvision's ResNet's."""
    shapes = {}

    def conv_bn(conv, bn, cout, cin, k):
        shapes[conv + ".weight"] = (cout, cin, k, k)
        for t in BN_TENSORS:
            shapes[f"{bn}.{t}"] = (cout,)

    stem = width(cfg, cfg["stem_channels"])
    conv_bn("conv1", "bn1", stem, 3, 7)
    cin = stem
    for pre, si, bi in block_names(cfg):
        inner, out = (width(cfg, f) for f in cfg["widths"][si])
        c0 = cin if bi == 0 else out
        conv_bn(pre + "conv1", pre + "bn1", inner, c0, 1)
        conv_bn(pre + "conv2", pre + "bn2", inner, inner, 3)
        conv_bn(pre + "conv3", pre + "bn3", out, inner, 1)
        if bi == 0:
            conv_bn(pre + "downsample.0", pre + "downsample.1", out, c0, 1)
        cin = out
    for head, cout in (("aspp_score", cfg["embed_dim"]),
                       ("aspp_seenmask", cfg["seenmask_channels"])):
        for i in range(len(cfg["aspp_rates"])):
            shapes[f"{head}.{i}.weight"] = (cout, cin, 3, 3)
            shapes[f"{head}.{i}.bias"] = (cout,)
    return shapes


def conv(x, w, b=None, stride=1, padding=0, dilation=1, quant=None):
    fake = {"int8": fake_int8, "fp8": fake_fp8, None: None}[quant]
    if fake is not None:
        x = fake(x, ())
        w = fake(w, (1, 2, 3))
    return F.conv2d(x, w, b, stride=stride, padding=padding,
                    dilation=dilation)


def bn(x: torch.Tensor, p: dict, name: str, calibrate: bool = False):
    if calibrate:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=True)
        p[name + ".running_mean"].copy_(mean)
        p[name + ".running_var"].copy_(var)
    return F.batch_norm(x, p[name + ".running_mean"],
                        p[name + ".running_var"], p[name + ".weight"],
                        p[name + ".bias"], training=False, eps=BN_EPS)


def trunk(cfg: dict, p: dict, x: torch.Tensor, quant=None,
          calibrate: bool = False) -> torch.Tensor:
    """The stem and the four stages on NCHW fp32 `x` -> the last stage's
    output (B, 2048, H / 8, W / 8 rounded up)."""
    with NoTF32():
        return _trunk(cfg, p, x, quant, calibrate)


def _trunk(cfg, p, x, quant, calibrate):
    h = torch.relu(bn(conv(x, p["conv1.weight"], None, 2, 3, 1, quant), p,
                      "bn1", calibrate))
    h = F.max_pool2d(h, 3, 2, ceil_mode=True)
    for pre, si, bi in block_names(cfg):
        stride = cfg["strides"][si] if bi == 0 else 1
        d = cfg["dilations"][si]
        o = torch.relu(bn(conv(h, p[pre + "conv1.weight"], None, stride, 0,
                               1, quant), p, pre + "bn1", calibrate))
        o = torch.relu(bn(conv(o, p[pre + "conv2.weight"], None, 1, d, d,
                               quant), p, pre + "bn2", calibrate))
        o = bn(conv(o, p[pre + "conv3.weight"], None, 1, 0, 1, quant), p,
               pre + "bn3", calibrate)
        if bi == 0:
            h = bn(conv(h, p[pre + "downsample.0.weight"], None, stride, 0,
                        1, quant), p, pre + "downsample.1", calibrate)
        h = torch.relu(o + h)
    return h


def aspp(cfg: dict, p: dict, h: torch.Tensor, head: str, quant=None):
    """One ASPP head on the trunk's output: the sum of its branches."""
    out = 0
    for i, r in enumerate(cfg["aspp_rates"]):
        out = out + conv(h, p[f"{head}.{i}.weight"], p[f"{head}.{i}.bias"],
                         1, r, r, quant)
    return out


def heads(cfg: dict, p: dict, x: torch.Tensor, quant=None, mode="both"):
    """The full-resolution heads of NCHW `x` (B, 3, H, W): (embedding score
    (B, C, H, W), seenmask score (B, 2, H, W)), each upsampled x8 from its
    1/8 map; `mode="raw"` returns the 1/8 maps."""
    with NoTF32():
        h = trunk(cfg, p, x, quant)
        score = aspp(cfg, p, h, "aspp_score", quant)
        seen = aspp(cfg, p, h, "aspp_seenmask", quant)
        if mode == "raw":
            return score, seen
        st, kk, crop = cfg["upsample"]
        return (upsample(score, st, kk, crop, x.shape[2], x.shape[3]),
                upsample(seen, st, kk, crop, x.shape[2], x.shape[3]))
