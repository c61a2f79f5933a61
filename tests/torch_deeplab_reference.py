"""Plain fp32 PyTorch reference of DeepLab-v2 ResNet-101 with the SZN heads,
for the CPU tests (tests/test_torch_deeplab.py); the benchmark keeps its
own copy (benchmark/reference/deeplab.py).

Written from the papers (Chen et al., arXiv:1606.00915; He et al.,
arXiv:1512.03385) and imports nothing of the port: a 7x7/2 stem (pad 3) with
batch norm and ReLU, a 3x3/2 max-pool (ceil mode, pad 0), bottlenecks
1x1 -> BN -> ReLU -> 3x3 -> BN -> ReLU -> 1x1 -> BN plus the shortcut (a
1x1 + BN downsample in each stage's first block), then ReLU; the stage's
stride on the first block's first 1x1 and downsample (MSRA's Caffe
placement), the 3x3s padded by their dilation (1, 1, 2, 4). Batch norm is
applied as it stands (`F.batch_norm`, inference statistics, eps 1e-5);
each ASPP branch (3x3 with bias, dilation = padding 6, 12, 18, 24) runs on
its own and the branches are summed. TF32 is off while it computes.

Departures from the published model: the heads are SZN's (a 20-d
embedding head and a 2-channel seenmask gate, not 21 logits), and the x8
upsample is FCN's fixed bilinear transposed convolution (kernel 16, crop
4: half-pixel taps) where DeepLab's Caffe `Interp` aligns corners.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BLOCKS = (3, 4, 23, 3)
WIDTHS = ((64, 256), (128, 512), (256, 1024), (512, 2048))
STRIDES = (1, 2, 1, 1)
DILATIONS = (1, 1, 2, 4)
RATES = (6, 12, 18, 24)
BRANCH_SCALE = 0.05  # each block's last BN: near its shortcut, as trained
MEAN_BGR = (104.00698793, 116.66876762, 122.67891434)


class _NoTF32:
    def __enter__(self):
        self.flags = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.flags


def _w(f: int, scale: float) -> int:
    return max(1, int(round(f * scale)))


def param_shapes(embed: int, scale: float = 1.0,
                 blocks=BLOCKS) -> dict[str, tuple]:
    """Every tensor of the model's state dict (torchvision's names)."""
    shapes = {}

    def conv_bn(conv, bn, cout, cin, k):
        shapes[conv + ".weight"] = (cout, cin, k, k)
        for t in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{bn}.{t}"] = (cout,)

    conv_bn("conv1", "bn1", _w(64, scale), 3, 7)
    cin = _w(64, scale)
    for si, n in enumerate(blocks):
        inner, out = (_w(f, scale) for f in WIDTHS[si])
        for bi in range(n):
            pre = f"layer{si + 1}.{bi}."
            c0 = cin if bi == 0 else out
            conv_bn(pre + "conv1", pre + "bn1", inner, c0, 1)
            conv_bn(pre + "conv2", pre + "bn2", inner, inner, 3)
            conv_bn(pre + "conv3", pre + "bn3", out, inner, 1)
            if bi == 0:
                conv_bn(pre + "downsample.0", pre + "downsample.1", out, c0,
                        1)
        cin = out
    for head, cout in (("aspp_score", embed), ("aspp_seenmask", 2)):
        for i in range(len(RATES)):
            shapes[f"{head}.{i}.weight"] = (cout, cin, 3, 3)
            shapes[f"{head}.{i}.bias"] = (cout,)
    return shapes


def normalize(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB -> NCHW fp32 BGR minus the Caffe mean."""
    x = images.flip(-1).to(torch.float32) - torch.tensor(MEAN_BGR)
    return x.permute(0, 3, 1, 2).contiguous()


def _bn(x, p, name, calibrate):
    if calibrate:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=True)
        p[name + ".running_mean"] = mean
        p[name + ".running_var"] = var
    return F.batch_norm(x, p[name + ".running_mean"],
                        p[name + ".running_var"], p[name + ".weight"],
                        p[name + ".bias"], training=False, eps=BN_EPS)


def trunk(p: dict, x: torch.Tensor, blocks=BLOCKS,
          calibrate: bool = False) -> torch.Tensor:
    """Stem and stages on NCHW fp32 `x`; `calibrate` sets each batch norm's
    statistics to its input's in this batch first."""
    with _NoTF32():
        h = torch.relu(_bn(F.conv2d(x, p["conv1.weight"], stride=2,
                                    padding=3), p, "bn1", calibrate))
        h = F.max_pool2d(h, 3, 2, ceil_mode=True)
        for si, n in enumerate(blocks):
            for bi in range(n):
                pre = f"layer{si + 1}.{bi}."
                s = STRIDES[si] if bi == 0 else 1
                d = DILATIONS[si]
                o = torch.relu(_bn(F.conv2d(h, p[pre + "conv1.weight"],
                                            stride=s), p, pre + "bn1",
                                   calibrate))
                o = torch.relu(_bn(F.conv2d(o, p[pre + "conv2.weight"],
                                            padding=d, dilation=d), p,
                                   pre + "bn2", calibrate))
                o = _bn(F.conv2d(o, p[pre + "conv3.weight"]), p,
                        pre + "bn3", calibrate)
                if bi == 0:
                    h = _bn(F.conv2d(h, p[pre + "downsample.0.weight"],
                                     stride=s), p, pre + "downsample.1",
                            calibrate)
                h = torch.relu(o + h)
        return h


def bilinear_filter(kernel: int) -> np.ndarray:
    factor = (kernel + 1) // 2
    center = factor - 1 if kernel % 2 == 1 else factor - 0.5
    f = 1 - np.abs(np.arange(kernel) - center) / factor
    return np.outer(f, f).astype(np.float32)


def upsample8(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """FCN's fixed bilinear x8 transposed conv (kernel 16), cropped at 4."""
    c = x.shape[1]
    w = torch.from_numpy(bilinear_filter(16)).expand(c, 1, 16, 16)
    with _NoTF32():
        y = F.conv_transpose2d(x, w, stride=8, groups=c)
    return y[:, :, 4:4 + out_h, 4:4 + out_w]


def heads(p: dict, x: torch.Tensor, blocks=BLOCKS, mode: str = "both"):
    """NCHW (score, seenmask) heads: the 1/8 maps (mode "raw") or both
    upsampled x8 to the input's size."""
    h = trunk(p, x, blocks)
    out = []
    with _NoTF32():
        for head in ("aspp_score", "aspp_seenmask"):
            y = 0
            for i, r in enumerate(RATES):
                y = y + F.conv2d(h, p[f"{head}.{i}.weight"],
                                 p[f"{head}.{i}.bias"], padding=r,
                                 dilation=r)
            out.append(y)
    if mode == "raw":
        return tuple(out)
    return tuple(upsample8(y, x.shape[2], x.shape[3]) for y in out)


def make_weights(seed: int, embed: int = 20, scale: float = 1 / 16,
                 blocks=(1, 1, 2, 1)) -> dict[str, torch.Tensor]:
    """Seeded fp32 CPU tensors: LeCun-normal kernels, N(0, 0.1^2) head
    biases, BN weight 1 + N(0, 0.1^2) and bias N(0, 0.1^2) (times
    `BRANCH_SCALE` in each block's last BN), centred head rows, and BN
    statistics calibrated on one seeded batch of 2 uniform 64 x 64
    images."""
    g = torch.Generator().manual_seed(seed)
    p = {}
    for n, s in param_shapes(embed, scale, blocks).items():
        if n.endswith(".running_mean"):
            p[n] = torch.zeros(s)
        elif n.endswith(".running_var"):
            p[n] = torch.ones(s)
        elif len(s) == 4:
            p[n] = torch.randn(s, generator=g) / math.sqrt(
                math.prod(s[1:]))
            if n.startswith("aspp"):
                p[n] = p[n] - p[n].mean(dim=1, keepdim=True)
        else:
            p[n] = torch.randn(s, generator=g) * 0.1 + (
                1.0 if n.endswith(".weight") else 0.0)
            if n.endswith((".bn3.weight", ".bn3.bias")):
                p[n] = p[n] * BRANCH_SCALE
    images = torch.randint(0, 256, (2, 64, 64, 3), generator=g,
                           dtype=torch.uint8)
    with torch.no_grad():
        trunk(p, normalize(images), blocks, calibrate=True)
    return p


def stitched_labels(score: torch.Tensor, seen: torch.Tensor,
                    emb: torch.Tensor, unseen) -> torch.Tensor:
    """(B, H, W) SZN labels of NCHW heads: the gate (channel 0 >= 1 picks
    the unseen classes), then the first max of the cosines, the classes
    outside the partition at exactly 0."""
    s_n = score.norm(dim=1, keepdim=True)
    s_n = torch.where(s_n == 0, torch.ones_like(s_n), s_n)
    e = emb / emb.norm(dim=1, keepdim=True)
    sims = torch.einsum("bchw,kc->bkhw", score, e) / s_n
    is_unseen = torch.zeros(emb.shape[0], dtype=torch.bool)
    is_unseen[list(unseen)] = True
    zero = torch.zeros_like(sims)
    m_seen = torch.where(~is_unseen[None, :, None, None], sims, zero)
    m_unseen = torch.where(is_unseen[None, :, None, None], sims, zero)
    return torch.where(seen[:, 0] >= seen[:, 1], m_unseen.argmax(1),
                       m_seen.argmax(1)).to(torch.int32)
