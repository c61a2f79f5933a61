"""Plain fp32 PyTorch reference of the benchmark's FCN configurations.

FCN-32s and FCN-8s on VGG16 (Long, Shelhamer & Darrell, CVPR 2015), with
the SZN heads: `score_fr` regresses a per-pixel class embedding and the
2-channel `seenmask_score` gates seen against unseen classes. Written from
the published description and the configuration file alone; it imports
nothing of the program under test.

The geometry is the paper's: conv1_1 pads by 100, every other 3x3 conv by
1, max-pools are 2x2/2 with ceil mode, fc6 is a VALID 7x7 conv, fc7 and
the heads 1x1. FCN-32s upsamples x32 (kernel 64) and crops 19; FCN-8s
adds `score_pool4` (crop 5) and `score_pool3` (crop 9) through x2, x2 and
x8 (kernel 16, crop 31) bilinear upsamples, and its seenmask head takes
the fixed x32 bilinear upsample. FCN-32s's seenmask upsample is a learned
transposed convolution (`seenmask_upscore`). Every tensor is fp32; layouts
are NCHW.

`quant="int8"` fake-quantises every conv's input (per tensor) and weight
(per output channel) to int8 levels before the fp32 conv: the reference
computed one precision below the configuration's bf16, used as the
correctness control where the program has no int8 path of its own.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def conv_names(cfg: dict) -> list[str]:
    """The 13 VGG conv names, block by block (conv1_1 ... conv5_3)."""
    return [f"conv{bi + 1}_{ci + 1}" for bi, blk in enumerate(cfg["vgg"])
            for ci in range(len(blk))]


def param_shapes(cfg: dict) -> dict[str, tuple]:
    """name -> shape of every parameter, in draw order: each conv's weight
    (OIHW) and bias, then the FCN-32s seenmask upscore (IOHW)."""
    shapes = {}
    cin = 3
    for name, cout in zip(conv_names(cfg), sum(map(list, cfg["vgg"]), [])):
        shapes[f"{name}.weight"] = (cout, cin, 3, 3)
        shapes[f"{name}.bias"] = (cout,)
        cin = cout
    k, f6, f7 = cfg["fc6_kernel"], cfg["fc6_channels"], cfg["fc7_channels"]
    heads = [("fc6", f6, cin, k), ("fc7", f7, f6, 1),
             ("score_fr", cfg["embed_dim"], f7, 1),
             ("seenmask_score", cfg["seenmask_channels"], f7, 1)]
    if cfg["arch"] == "fcn8s":
        heads += [("score_pool3", cfg["embed_dim"], cfg["vgg"][2][-1], 1),
                  ("score_pool4", cfg["embed_dim"], cfg["vgg"][3][-1], 1)]
    for name, cout, cin_, kk in heads:
        shapes[f"{name}.weight"] = (cout, cin_, kk, kk)
        shapes[f"{name}.bias"] = (cout,)
    if cfg["arch"] == "fcn32s":
        c = cfg["seenmask_channels"]
        shapes["seenmask_upscore.weight"] = (c, c, cfg["upsample_kernel"],
                                             cfg["upsample_kernel"])
    return shapes


def bilinear_filter(kernel: int) -> np.ndarray:
    """(kernel, kernel) bilinear interpolation taps (FCN's
    get_upsampling_weight)."""
    factor = (kernel + 1) // 2
    center = factor - 1 if kernel % 2 == 1 else factor - 0.5
    og = np.arange(kernel, dtype=np.float64)
    f = 1 - np.abs(og - center) / factor
    return np.outer(f, f).astype(np.float32)


def bilinear_upscore(channels: int, kernel: int) -> np.ndarray:
    """(C, C, k, k) transposed-conv weight, bilinear on the diagonal."""
    w = np.zeros((channels, channels, kernel, kernel), np.float32)
    w[np.arange(channels), np.arange(channels)] = bilinear_filter(kernel)
    return w


def fake_int8(t: torch.Tensor, dims: tuple) -> torch.Tensor:
    """t rounded to 255 symmetric int8 levels, scaled by max |t| over
    `dims` (all dims: per tensor); the gradient passes straight through
    the rounding."""
    with torch.no_grad():
        amax = (t.abs().amax(dim=dims, keepdim=True) if dims
                else t.abs().max())
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        q = torch.clamp(torch.round(t / scale), -127, 127) * scale
    return t + (q - t).detach()


def fake_fp8(t: torch.Tensor, dims: tuple) -> torch.Tensor:
    """t rounded to float8 e4m3 (3 mantissa bits), scaled so that max |t|
    over `dims` (all dims: per tensor) maps to e4m3's largest finite value;
    the gradient passes straight through the rounding."""
    with torch.no_grad():
        amax = (t.abs().amax(dim=dims, keepdim=True) if dims
                else t.abs().max())
        scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
        q = (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


def conv(x, w, b, padding=0, quant=None):
    fake = {"int8": fake_int8, "fp8": fake_fp8, None: None}[quant]
    if fake is not None:
        x = fake(x, ())
        w = fake(w, (1, 2, 3))
    return F.conv2d(x, w, b, padding=padding)


def upsample(x: torch.Tensor, stride: int, kernel: int, crop: int,
             out_h: int | None = None, out_w: int | None = None):
    """Fixed bilinear transposed conv of NCHW `x`, per channel, cropped at
    `crop` to (out_h, out_w) (default: the whole output)."""
    c = x.shape[1]
    w = torch.from_numpy(bilinear_filter(kernel)).to(x.device)
    y = F.conv_transpose2d(x, w.expand(c, 1, kernel, kernel), stride=stride,
                           groups=c)
    out_h = y.shape[2] - crop if out_h is None else out_h
    out_w = y.shape[3] - crop if out_w is None else out_w
    return y[:, :, crop:crop + out_h, crop:crop + out_w]


def trunk(cfg: dict, p: dict, x: torch.Tensor, masks=None, quant=None):
    """VGG blocks 1-5, fc6 and fc7 on NCHW fp32 `x` -> (fc7 output, pool3,
    pool4). `masks` = (fc6 keep, fc7 keep), (B, C) bools: channel dropout
    at `cfg["dropout"]`, kept channels scaled by 1 / (1 - rate)."""
    h = x
    names = iter(conv_names(cfg))
    pools = []
    for bi, blk in enumerate(cfg["vgg"]):
        for ci in range(len(blk)):
            n = next(names)
            pad = cfg["pad_conv1"] if bi == 0 and ci == 0 else 1
            h = torch.relu(conv(h, p[f"{n}.weight"], p[f"{n}.bias"], pad,
                                quant))
        h = F.max_pool2d(h, 2, 2, ceil_mode=True)
        pools.append(h)
    keep = 1.0 - cfg["dropout"]
    for i, n in enumerate(("fc6", "fc7")):
        h = torch.relu(conv(h, p[f"{n}.weight"], p[f"{n}.bias"], 0, quant))
        if masks is not None:
            m = masks[i].to(h.device)[:, :, None, None]
            h = torch.where(m, h / keep, torch.zeros_like(h))
    return h, pools[2], pools[3]


def heads(cfg: dict, p: dict, x: torch.Tensor, masks=None, quant=None,
          mode: str = "both"):
    """The full-resolution heads of NCHW `x` (B, 3, H, W): (embedding score
    (B, C, H, W), seenmask score (B, 2, H, W)); `mode` "fcn" or "seenmask"
    computes one of them (the other is None)."""
    in_h, in_w = x.shape[2], x.shape[3]
    h, pool3, pool4 = trunk(cfg, p, x, masks, quant)
    st, kk, crop = (cfg["upsample_stride"], cfg["upsample_kernel"],
                    cfg["crop"])
    score = seen = None
    if mode in ("fcn", "both"):
        s = conv(h, p["score_fr.weight"], p["score_fr.bias"], 0, quant)
        if cfg["arch"] == "fcn8s":
            u2 = upsample(s, 2, 4, 0)
            p4 = conv(pool4, p["score_pool4.weight"], p["score_pool4.bias"],
                      0, quant)
            u4 = upsample(u2 + p4[:, :, 5:5 + u2.shape[2], 5:5 + u2.shape[3]],
                          2, 4, 0)
            p3 = conv(pool3, p["score_pool3.weight"], p["score_pool3.bias"],
                      0, quant)
            score = upsample(
                u4 + p3[:, :, 9:9 + u4.shape[2], 9:9 + u4.shape[3]], 8, 16,
                31, in_h, in_w)
        else:
            score = upsample(s, st, kk, crop, in_h, in_w)
    if mode in ("seenmask", "both"):
        g = conv(h, p["seenmask_score.weight"], p["seenmask_score.bias"], 0,
                 quant)
        if "seenmask_upscore.weight" in p:
            seen = F.conv_transpose2d(g, p["seenmask_upscore.weight"],
                                      stride=st)
            seen = seen[:, :, crop:crop + in_h, crop:crop + in_w]
        else:
            seen = upsample(g, st, kk, crop, in_h, in_w)
    return score, seen


MEAN_BGR = (104.00698793, 116.66876762, 122.67891434)


def normalize(images: torch.Tensor, sizes=None) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB -> NCHW fp32 BGR minus the VGG mean. With
    `sizes` (B, 2), pixels outside each image's (h, w) are zero (the
    training feed's bucket pad)."""
    x = images.flip(-1).to(torch.float32) - torch.tensor(
        MEAN_BGR, dtype=torch.float32, device=images.device)
    if sizes is not None:
        rows = torch.arange(x.shape[1], device=x.device)[None, :, None]
        cols = torch.arange(x.shape[2], device=x.device)[None, None, :]
        sz = torch.as_tensor(sizes, device=x.device)
        pad = (rows >= sz[:, 0, None, None]) | (cols >= sz[:, 1, None, None])
        x = torch.where(pad[..., None], torch.zeros_like(x), x)
    return x.permute(0, 3, 1, 2).contiguous()


def cosine(score: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) x (K, C) -> (B, K, H, W) cosine similarities; a zero
    vector counts norm 1."""
    s_n = score.norm(dim=1, keepdim=True)
    s_n = torch.where(s_n == 0, torch.ones_like(s_n), s_n)
    e_n = emb.norm(dim=1, keepdim=True)
    e = emb / torch.where(e_n == 0, torch.ones_like(e_n), e_n)
    return torch.einsum("bchw,kc->bkhw", score, e) / s_n


def lecun_scale(shape: tuple) -> float:
    return 1.0 / math.sqrt(math.prod(shape[1:]))
