"""DeepLab-v2 ResNet-101's weights from the seed, made on the device.

As `benchmark/weights.py` draws FCN's: convolution kernels LeCun-normal,
the ASPP heads' biases N(0, `BIAS_STD`^2), and the heads' rows centred over
their input channels (so that labels and gate vary across an image). Each
frozen batch norm's weight is 1 + N(0, `BIAS_STD`^2) and its bias
N(0, `BIAS_STD`^2), but the last batch norm of each bottleneck's branch
(`bn3`) takes `BRANCH_SCALE` times those, as trained ResNets' small
last-BN weights and Goyal et al.'s zero init of them (arXiv:1706.02677)
keep each block near its shortcut: with weights near 1 the 33 blocks
amplify rounding until bf16's heads and fp32's part ways (relative
difference 0.94 at 1, 0.12 at 0.25, 0.028 at 0.05; CPU, 1/16 of the
widths, 128^2), and no check could tell a right program from a wrong
one. Every batch norm's running mean and variance are calibrated: one
seeded batch of `CAL_IMAGES` uniform uint8 images of `CAL_SIDE`^2 goes
through the fp32 reference (`reference.deeplab.trunk(..., calibrate=True)`),
and each batch norm takes the statistics of its input there, in order, as
its own running estimate would. Random statistics would blow the
activations up or collapse them over 33 residual blocks; calibrated, each
block's output stays O(1). Both the program and the reference take these
tensors, drawn anew for each (the draw and the calibration run with TF32
off, so the two draws are the same).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import deeplab as ref

BIAS_STD = 0.1
BRANCH_SCALE = 0.05
CAL_IMAGES = 2
CAL_SIDE = 256
HEADS = ("aspp_score", "aspp_seenmask")


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """name -> fp32 tensor on `device` for every tensor of the
    configuration's state dict, drawn from `seed`."""
    shapes = ref.param_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    kernels = [n for n, s in shapes.items() if len(s) == 4]
    vectors = [n for n, s in shapes.items() if len(s) == 1
               and not n.endswith((".running_mean", ".running_var"))]
    out = {}
    for names, fan_scaled in ((kernels, True), (vectors, False)):
        flat = torch.randn(sum(math.prod(shapes[n]) for n in names),
                           generator=gen, device=device)
        at = 0
        for n in names:
            k = math.prod(shapes[n])
            t = flat[at:at + k].view(shapes[n])
            t.mul_(1.0 / math.sqrt(k // shapes[n][0]) if fan_scaled
                   else BIAS_STD)
            if n.endswith(".weight") and not fan_scaled:  # a BN's scale
                t.add_(1.0)
            out[n] = t
            at += k
    for n in vectors:
        if n.endswith((".bn3.weight", ".bn3.bias")):
            out[n].mul_(BRANCH_SCALE)
    for n in kernels:
        if n.startswith(HEADS):
            out[n].sub_(out[n].mean(dim=1, keepdim=True))
    for n, s in shapes.items():
        if n.endswith(".running_mean"):
            out[n] = torch.zeros(s, device=device)
        elif n.endswith(".running_var"):
            out[n] = torch.ones(s, device=device)
    images = torch.randint(0, 256, (CAL_IMAGES, CAL_SIDE, CAL_SIDE, 3),
                           generator=gen, device=device, dtype=torch.uint8)
    with torch.no_grad():
        ref.trunk(cfg, out, ref.normalize(images), calibrate=True)
    return {n: out[n] for n in shapes}
