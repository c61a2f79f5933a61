"""Weights from the seed, made on the device in a few large draws.

Conv weights are LeCun-normal (the port's and the JAX package's init),
biases normal with std `BIAS_STD` (not zero, so that the support-pruned
geometry's ring-pad constants, which follow from the biases, are not all
zero), and FCN-32s's `seenmask_upscore` its bilinear init. FCN-8s's skip
heads are drawn like every other conv: a zero init would leave the skips
out of what is compared. The 1x1 heads' rows are centred (zero mean over
their input channels): the trunk's ReLU outputs share a common positive
part, which a random row turns into one class and one gate decision for
nearly every pixel of an image; centred, labels and gate vary across the
image, so the check meets many near decisions. Both the program and the
reference take these tensors, drawn anew for each, so neither reads the
other's.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.fcn import bilinear_upscore, param_shapes

BIAS_STD = 0.1
HEADS = ("score_fr", "seenmask_score", "score_pool3", "score_pool4")


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """name -> fp32 tensor on `device` for every parameter of the
    configuration, drawn from `seed`."""
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    out = {}
    for suffix in (".weight", ".bias"):
        names = [n for n in shapes if n.endswith(suffix)
                 and n != "seenmask_upscore.weight"]
        flat = torch.randn(sum(math.prod(shapes[n]) for n in names),
                           generator=gen, device=device)
        at = 0
        for n in names:
            k = math.prod(shapes[n])
            t = flat[at:at + k].view(shapes[n])
            t.mul_(1.0 / math.sqrt(k // shapes[n][0]) if suffix == ".weight"
                   else BIAS_STD)
            out[n] = t
            at += k
    for h in HEADS:
        if f"{h}.weight" in out:
            w = out[f"{h}.weight"]
            w.sub_(w.mean(dim=1, keepdim=True))
    if "seenmask_upscore.weight" in shapes:
        c, _, k, _ = shapes["seenmask_upscore.weight"]
        out["seenmask_upscore.weight"] = torch.from_numpy(
            bilinear_upscore(c, k)).to(device)
    return {n: out[n] for n in shapes}
