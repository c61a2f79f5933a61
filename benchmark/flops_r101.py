"""Operations and bytes the benchmark counts for DeepLab-v2 ResNet-101, from
the configuration and the shapes alone, frozen here so that later changes
to the program cannot move the yardstick.

Only convolutions count (the stem, the bottlenecks' 1x1 and 3x3s, the
downsamples, the ASPP branches of both heads): batch norm (folded), pools,
residual adds, ReLUs and the upsample are left out, so an `mfu` built on
these counts is a lower bound. One multiply-add is 2 operations. Every
convolution of a stage runs at the stage's output sides (the stride sits on
its first 1x1 and downsample).

Sides: the stem's 7x7/2 (pad 3) gives ceil(s / 2), the 3x3/2 ceil-mode pool
(pad 0) ceil((s - 3) / 2) + 1, each stride-2 stage ceil(s / 2): a 512 side
gives 128 after the stem and 64 from `layer2` on.
"""

from __future__ import annotations

from benchmark.flops import conv_flops
from benchmark.reference.deeplab import width


def stem_side(side: int) -> int:
    s = -(-side // 2)
    return -(-(s - 3) // 2) + 1


def stage_sides(cfg: dict, side: int) -> list[int]:
    """The output side of each of the four stages."""
    out, s = [], stem_side(side)
    for stride in cfg["strides"]:
        s = -(-s // stride)
        out.append(s)
    return out


def head_side(cfg: dict, side: int) -> int:
    """The side of the 1/8 heads for an input side."""
    return stage_sides(cfg, side)[-1]


def heads_out(cfg: dict) -> int:
    return cfg["embed_dim"] + cfg["seenmask_channels"]


def stage_flops(cfg: dict, si: int, batch: int, h: int, w: int) -> int:
    """Stage `si` (0-based) at output sides (h, w), `batch` images."""
    inner, out = (width(cfg, f) for f in cfg["widths"][si])
    cin = width(cfg, cfg["stem_channels"] if si == 0
                else cfg["widths"][si - 1][1])
    total = 0
    for bi in range(cfg["blocks"][si]):
        c0 = cin if bi == 0 else out
        total += (conv_flops(c0, inner, 1, h, w)
                  + conv_flops(inner, inner, 3, h, w)
                  + conv_flops(inner, out, 1, h, w))
        if bi == 0:
            total += conv_flops(c0, out, 1, h, w)
    return batch * total


def stem_flops(cfg: dict, batch: int, h: int, w: int) -> int:
    """The stem's 7x7 convolution of (h, w) images."""
    return batch * conv_flops(3, width(cfg, cfg["stem_channels"]), 7,
                              -(-h // 2), -(-w // 2))


def aspp_ops_bytes(cfg: dict, batch: int, h: int, w: int) -> tuple:
    """(operations, bytes) of both ASPP heads at 1/8 sides (h, w): each rate
    reads the last stage's bf16 output once and its bf16 weights (both
    heads' rows), and writes its bf16 output of both heads' channels."""
    cin = width(cfg, cfg["widths"][-1][1])
    cout, rates = heads_out(cfg), len(cfg["aspp_rates"])
    ops = rates * batch * conv_flops(cin, cout, 3, h, w)
    nbytes = rates * 2 * (batch * h * w * cin + cout * cin * 9
                          + batch * h * w * cout)
    return ops, nbytes


def forward_flops(cfg: dict, h: int, w: int) -> int:
    """Serving: the trunk and both heads, one (h, w) image."""
    hs = stage_sides(cfg, h)
    ws = stage_sides(cfg, w)
    return (stem_flops(cfg, 1, h, w)
            + sum(stage_flops(cfg, si, 1, hs[si], ws[si]) for si in range(4))
            + aspp_ops_bytes(cfg, 1, hs[-1], ws[-1])[0])
