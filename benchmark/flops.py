"""Operations the benchmark counts: the convolutions of the configurations'
forward and backward passes at an image's own size, frozen here so that
later changes to the program cannot move the yardstick.

Only convolutions count (the 13 VGG convs, fc6, fc7 and the 1x1 heads,
plus FCN-32s's learned seenmask upsample in stage 2): the fixed bilinear
upsamples, the label and loss tails, pools and elementwise work are left
out, so an `mfu` built on these counts is a lower bound. One multiply-add
is 2 operations.

The geometry is the port's support-pruned one (the port's
models/pruned.py, whose integer simulation `_pruned` copies): blocks 1 to
`pruned_blocks` run VALID convs over the input's support grown by one
pixel a conv, with even alignment pads before each pool; the rest of the
trunk runs on the virtual pad-100 sizes. Where the plan does not hold for
a size, a shallower one or the plain pad-100 stack is counted, as the
port falls back.
"""

from __future__ import annotations

MIN_SIDE = 16
PROBE_BASE = 16
FRAME_RIM = 3


def _probe_side(side: int, blocks: int) -> int:
    return PROBE_BASE + side % (1 << blocks)


def _pruned(h: int, w: int, pad1: int, convs: list, blocks: int):
    """[(oh, ow) of each conv of the first `blocks` blocks] of the pruned
    run, or None where the plan does not hold (the port's `plan_blocks`,
    with each conv's output recorded)."""
    if min(h, w) < MIN_SIDE or blocks > len(convs):
        return None
    s0, rim = 0, 0
    sz = [h, w]
    v = [h + 2 * pad1 - 2, w + 2 * pad1 - 2]
    pv = [_probe_side(h, blocks) + 2 * pad1 - 2,
          _probe_side(w, blocks) + 2 * pad1 - 2]
    outs = []
    for bi in range(blocks):
        for ci in range(convs[bi]):
            first = bi == 0 and ci == 0
            if not first and not (
                    s0 - 2 >= rim and s0 + sz[0] + 2 + rim <= v[0]
                    and s0 + sz[1] + 2 + rim <= v[1]):
                return None
            sz = [s + 2 for s in sz]
            outs.append(tuple(sz))
            s0 += (pad1 - 2) if first else -1
            if not first:
                rim += 1
        if s0 % 2:
            if s0 - 1 < rim:
                return None
            s0 -= 1
            sz = [s + 1 for s in sz]
        for d in range(2):
            if sz[d] % 2:
                if s0 + sz[d] + 1 + rim > v[d]:
                    return None
                sz[d] += 1
        s0 //= 2
        sz = [s // 2 for s in sz]
        v = [-(-x // 2) for x in v]
        pv = [-(-x // 2) for x in pv]
        rim = -(-rim // 2)
    if rim > FRAME_RIM:
        return None
    for d in range(2):
        if min(pv[d] // 2, pv[d] - pv[d] // 2 - 1) < FRAME_RIM \
                or v[d] < pv[d]:
            return None
    return outs


def virtual_sides(side: int, pad1: int, blocks: int) -> list[int]:
    """The side of each block's conv output in the plain pad-100 geometry
    and, last, of pool5: [block 1, ..., block 5, pool5]."""
    s = side + 2 * pad1 - 2
    out = []
    for _ in range(blocks):
        out.append(s)
        s = -(-s // 2)
    return out + [s]


def trunk_convs(cfg: dict, h: int, w: int) -> list[tuple]:
    """[(name, cin, cout, k, oh, ow)] of the trunk's convolutions (13 VGG,
    fc6, fc7) as the port runs them on an (h, w) image."""
    vgg = cfg["vgg"]
    pad1 = cfg["pad_conv1"]
    vh = virtual_sides(h, pad1, len(vgg))
    vw = virtual_sides(w, pad1, len(vgg))
    convs = [len(b) for b in vgg]
    outs, depth = None, 0
    if cfg.get("prune_pad", True):
        for nb in range(cfg.get("pruned_blocks", 4), 2, -1):
            outs = _pruned(h, w, pad1, convs, nb)
            if outs is not None:
                depth = nb
                break
    res, cin, k = [], 3, 0
    for bi, blk in enumerate(vgg):
        for ci, cout in enumerate(blk):
            if bi < depth:
                oh, ow = outs[k]
            else:
                oh, ow = vh[bi], vw[bi]
            res.append((f"conv{bi + 1}_{ci + 1}", cin, cout, 3, oh, ow))
            cin, k = cout, k + 1
    kk = cfg["fc6_kernel"]
    fh, fw = vh[-1] - kk + 1, vw[-1] - kk + 1
    res.append(("fc6", cin, cfg["fc6_channels"], kk, fh, fw))
    res.append(("fc7", cfg["fc6_channels"], cfg["fc7_channels"], 1, fh, fw))
    return res


def head_side(cfg: dict, side: int) -> int:
    """The side of the 1/32 heads (fc6's output) for an input side."""
    return virtual_sides(side, cfg["pad_conv1"], len(cfg["vgg"]))[-1] \
        - cfg["fc6_kernel"] + 1


def _head_convs(cfg: dict, h: int, w: int, names) -> list[tuple]:
    fh, fw = head_side(cfg, h), head_side(cfg, w)
    pad1, nb = cfg["pad_conv1"], len(cfg["vgg"])
    vh, vw = virtual_sides(h, pad1, nb), virtual_sides(w, pad1, nb)
    f7, e = cfg["fc7_channels"], cfg["embed_dim"]
    shapes = {"score_fr": (f7, e, fh, fw),
              "seenmask_score": (f7, cfg["seenmask_channels"], fh, fw),
              # the skips read the pools: pool3 and pool4 at their sides
              "score_pool3": (cfg["vgg"][2][-1], e, -(-vh[2] // 2),
                              -(-vw[2] // 2)),
              "score_pool4": (cfg["vgg"][3][-1], e, -(-vh[3] // 2),
                              -(-vw[3] // 2))}
    return [(n, shapes[n][0], shapes[n][1], 1, shapes[n][2], shapes[n][3])
            for n in names]


def conv_flops(cin: int, cout: int, k: int, oh: int, ow: int) -> int:
    return 2 * cin * cout * k * k * oh * ow


def _sum(convs) -> int:
    return sum(conv_flops(*c[1:]) for c in convs)


def _skips(cfg: dict) -> tuple:
    return ("score_pool3", "score_pool4") if cfg["arch"] == "fcn8s" else ()


def forward_flops(cfg: dict, h: int, w: int) -> int:
    """Serving: the trunk and every head, one (h, w) image."""
    return _sum(trunk_convs(cfg, h, w) + _head_convs(
        cfg, h, w, ("score_fr", "seenmask_score") + _skips(cfg)))


def stage1_flops(cfg: dict, h: int, w: int) -> int:
    """Stage 1 (the "fcn" mode: the embedding head, no seenmask head):
    the forward, and a backward of twice the forward for every conv but
    conv1_1, whose input needs no gradient (once: its weights')."""
    convs = trunk_convs(cfg, h, w) + _head_convs(
        cfg, h, w, ("score_fr",) + _skips(cfg))
    fwd = _sum(convs)
    return 3 * fwd - conv_flops(*convs[0][1:])


def stage2_flops(cfg: dict, h: int, w: int) -> int:
    """Stage 2: the frozen trunk's forward; the seenmask head forward and
    its weights' gradient; FCN-32s's learned x32 upsample (a transposed
    conv of the head's channels, kernel `upsample_kernel`, stride
    `upsample_stride`: each input pixel spreads a k x k patch a channel
    pair) forward, input gradient and weight gradient."""
    fwd = _sum(trunk_convs(cfg, h, w))
    (head,) = _head_convs(cfg, h, w, ("seenmask_score",))
    out = fwd + 2 * conv_flops(*head[1:])
    if cfg["arch"] == "fcn32s":
        c, kk = cfg["seenmask_channels"], cfg["upsample_kernel"]
        up = 2 * c * c * kk * kk * head[4] * head[5]
        out += 3 * up
    return out


def vgg16_plain_flops(h: int, w: int, widths=((64, 64), (128, 128),
                                              (256, 256, 256),
                                              (512, 512, 512),
                                              (512, 512, 512))) -> int:
    """The 13 convolutions of VGG16 as published (pad 1, floor pools) on
    an (h, w) image: the yardstick's check against the paper's count."""
    total, cin = 0, 3
    for blk in widths:
        for cout in blk:
            total += conv_flops(cin, cout, 3, h, w)
            cin = cout
        h, w = h // 2, w // 2
    return total
