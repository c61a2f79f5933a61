"""K5/K6's launch plan (`ops.costail_fused.costail_plan`) on the CPU: on a
132-SM H100 (227 KB of shared memory a block, 228 KB an SM, 1 KB
reserved a block) every pixel is covered exactly once, every bulk copy
is 16-byte aligned in address and size with the ragged tail left to plain
loads, the stages and tables fit, and the partial sums taken in the plan's
block and tile order meet the JAX Pallas tail (interpret mode, as
tests/test_costail_fused.py runs it). The kernels run in
tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotsemanticsegmentation_tpu.ops.costail_fused import (
    fused_cos_tail as j_tail)
from zeroshotsemanticsegmentation_tpu_torch.ops import costail_fused as tct
from zeroshotsemanticsegmentation_tpu_torch.ops.losses import l2_normalize

torch.set_num_threads(1)

H100 = dict(sms=132, smem_block=232448, smem_sm=233472, smem_reserved=1024)
# the bundled widths with their tables' class counts (pascal K=21, context
# K=33) and the one-hot tables
WIDTHS = [(2, 21), (5, 21), (10, 21), (20, 21), (21, 21), (50, 21),
          (100, 21), (200, 33), (300, 33), (33, 33), (59, 59)]
# (B, H, W): the train step's, an odd H*W (353x375, with C=21 and C=5 a
# sample base off 16-byte alignment), and fewer pixels than one tile
GEOMS = [(24, 512, 512), (2, 353, 375), (1, 3, 5)]


def _plan(b, h, w, c, k, forward, **limits):
    return tct.costail_plan(b, h * w, c, k, k, forward=forward,
                            **(limits or H100))


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("c,k", WIDTHS)
def test_plan_fits_and_fills_the_card(c, k, forward):
    """The stages and tables fit a block's 227 KB and the blocks an SM's
    228 KB; 3 or 4 stages; the register form for the template widths; the
    grid is the blocks that fit at once, at most one per tile."""
    plan = _plan(24, 512, 512, c, k, forward)
    assert plan["smem"] <= H100["smem_block"]
    assert plan["blocks_per_sm"] * (plan["smem"] + H100["smem_reserved"]) \
        <= H100["smem_sm"]
    assert plan["stages"] in (3, 4) and plan["tile"] % 4 == 0
    assert plan["form"] == ("regs" if c in tct.REG_WIDTHS else "wide")
    if plan["form"] == "regs":
        assert (plan["tile"], plan["threads"]) == (256, 128)
    else:
        assert plan["tile"] % 8 == 0 and plan["tile"] <= 64
        assert plan["threads"] == plan["tile"] // 2 * 8 <= 256
    assert plan["grid"] == min(plan["tiles"], 132 * plan["blocks_per_sm"])
    assert plan["smem"] == tct.plan_smem(forward, plan["form"] == "wide",
                                         plan["tile"], plan["stages"], c, k,
                                         k)


def test_plan_main_path_widths():
    """C=20 (K=21): three 256-pixel stages, three blocks an SM; C=300
    (K=33): the forward's 32-pixel tiles leave room for both tables, one
    block an SM; the backward keeps two blocks an SM with 24-pixel tiles
    and leaves the target table's 40 KB to L1."""
    for forward in (True, False):
        p20 = _plan(24, 512, 512, 20, 21, forward)
        assert (p20["stages"], p20["blocks_per_sm"], p20["grid"]) \
            == (3, 3, 396)
    p300 = _plan(24, 512, 512, 300, 33, True)
    assert (p300["tile"], p300["stages"], p300["threads"], p300["grid"]) \
        == (32, 3, 128, 132)
    b300 = _plan(24, 512, 512, 300, 33, False)
    assert (b300["tile"], b300["stages"], b300["blocks_per_sm"]) \
        == (24, 3, 2)
    assert 2 * (b300["smem"] + 1024) + 33 * 300 * 4 <= H100["smem_sm"]


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("c,k", WIDTHS)
def test_plan_covers_pixels_with_aligned_copies(c, k, geom):
    """Blocks run disjoint contiguous runs of tiles that together cover
    every tile once; tiles cover every pixel once; each bulk copy starts
    at a 16-byte multiple from its base and moves a 16-byte multiple, and
    only the tensor's last tile leaves floats (< 16 bytes) to plain
    loads."""
    b, h, w = geom
    plan = _plan(b, h, w, c, k, True)
    runs = [tct.block_tiles(plan, g) for g in range(plan["grid"])]
    assert all(len(r) > 0 for r in runs)
    tiles = [t for r in runs for t in r]
    assert tiles == list(range(plan["tiles"]))
    pixels = 0
    for t in tiles:
        cp = tct.tile_copies(plan, t, c)
        assert cp["p0"] == pixels and 0 < cp["np"] <= plan["tile"]
        pixels += cp["np"]
        for key in ("score_offset", "score_bulk", "label_offset",
                    "label_bulk"):
            assert cp[key] % 16 == 0, (t, key, cp)
        assert cp["score_bulk"] + 4 * cp["score_tail"] == cp["np"] * c * 4
        assert cp["label_bulk"] + 4 * cp["label_tail"] == cp["np"] * 4
        assert 4 * cp["score_tail"] < 16 and 4 * cp["label_tail"] < 16
        if t != plan["tiles"] - 1:
            assert cp["score_tail"] == cp["label_tail"] == 0
    assert pixels == b * h * w


def test_odd_geometry_takes_a_plain_tail():
    """353x375 at C=21: the last 256-pixel tile holds 23 pixels, 483
    floats, whose last 3 (and the last 3 of its 23 labels) lie past the
    last 16-byte multiple and come by plain loads."""
    plan = _plan(1, 353, 375, 21, 21, True)
    cp = tct.tile_copies(plan, plan["tiles"] - 1, 21)
    assert cp["np"] == 23
    assert (cp["score_tail"], cp["label_tail"]) == (3, 3)


def test_plan_refuses_tables_past_shared_memory():
    with pytest.raises(ValueError, match="no room"):
        tct.costail_plan(2, 64, 2000, 127, 127, forward=True, **H100)


def _ordered_sums(plan, cos, valid, ssum_px, b, hw):
    """The forward's partials in the plan's order: per block, per sample
    its run touches, the sum over its tiles in order; then the blocks
    added in order (csrc `costail_finalize`)."""
    grid = plan["grid"]
    cos_part = np.zeros((b, grid), np.float32)
    nv_part = np.zeros((b, grid), np.int64)
    ss_part = np.zeros(grid, np.float32)
    for g in range(grid):
        for t in tct.block_tiles(plan, g):
            cp = tct.tile_copies(plan, t, 1)
            for p in range(cp["p0"], cp["p0"] + cp["np"]):
                s = p // hw
                cos_part[s, g] += np.float32(cos[p] if valid[p] else 0.0)
                nv_part[s, g] += int(valid[p])
                ss_part[g] += ssum_px[p]
    cs = np.zeros(b, np.float32)
    for g in range(grid):
        cs += cos_part[:, g]
    nv = nv_part.sum(1).astype(np.float32)
    ssum = np.float32(0.0)
    for g in range(grid):
        ssum += ss_part[g]
    return (nv - cs) / np.maximum(nv, 1.0), ssum


@pytest.mark.parametrize("shape,c,k,sms", [((3, 37, 53), 20, 21, 3),
                                           ((2, 13, 11), 21, 21, 2),
                                           ((4, 9, 7), 50, 21, 1)])
def test_plan_order_sums_match_jax(rng, shape, c, k, sms):
    """The plain version's per-pixel terms summed in the plan's order (few
    SMs, so runs cross sample boundaries and tiles hold several samples)
    meet the JAX tail's losses and score sum at rtol 1e-5."""
    b, h, w = shape
    score = rng.randn(b, h, w, c).astype(np.float32)
    score[:, :2, :3] = 0.0
    label = rng.randint(-1, k, (b, h, w)).astype(np.int32)
    temb = rng.randn(k, c).astype(np.float32)
    iemb = rng.randn(k, c).astype(np.float32)
    limits = dict(H100, sms=sms)
    plan = _plan(b, h, w, c, k, True, **limits)
    assert plan["grid"] > 1
    s = torch.from_numpy(score).reshape(-1, c)
    lbl = torch.from_numpy(label).reshape(-1).long()
    t = l2_normalize(torch.from_numpy(temb))
    inside = (lbl >= 0) & (lbl < k)
    that = torch.where(inside[:, None], t[lbl.clamp(0, k - 1)],
                       torch.zeros(()))
    cos = (l2_normalize(s) * that).sum(-1).numpy()
    losses, ssum = _ordered_sums(plan, cos, (lbl >= 0).numpy(),
                                 s.sum(-1).numpy(), b, h * w)
    want = j_tail(jnp.asarray(score), jnp.asarray(label), jnp.asarray(temb),
                  jnp.asarray(iemb), k, tile=256)
    np.testing.assert_allclose(losses, np.asarray(want[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ssum, float(want[2]), rtol=1e-5,
                               atol=1e-7 * float(np.abs(score).sum()))
