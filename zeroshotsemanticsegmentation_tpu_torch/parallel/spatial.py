"""Height-sharded (spatial) serving: the band plan and a rank's view of it.

One image too large for one card's memory or latency (a panorama at batch
1) is split by height over the mesh's 'data' axis, as the JAX package's
spatial predictor shards it (`P(None, "data", None, None)`); fc6 / fc7 stay
split over 'model' and the 'slice' ranks of a multislice mesh repeat the
same bands. Each rank holds a band of rows at every level of the network
and, where GSPMD inserted them in the JAX package, the collectives are
placed by hand (`parallel.mesh`):

* every 3x3 convolution takes one row from each neighbour
  (`exchange_halo`); the outermost bands pad as the one-device path does
  (the ring constants of the support-pruned blocks, zeros after them);
* every pool needs band boundaries on even rows of the one-device grid,
  so no window straddles two ranks;
* fc6 (7x7 VALID) takes the 6 rows below its band;
* from `depth` on (the pools computed on bands) the rows are gathered
  (`gather_height`) and the rest runs whole on every rank;
* the raw heads are gathered (C channels at 1/32 resolution), then each
  rank computes its rows of the full-resolution output (`out_rows`).

Coordinates are those of the one-device grid of each level ("virtual
rows"): level 0 is the conv1 output grid of the pad-100 geometry (H + 198
rows), level k the grid after k pools (ceil halving), level 6 fc6's
output. A band boundary stays at the same virtual row through a block's
convolutions and halves at its pool. The boundaries are chosen once, at
level 0, as multiples of 2^depth near an even split of the image's
support, so they follow the one-device alignment at every pool. Every
rank receives the whole image (the mesh predictor's contract), so block 1
slices its input rows with their halo from the image and exchanges
nothing.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from zeroshotsemanticsegmentation_tpu_torch.models.pruned import (
    NUM_PRUNED_BLOCKS, _BLOCK_CONVS, plan_blocks, prunable)
from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
    DATA_AXIS, exchange_halo, gather_height)

PAD_CONV1 = 100   # the pad-100 geometry (models.fcn32s._PAD_CONV1)
CONV_HALO = 1     # rows a 3x3 convolution takes from each neighbour
FC6_HALO = 6      # rows fc6 (7x7 VALID) takes from the band below
NUM_LEVELS = 5    # pools of VGG16


class BandPlan(NamedTuple):
    """`bounds[level]`: the n + 1 virtual-row boundaries of the bands at
    each banded level (0 .. depth, and 6 when fc6 runs on bands); band r
    holds rows [bounds[r], bounds[r + 1]). `heights[level]`: the one-device
    grid's rows at levels 0-5. `pruned`: the support-pruned depth (the
    model's `plan_blocks` choice). `out_rows`: the boundaries of each
    band's output rows (full resolution)."""
    n: int
    pruned: int
    depth: int
    fc6: bool
    bounds: dict
    heights: tuple
    out_rows: tuple

    def rows(self, level: int, r: int) -> tuple:
        b = self.bounds[level]
        return b[r], b[r + 1]


def _heights(in_h: int) -> tuple:
    hs = [in_h + 2 * PAD_CONV1 - 2]
    for _ in range(NUM_LEVELS):
        hs.append(-(-hs[-1] // 2))
    return tuple(hs)


def _data_regions(in_h: int, pruned: int) -> list:
    """The rows of the one-device support-pruned data path, [s0, e) in
    virtual rows, that each pruned block's first exchanging convolution
    reads (level 0: conv1_1's output, which conv1_2 reads), as
    `run_pruned_blocks` grows and re-aligns them."""
    s0, e = PAD_CONV1 - 2, in_h + PAD_CONV1
    regions = []
    for bi in range(pruned):
        regions.append((s0, e))
        convs = _BLOCK_CONVS[bi] - (1 if bi == 0 else 0)
        s0, e = s0 - convs, e + convs
        s0 -= s0 % 2
        e += e % 2
        s0, e = s0 // 2, e // 2
    return regions


def _check(inner, depth: int, fc6: bool, heights, regions):
    """Why bands with level-0 inner boundaries `inner` cannot run `depth`
    pools (and fc6) on bands; None when they can."""
    for level in range(depth + 1):
        b = [x >> level for x in inner]
        if any(x << level != y for x, y in zip(b, inner)):
            return f"a boundary is not even at pool {level}"
        full = [0, *b, heights[level]]
        if any(lo >= hi for lo, hi in zip(full, full[1:])):
            return f"a band at level {level} holds no row"
        if level < len(regions) and b:
            s0, e = regions[level]
            if not s0 < b[0] or not b[-1] < e:
                return (f"a band at level {level} holds no row of the "
                        f"image's support [{s0}, {e})")
    if fc6:
        full = [0, *[x >> NUM_LEVELS for x in inner], heights[NUM_LEVELS]]
        sizes = [hi - lo for lo, hi in zip(full, full[1:])]
        if sizes[-1] <= FC6_HALO or min(sizes[1:], default=FC6_HALO) \
                < FC6_HALO:
            return (f"bands of {sizes} rows at pool5 are thinner than fc6's "
                    f"{FC6_HALO}-row halo")
    return None


@functools.lru_cache(maxsize=64)
def plan_bands(in_h: int, in_w: int, n: int,
               depth: int = NUM_PRUNED_BLOCKS) -> BandPlan:
    """The band plan of an in_h x in_w image over `n` bands, for a model
    whose support-pruned run is at most `depth` blocks deep (FCN-32s 4,
    FCN-8s 3). Pure integer arithmetic, like `models.pruned.plan_blocks`.

    It takes the deepest of: every pool and fc6 on bands; every pool on
    bands and fc6 whole; the first 4, then 3 pools on bands; never fewer
    than the pruned blocks. A depth is refused where a band would be
    thinner than its halo (or hold no row of the image's support in a
    pruned block), or a boundary would not be even at a pool. Raises
    ValueError with the reasons when no depth serves the geometry, or when
    the geometry has no support-pruned plan (the bands follow it)."""
    if n < 1 or in_h < n:
        raise ValueError(f"plan_bands: {in_h} rows cannot make {n} bands")
    pruned = next((d for d in range(depth, 2, -1)
                   if prunable(in_h, in_w)
                   and plan_blocks(in_h, in_w, PAD_CONV1, d)), None)
    if pruned is None:
        raise ValueError(f"plan_bands: {in_h}x{in_w} has no support-pruned "
                         "plan (models.pruned.plan_blocks), and the bands "
                         "follow its geometry")
    heights = _heights(in_h)
    regions = _data_regions(in_h, pruned)
    s0, e = regions[0]
    out_rows = tuple(in_h * r // n for r in range(n + 1))
    reasons = []
    for d, fc6 in ((5, True), (5, False), (4, False), (3, False)):
        if d < pruned:
            break
        align = 1 << d
        inner = [align * math.floor((s0 + (e - s0) * r / n) / align + 0.5)
                 for r in range(1, n)]
        why = _check(inner, d, fc6, heights, regions)
        if why is None:
            bounds = {lv: (0, *[x >> lv for x in inner], heights[lv])
                      for lv in range(d + 1)}
            if fc6:
                bounds[6] = (*bounds[NUM_LEVELS][:-1],
                             heights[NUM_LEVELS] - FC6_HALO)
            return BandPlan(n, pruned, d, fc6, bounds, heights, out_rows)
        reasons.append(f"{d} pools{' and fc6' if fc6 else ''} on bands: "
                       f"{why}")
    raise ValueError(f"plan_bands: {in_h}x{in_w} over {n} bands: "
                     + "; ".join(reasons))


class Bands:
    """This rank's band of a `BandPlan` on `mesh` (its 'data' coordinate),
    with the height collectives the forward calls. `mesh` is a
    `parallel.mesh.Mesh`, or any object with its `shape`, `coords`,
    `data_size`, `data_rank` and `all_reduce`."""

    def __init__(self, plan: BandPlan, mesh):
        n = mesh.shape[DATA_AXIS]
        if n != plan.n:
            raise ValueError(f"a plan of {plan.n} bands on a mesh whose "
                             f"'data' axis is {n}")
        self.plan, self.mesh = plan, mesh
        self.r = mesh.coords[DATA_AXIS]
        self.first, self.last = self.r == 0, self.r == n - 1

    def rows(self, level: int) -> tuple:
        """This band's virtual rows [lo, hi) at `level`."""
        return self.plan.rows(level, self.r)

    def out_rows(self) -> tuple:
        """This band's rows of the full-resolution output."""
        o = self.plan.out_rows
        return o[self.r], o[self.r + 1]

    def conv_on_bands(self, block: int) -> bool:
        """Whether block `block` (0-based)'s convolutions run on bands."""
        return block < self.plan.depth

    def kept(self, level: int) -> bool:
        """Whether a tensor at `level` stays split into bands (not
        gathered): the levels before `depth`, and pool5 and fc6's output
        when fc6 runs on bands."""
        if level == 6 or level == NUM_LEVELS:
            return self.plan.fc6
        return level < self.plan.depth

    def settle(self, t: torch.Tensor, level: int, dim: int) -> torch.Tensor:
        """A band just computed at `level`: gathered whole when `level` is
        the last banded one, else as it is."""
        if level == self.plan.depth and not self.kept(level):
            return gather_height(t, self.mesh, self.plan.bounds[level], dim)
        return t

    def whole(self, t: torch.Tensor, level: int, dim: int) -> torch.Tensor:
        """`t` at `level` whole: gathered if it is split into bands."""
        if self.kept(level):
            return gather_height(t, self.mesh, self.plan.bounds[level], dim)
        return t

    def halo(self, t: torch.Tensor, top: int, bottom: int, dim: int):
        return exchange_halo(t, top, bottom, self.mesh, dim)

    def rows3x3(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The band with the row each neighbour gives a 3x3 convolution,
        and a zero row at an outer edge (the one-device pad of 1); the
        columns are left to the caller."""
        above, below = self.halo(t, CONV_HALO, CONV_HALO, dim)

        def zero():
            return torch.zeros_like(t.narrow(dim, 0, CONV_HALO))

        parts = [zero() if self.first else above, t,
                 zero() if self.last else below]
        return torch.cat(parts, dim=dim)

    def fc6_input(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The pool5 band with the 6 rows below it (none on the last)."""
        _, below = self.halo(t, 0, FC6_HALO, dim)
        return t if below is None else torch.cat([t, below], dim=dim)
