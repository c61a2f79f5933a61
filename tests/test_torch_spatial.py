"""Height-sharded (spatial) serving and the int8 scales on a mesh, in one
process on the CPU.

`plan_bands` is held to its invariants over many geometries (hypothesis):
the bands partition every banded level, every halo lies inside the
neighbour (or the level is gathered), and every pool boundary is even on
the one-device grid, checked against a support simulation written here.
The banded forward runs all bands of one image in threads of this process
(`ThreadMesh`: its `all_reduce` adds or maxes the threads' tensors, so the
height collectives of `parallel.mesh` pass each band's halo rows to its
neighbours) and must equal the one-device forward and labels: at
tests/test_serving.py's (1, 64, 96) over 4 bands (pool5 too thin for
fc6's halo, so the rows are gathered before block 5) and at (1, 256, 64)
over 2 (bands through fc6 and the heads). Setup: `channel_scale` 1/16,
fp32, 8 classes, one thread each.
"""

import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from zeroshotsemanticsegmentation_tpu_torch.models import FCN8s, FCN32s
from zeroshotsemanticsegmentation_tpu_torch.models import quantized as tq
from zeroshotsemanticsegmentation_tpu_torch.models.pruned import (
    assemble_frame, plan_blocks)
from zeroshotsemanticsegmentation_tpu_torch.ops.szn_fused import (
    infer_labels_szn_fused)
from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
    all_reduce_max, exchange_halo, gather_height)
from zeroshotsemanticsegmentation_tpu_torch.parallel.spatial import (
    FC6_HALO, Bands, plan_bands)

torch.set_num_threads(1)

C = 8
SCALE = 1 / 16
UNSEEN = np.isin(np.arange(C), [1, 3])
BLOCK_CONVS = (2, 2, 3, 3, 3)


class _Board:
    """One group's all-reduce among threads: each posts its tensor, all
    read the posts in rank order."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n, timeout=120)
        self.posts = [None] * n

    def reduce(self, i: int, t: torch.Tensor, op: str) -> None:
        self.posts[i] = t.clone()
        self.barrier.wait()
        posts = list(self.posts)
        self.barrier.wait()
        acc = posts[0]
        for p in posts[1:]:
            acc = acc + p if op == "sum" else torch.maximum(acc, p)
        t.copy_(acc)


class ThreadMesh:
    """A ('data', 'model') or ('slice', 'data', 'model') mesh of threads:
    the attributes the height collectives and the int8 forward read, and
    `all_reduce` (its data group spans 'slice' and 'data', as
    `parallel.mesh.Mesh`'s does)."""

    def __init__(self, sizes, rank: int, boards):
        *outer, model = sizes
        slices, data = outer if len(outer) == 2 else (1, outer[0])
        self.shape = {"data": data, "model": model}
        self.data_size, self.model_size = slices * data, model
        self.data_rank, self.model_rank = divmod(rank, model)
        self.coords = {"data": self.data_rank % data,
                       "model": self.model_rank}
        if len(outer) == 2:
            self.shape["slice"] = slices
            self.coords["slice"] = self.data_rank // data
        self.boards = boards

    def all_reduce(self, t, axes=("data",), op="sum"):
        for axis in axes:
            if axis == "data":
                board = self.boards["data", self.model_rank]
                board.reduce(self.data_rank, t, op)
            else:
                board = self.boards["model", self.data_rank]
                board.reduce(self.model_rank, t, op)


def run_threads(sizes, fn) -> list:
    """fn(mesh) on every rank of a ThreadMesh of `sizes`, each in its own
    thread; the results in rank order. An error in one aborts all."""
    model = sizes[-1]
    data = int(np.prod(sizes[:-1]))
    boards = {("data", m): _Board(data) for m in range(model)}
    boards.update({("model", d): _Board(model) for d in range(data)})
    out, errors = [None] * (data * model), []

    def go(rank):
        try:
            out[rank] = fn(ThreadMesh(sizes, rank, boards))
        except BaseException as e:  # re-raised below, after the joins
            errors.append(e)
            for b in boards.values():
                b.barrier.abort()

    threads = [threading.Thread(target=go, args=(r,))
               for r in range(data * model)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return out


# ---- (i) the band plan ------------------------------------------------------

def _support(in_h: int, pruned: int) -> list:
    """The one-device support-pruned data rows [s0, e) each pruned block's
    convolutions read, simulated conv by conv: conv1_1's output rows are
    the virtual rows whose 3 taps reach the image; each later conv grows
    the support by a row at each end; a pool first pads both ends to even
    rows."""
    s0, e = 98, in_h + 100
    regions = []
    for bi in range(pruned):
        regions.append((s0, e))
        for _ in range(BLOCK_CONVS[bi] - (bi == 0)):
            s0, e = s0 - 1, e + 1
        s0, e = (s0 - s0 % 2) // 2, (e + e % 2) // 2
    return regions


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(st.integers(16, 600), st.integers(16, 600), st.integers(1, 4))
def test_plan_bands_invariants(in_h, in_w, n):
    try:
        plan = plan_bands(in_h, in_w, n)
    except ValueError as e:
        # refused only for thin images, with the reasons
        assert n > 1 and in_h < 64 * (n - 1), (in_h, in_w, n, e)
        assert "on bands" in str(e) or "support-pruned" in str(e)
        return
    pruned = next(d for d in (4, 3) if plan_blocks(in_h, in_w, 100, d))
    assert plan.pruned == pruned <= plan.depth <= 5
    heights = [in_h + 198]
    for _ in range(5):
        heights.append(-(-heights[-1] // 2))
    assert plan.heights == tuple(heights)
    levels = list(range(plan.depth + 1))
    assert sorted(plan.bounds) == levels + ([6] if plan.fc6 else [])
    support = _support(in_h, pruned)
    for level in levels:
        b = plan.bounds[level]
        # a partition of the level's rows, each band non-empty
        assert len(b) == n + 1 and b[0] == 0 and b[-1] == heights[level]
        assert all(lo < hi for lo, hi in zip(b, b[1:]))
        if level < plan.depth:
            # a pool window never straddles two bands
            assert all(x % 2 == 0 for x in b[1:-1])
            # the boundaries stay put through a block, halve at its pool
            assert plan.bounds[level + 1][1:-1] == tuple(
                x // 2 for x in b[1:-1])
        if level < pruned and n > 1:
            # every band holds a row of the support, so a conv's one-row
            # halo lies inside the neighbour's data
            s0, e = support[level]
            assert s0 < b[1] and b[-2] < e
    if plan.fc6:
        b = plan.bounds[5]
        sizes = [hi - lo for lo, hi in zip(b, b[1:])]
        assert all(s >= FC6_HALO for s in sizes[1:])
        assert sizes[-1] > FC6_HALO
        assert plan.bounds[6] == (*b[:-1], heights[5] - FC6_HALO)
    else:
        assert n > 1  # one band always reaches the heads
    o = plan.out_rows
    assert o[0] == 0 and o[-1] == in_h
    assert all(lo < hi for lo, hi in zip(o, o[1:]))


def test_plan_bands_geometries_and_refusals():
    """The two geometries of the banded runs below, and the refusals:
    no support-pruned plan, fewer rows than bands, bands thinner than a
    halo at every depth."""
    p = plan_bands(64, 96, 4)
    assert (p.pruned, p.depth, p.fc6) == (4, 4, False)
    assert p.bounds[4] == (0, 7, 8, 9, 17)   # 9 rows at pool5: gathered
    p = plan_bands(256, 64, 2)
    assert (p.depth, p.fc6) == (5, True)
    assert p.bounds[5] == (0, 7, 15) and p.bounds[6] == (0, 7, 9)
    assert plan_bands(256, 64, 2, depth=3).pruned == 3
    with pytest.raises(ValueError, match="support-pruned"):
        plan_bands(15, 64, 1)
    with pytest.raises(ValueError, match="bands"):
        plan_bands(3, 64, 4)
    with pytest.raises(ValueError, match="4 pools on bands"):
        plan_bands(40, 64, 4)


def test_frame_rows_equal_the_whole_frame():
    """`assemble_frame` of a band's rows: the rows of the whole frame, at
    every range, for stretches that keep and that grow the probe."""
    probe = torch.randn(3, 9, 11, generator=torch.Generator().manual_seed(3))
    for out_h in (9, 10, 23):
        whole = assemble_frame(probe, out_h, 30)
        for lo in range(out_h):
            for hi in range(lo + 1, out_h + 1):
                assert torch.equal(assemble_frame(probe, out_h, 30,
                                                  (lo, hi)),
                                   whole[:, lo:hi])


@pytest.mark.parametrize("sizes", [(3, 2), (2, 3, 1)],
                         ids=["data3_model2", "slice2_data3"])
def test_height_collectives_in_threads(sizes):
    """exchange_halo, gather_height and all_reduce_max over three bands of
    unequal height: beside a 2-wide model axis, and repeated by two slices
    (the neighbours are those of the rank's slice, and the gathered rows
    are counted once)."""
    bounds = (0, 3, 10, 14)

    def fn(mesh):
        d = mesh.coords["data"]
        t = torch.arange(bounds[d], bounds[d + 1],
                         dtype=torch.float32)[None, :, None]
        above, below = exchange_halo(t, 1, 2, mesh, dim=1)
        whole = gather_height(t, mesh, bounds, dim=1)
        top = all_reduce_max(t.amax(), mesh, ("data", "model"))
        return d, above, below, whole, top

    for d, above, below, whole, top in run_threads(sizes, fn):
        assert torch.equal(whole.flatten(), torch.arange(14.0))
        assert top.item() == 13.0
        assert (above is None) == (d == 0) and (below is None) == (d == 2)
        if above is not None:
            assert above.flatten().tolist() == [bounds[d] - 1.0]
        if below is not None:
            lo = bounds[d + 1]
            assert below.flatten().tolist() == [lo, lo + 1.0]


# ---- (ii) all bands of one image in this process ----------------------------

def _model(cls, **kw):
    m = cls(C, channel_scale=SCALE, device="cpu",
            generator=torch.Generator().manual_seed(0), **kw)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for k, v in m.state_dict().items():
            if k.endswith("bias") or k.startswith("score_pool"):
                v.copy_(torch.randn(v.shape, generator=g) * 0.05)
    return m.eval()


def _image(hw):
    rng = np.random.RandomState(sum(hw))
    return torch.from_numpy(rng.randn(1, *hw, 3).astype(np.float32) * 40)


GEOMETRIES = [((64, 96), 4), ((256, 64), 2)]


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["64x96_4", "256x64_2"])
@pytest.mark.parametrize("fused", [False, True], ids=["convs", "block1_op"])
def test_fcn32s_bands_equal_one_device(geometry, fused):
    """FCN-32s's raw heads from all bands (block 1 as two convolutions, or
    through `block1_op`, K2's plain version here) vs the one-device
    forward (fp32, atol 1e-5 on heads of magnitude ~0.3), and the labels
    of each band's output rows (K1's plain version on `rows`) vs the
    one-device labels: equal."""
    hw, n = geometry
    m, x = _model(FCN32s, fused_block1=fused), _image(hw)
    embed = torch.randn(C, C, generator=torch.Generator().manual_seed(2))
    plan = plan_bands(*hw, n)
    with torch.no_grad():
        f, s = m(x, mode="raw")
        want = infer_labels_szn_fused(f, s, embed, UNSEEN, hw)

        def band(mesh):
            bands = Bands(plan, mesh)
            bf, bs = m(x, mode="raw", bands=bands)
            lab = infer_labels_szn_fused(bf, bs, embed, UNSEEN, hw,
                                         rows=bands.out_rows())
            return bf, bs, gather_height(lab, mesh, plan.out_rows)

        for bf, bs, lab in run_threads((n, 1), band):
            torch.testing.assert_close(bf, f, rtol=0, atol=1e-5)
            torch.testing.assert_close(bs, s, rtol=0, atol=1e-5)
            assert torch.equal(lab, want)


def test_band_halo_concatenations_stay_channels_last(monkeypatch):
    """Every ring pad of a band's pruned blocks takes channels_last memory,
    halo rows included, so the pad reads it in place (no channels_last
    copy of the band beside it)."""
    from zeroshotsemanticsegmentation_tpu_torch.models import pruned
    hw, n = GEOMETRIES[0]
    m, x = _model(FCN32s), _image(hw)
    seen, lock = [], threading.Lock()
    real = pruned._padc

    def spy(a, *args):
        with lock:
            seen.append(a.is_contiguous(memory_format=torch.channels_last))
        return real(a, *args)

    monkeypatch.setattr(pruned, "_padc", spy)
    with torch.no_grad():
        run_threads((n, 1), lambda mesh: m(
            x, mode="raw", bands=Bands(plan_bands(*hw, n), mesh)))
    assert seen and all(seen), seen


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["64x96_4", "256x64_2"])
def test_fcn8s_bands_equal_one_device(geometry):
    """FCN-8s (pruned 3 blocks deep, skip heads non-zero): each band's
    rows of both full-resolution heads vs the one-device forward (fp32,
    atol 1e-4 on heads of magnitude ~8)."""
    hw, n = geometry
    m, x = _model(FCN8s), _image(hw)
    plan = plan_bands(*hw, n, m.PRUNED_DEPTH)
    with torch.no_grad():
        f, s = m(x, mode="both")

        def band(mesh):
            bands = Bands(plan, mesh)
            return bands.out_rows(), m(x, mode="both", bands=bands)

        for (r0, r1), (bf, bs) in run_threads((n, 1), band):
            torch.testing.assert_close(bf, f[:, r0:r1], rtol=0, atol=1e-4)
            torch.testing.assert_close(bs, s[:, r0:r1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["64x96_4", "256x64_2"])
def test_int8_bands_equal_one_device(geometry):
    """The int8 forward from all bands: every activation scale a MAX over
    the bands (with the halo and ring rows each convolution reads), so the
    raw heads equal the one-device int8 heads bit for bit."""
    hw, n = geometry
    sd, x = _model(FCN32s).state_dict(), _image(hw)
    plan = plan_bands(*hw, n)
    with torch.no_grad():
        want = tq.quantized_raw_forward(sd, x)
        got = run_threads((n, 1), lambda mesh: tq.quantized_raw_forward(
            sd, x, bands=Bands(plan, mesh)))
    for heads in got:
        for a, b in zip(heads, want):
            assert torch.equal(a, b)


# ---- (iv) the int8 scale rules over 'model' ---------------------------------

def test_int8_row_parallel_fc7_equals_one_device():
    """fc7 split over 'model' on its input channels (two threads): its
    per-output-channel weight scale is a MAX over 'model', its input's
    scale a MAX over 'data' and 'model', and its int32 partial products
    are summed over 'model' before dequantising, so the output equals the
    one-device layer's bit for bit in fp32 (a scale taken per shard, or
    partials dequantised before the sum, moves it)."""
    g = torch.Generator().manual_seed(5)
    a = torch.relu(torch.randn(2, 5, 5, 64, generator=g)).to(torch.bfloat16)
    k = torch.randn(48, 64, 1, 1, generator=g)
    k[::3, 40:] *= 4.0  # some channels' largest weight in the 2nd shard
    a[..., 50] *= 8.0   # the largest activation in the 2nd shard
    b = torch.randn(48, generator=g)
    want = tq._qconv(a, k, b, dtype=torch.float32)

    def shard(mesh):
        cols = slice(32 * mesh.model_rank, 32 * (mesh.model_rank + 1))
        return tq._qconv(a[..., cols], k[:, cols], b, dtype=torch.float32,
                         mesh=mesh, row_parallel=True)

    for got in run_threads((1, 2), shard):
        assert torch.equal(got, want)
