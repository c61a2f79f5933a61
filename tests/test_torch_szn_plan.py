"""K1 (`ops.szn_fused`, csrc/szn_fused.cu) on the host: the kernel's
per-pixel partition rule, its host-side partition check and its launch
plan.

The CUDA kernel does not run here. What it computes per pixel is mirrored
by `kernel_rule` below: the gate row first, then one running first max over
the classes of the partition the gate selects (the kernel's mask bits), then
the 0.0 fill of that partition's first excluded class and the gate row's
-1e30. The rule is held exactly against `szn_labels_plain` and the JAX
package's `_fused` (its Pallas kernel in interpret mode) on tie-heavy
inputs on a 1/8 grid, where every upsampled value is exact in fp32 so that
all three see the same numbers. The kernel itself is held against the plain
version by tests/test_torch_cuda.py and chip_smoke.py phase 3.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from zeroshotsemanticsegmentation_tpu.ops import szn_fused as jsz
from zeroshotsemanticsegmentation_tpu_torch.ops import szn_fused as tsz

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _bits(words, k):
    return torch.tensor([(int(words[i // 64]) >> (i % 64)) & 1
                         for i in range(k)], dtype=torch.bool)


def _first_max(up, member):
    """The running first max over the classes of `member`, in class order,
    as the kernel walks a partition's positions."""
    best = torch.full(up.shape[:-1], -torch.inf)
    arg = torch.zeros(up.shape[:-1], dtype=torch.int64)
    for c in torch.nonzero(member).flatten().tolist():
        upd = up[..., c] > best
        best = torch.where(upd, up[..., c], best)
        arg = torch.where(upd, torch.full_like(arg, c), arg)
    return best, arg


def kernel_rule(up, seen, unseen, fill):
    """The kernel's labels from the upsampled (B, H, W, K+1) values: both
    partitions' first maxima (seen = the mask's classes, unseen = the
    others), the gate's pick, the 0.0 fill of the partition's first
    excluded class, the gate row's -1e30."""
    words, n_seen, fx_seen, fx_unseen = tsz.kernel_partition(seen, unseen,
                                                             fill)
    k = up.shape[-1] - 1
    in_seen = _bits(words, k)
    assert int(in_seen.sum()) == n_seen
    bs, as_ = _first_max(up, in_seen)
    bu, au = _first_max(up, ~in_seen)
    use_unseen = up[..., k] >= 0
    best = torch.where(use_unseen, bu, bs)
    arg = torch.where(use_unseen, au, as_)
    fx = torch.where(use_unseen, torch.tensor(fx_unseen),
                     torch.tensor(fx_seen))
    take = (fx >= 0) & ((best < 0) | ((best == 0) & (fx < arg)))
    best = torch.where(take, torch.zeros_like(best), best)
    arg = torch.where(take, fx, arg)
    arg = torch.where(best < tsz._GATE_FILL, torch.full_like(arg, k), arg)
    return arg.to(torch.int32)


def _upsampled(aug, out_h, out_w):
    _, h32, w32, _ = aug.shape
    up = torch.einsum("oh,bhwk->bowk", tsz._matrix(h32, out_h, "cpu"), aug)
    return torch.einsum("pw,bowk->bopk", tsz._matrix(w32, out_w, "cpu"), up)


def _tie_heavy_aug(rng, k, kind):
    """(2, 4, 5, K+1) on a 1/8 grid: duplicated classes (exact ties), an
    all-zero class (ties with the 0.0 fill), exact-zero gates; `kind`
    "negative" makes every class negative, "positive" every gate >= 0."""
    aug = rng.randint(-4, 5, (2, 4, 5, k + 1)).astype(np.float32) / 8
    aug[..., 3] = aug[..., 1]
    aug[..., k - 1] = aug[..., 0]
    aug[..., 2] = 0.0
    if kind == "negative":
        aug[..., :k] = -np.abs(aug[..., :k]) - 0.125
    elif kind == "positive":
        aug[..., k] = np.abs(aug[..., k])
    aug[0, 1, :, k] = 0.0
    return aug


PARTITIONS = {
    "szn": lambda k: np.isin(np.arange(k), [1, k - 2]),
    "nne": lambda k: np.zeros(k, bool),        # unseen has no members
    "all_unseen": lambda k: np.ones(k, bool),  # seen has no members
}


@pytest.mark.parametrize("k", [9, 21, 33])
@pytest.mark.parametrize("part", sorted(PARTITIONS))
@pytest.mark.parametrize("kind", ["mixed", "negative", "positive"])
def test_kernel_rule_matches_plain_and_jax(rng, k, part, kind):
    aug = _tie_heavy_aug(rng, k, kind)
    uv = PARTITIONS[part](k)
    seen, unseen, fill = tsz._partition(~uv, uv)
    out_h, out_w = 70, 90
    up = _upsampled(torch.from_numpy(aug), out_h, out_w)
    got = kernel_rule(up, seen, unseen, fill)
    plain = tsz.szn_labels_plain(torch.from_numpy(aug), seen, unseen, fill,
                                 out_h, out_w)
    want = np.asarray(jsz._fused(
        jnp.asarray(aug[..., :k]), jnp.asarray(aug[..., k]),
        jnp.eye(k, dtype=jnp.float32),
        jnp.asarray(seen, jnp.float32)[:, None],
        jnp.asarray(unseen, jnp.float32)[:, None],
        jnp.asarray(fill)[:, None], out_h, out_w, 16, True))
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.numpy(), want)
    # the inputs exercise what the rule is for
    labels = got.numpy()
    assert labels.max() < k
    if kind == "negative" and part == "szn":
        assert set(np.unique(labels)) <= {0, 1}  # the first excluded class


@pytest.mark.parametrize("k", [9, 21, 33, 130])
def test_kernel_partition_accepts_partition_forms(k):
    for uv in (np.isin(np.arange(k), [1, k - 2]), np.zeros(k, bool),
               np.ones(k, bool)):
        seen, unseen, fill = tsz._partition(~uv, uv)
        words, n_seen, fx_seen, fx_unseen = tsz.kernel_partition(
            seen, unseen, fill)
        assert words.shape == (tsz.K1_MASK_WORDS,)
        assert torch.equal(_bits(words, k), torch.from_numpy(~uv))
        assert n_seen == int((~uv).sum())
        assert not words[-(-k // 64):].any()
        assert fx_seen == (int(np.argmax(uv)) if uv.any() else -1)
        assert fx_unseen == (int(np.argmax(~uv)) if (~uv).any() else -1)
        # torch CPU tensors are host data too
        again = tsz.kernel_partition(*(torch.from_numpy(np.array(a))
                                       for a in (seen, unseen, fill)))
        np.testing.assert_array_equal(again[0], words)


def _malformed(k):
    uv = np.isin(np.arange(k), [1, 3])
    seen, unseen, fill = (np.array(a) for a in tsz._partition(~uv, uv))
    overlap = seen.copy()
    overlap[1] = 1                       # class 1 in both
    neither = seen.copy()
    neither[0] = 0                       # class 0 in neither
    gate_in = unseen.copy()
    gate_in[k] = 1                       # the gate row in a partition
    fill_bad = fill.copy()
    fill_bad[2] = -1e30                  # a real class's fill
    gate_fill = fill.copy()
    gate_fill[k] = 0.0                   # the gate row's fill
    return {"overlap": (overlap, unseen, fill),
            "neither": (neither, unseen, fill),
            "gate_in_partition": (seen, gate_in, fill),
            "fill": (seen, unseen, fill_bad),
            "gate_fill": (seen, unseen, gate_fill),
            "shapes": (seen[:-1], unseen, fill)}


@pytest.mark.parametrize("case", sorted(_malformed(9)))
def test_kernel_partition_refuses_malformed(case):
    with pytest.raises(ValueError, match="partition"):
        tsz.kernel_partition(*_malformed(9)[case])


def test_partition_is_host_and_cached():
    uv = np.isin(np.arange(21), [1, 13])
    a = tsz._partition(~uv, uv)
    b = tsz._partition(~uv.copy(), uv.copy())
    assert all(x is y for x, y in zip(a, b))
    assert all(isinstance(x, np.ndarray) and not x.flags.writeable
               for x in a)
    assert [x.dtype for x in a] == [np.int32, np.int32, np.float32]


PLAN_SHAPES = [(2, 17, 17, 22, 512, 512, 19), (2, 12, 16, 34, 375, 500, 30),
               (1, 4, 5, 10, 70, 90, 9), (1, 2, 300, 60, 40, 9000, 0),
               (3, 1, 1, 2, 9, 5, 1), (1, 2, 1000, 40, 7, 130, 3)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_k1_plan_covers_every_pixel_once(shape):
    """Blocks -> (image, band of `rows` rows); in a band, warps -> tiles of
    rows x 32 / rows runs, lane (r, c) -> row r, run c of its tile: every
    output pixel is stored once (lanes past out_h or out_w store
    nothing)."""
    b, h32, w32, kp1, out_h, out_w, _ = shape
    plan = tsz.k1_plan(*shape)
    assert plan["threads"] == tsz.K1_THREADS
    rows, cols = plan["tile"]
    assert rows == plan["rows"] and rows * cols == 32
    warps = plan["threads"] // 32
    cover = np.zeros((b, out_h, out_w), np.int64)
    for i in range(plan["grid"]):
        img, band = divmod(i, plan["bands"])
        y0 = rows * band
        for w in range(warps):
            for tile in range(w, plan["tiles"], warps):
                for lane in range(32):
                    r, c = divmod(lane, cols)
                    y, x = y0 + r, tile * tsz.K1_RUN * cols + tsz.K1_RUN * c
                    if y < out_h:
                        cover[img, y, x:min(x + tsz.K1_RUN, out_w)] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("in_len,out_len", [(17, 512), (12, 375), (16, 500),
                                            (5, 90), (300, 9000), (1, 5)])
def test_k1_runs_need_at_most_three_tap_columns(in_len, out_len):
    """A run of K1_RUN columns reads tap columns j0, j0 + 1, j0 + 2 (clamped
    at w32 - 1) of its first column's j0: every pixel's two taps are among
    them, and a pixel past the change blends the second and third."""
    i0, w = tsz._tap_table(in_len, out_len)
    for x0 in range(0, out_len, tsz.K1_RUN):
        j0 = i0[x0]
        loaded = {min(j0 + t, in_len - 1) for t in range(3)}
        for x in range(x0, min(x0 + tsz.K1_RUN, out_len)):
            assert i0[x] - j0 in (0, 1)
            assert {i0[x], min(i0[x] + 1, in_len - 1)} <= loaded


@pytest.mark.parametrize("kp1", [22, 34, 10, 60])
@pytest.mark.parametrize("n_seen", [0, 1, 19, "all"])
def test_k1_plan_layout(kp1, n_seen):
    """Every class has one position in a tap column: the seen classes at 0
    .. n_seen - 1, the unseen ones at u0 .., the gate at `gate`; the
    unrolled widths pad each range to a multiple of 4 and give the gate a
    group of its own, so that all their 16-byte loads stay in the column."""
    k = kp1 - 1
    ns = k if n_seen == "all" else min(n_seen, k)
    p = tsz.k1_plan(8, 17, 17, kp1, 512, 512, ns)
    assert p["u0"] >= ns and p["gate"] >= p["u0"] + (k - ns)
    assert p["stride"] > p["gate"]
    if p["instance"]:
        assert p["u0"] % 4 == 0 and p["gate"] % 4 == 0
        assert p["stride"] == p["gate"] + 4
        assert p["stride"] <= kp1 + 9
    else:
        assert (p["u0"], p["gate"], p["stride"]) == (ns, k, kp1)


def test_k1_plan_shared_memory():
    # the bundled widths: padded rows, bands of 8 rows, the position tables
    p = tsz.k1_plan(64, 17, 17, 22, 512, 512, 19)
    assert (p["instance"], p["u0"], p["gate"], p["stride"], p["rows"]) == (
        22, 20, 24, 28, 8)
    assert p["smem"] == 4 * (8 * 17 * 28 + 22 + 28)
    assert (p["grid"], p["tile"], p["tiles"]) == (64 * 64, (8, 4), 32)
    p = tsz.k1_plan(16, 17, 17, 34, 512, 512, 33)
    assert (p["instance"], p["stride"], p["rows"]) == (34, 40, 8)
    # K+1 = 60, w32 = 300 (the card test's widest accepted row): generic,
    # unpadded, bands of two rows within 227 KB
    p = tsz.k1_plan(1, 2, 300, 60, 40, 9000, 0)
    assert (p["instance"], p["stride"], p["rows"]) == (0, 60, 2)
    assert p["smem"] == 4 * (2 * 300 * 60 + 120) <= tsz.K1_SMEM_LIMIT
    # one row past the limit: refused at launch
    p = tsz.k1_plan(1, 2, 1000, 60, 64, 64, 59)
    assert p["rows"] == 1 and p["smem"] > tsz.K1_SMEM_LIMIT
    # a bundled width whose padded row would not fit takes the generic
    # instance, which needs no more than the unpadded row and its tables
    p = tsz.k1_plan(1, 2, 2400, 22, 64, 64, 19)
    assert 4 * (2400 * 28 + 50) > tsz.K1_SMEM_LIMIT
    assert (p["instance"], p["rows"]) == (0, 1)
    assert p["smem"] == 4 * (2400 * 22 + 44)
    # one row never takes more than the kernel this one replaced took,
    # (K+1) (w32 + 3) floats
    for w32, kp1 in ((980, 59), (2400, 22), (300, 60)):
        p = tsz.k1_plan(1, 2, w32, kp1, 64, 64, 5)
        one_row = 4 * (w32 * p["stride"] + kp1 + p["stride"])
        assert one_row <= 4 * kp1 * (w32 + 3)


@pytest.mark.parametrize("name,const", [("K1_THREADS", "kThreads"),
                                        ("K1_RUN", "kRun"),
                                        ("K1_MASK_WORDS", "kMaskWords")])
def test_k1_plan_constants_are_the_kernels(name, const):
    """The kernel's fixed shape (threads a block, columns a thread, words
    of the seen mask), which `k1_plan` and the wrapper assume, is the one
    csrc/szn_fused.cu compiles."""
    src = (Path(tsz.__file__).parent.parent / "csrc" / "szn_fused.cu"
           ).read_text()
    m = re.search(rf"constexpr int {const} = (\d+);", src)
    assert m and int(m.group(1)) == getattr(tsz, name)
