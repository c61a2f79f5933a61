"""Host-side pieces of the bf16 K3/K4 kernels (csrc/conv3x3_wgmma.cuh,
csrc/block1_train.cu) on the CPU: the packed wgmma weight image, the tile
plan and the dK2 chunk rule of ops/block1_fused.py, the GEMM form the
kernels compute (per-tap products with the packed B matrices, the
first-max route) against the plain versions and the JAX two-stage block 1,
and the wrappers' refusals. The kernels themselves run in
tests/test_torch_cuda.py and chip_smoke.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

import zeroshotsemanticsegmentation_tpu.ops.block1_fused as jb1
from zeroshotsemanticsegmentation_tpu_torch.ops import block1_fused as tb1


@pytest.fixture
def rng():
    return np.random.RandomState(7)


def _unpack(p: torch.Tensor) -> torch.Tensor:
    """pack_conv_weights' inverse: (9, 4, 8, 2, 8, 8) -> (9, 64, 64)."""
    return p.permute(0, 1, 3, 5, 2, 4).reshape(9, 64, 64)


@pytest.mark.parametrize("flip", [False, True])
def test_packed_weights_unpack_to_oihw(rng, flip):
    """Element [t][ks][nc][kc][n%8][k%8] of the packed image is B[t][k][n]
    with k = 16 ks + 8 kc + k%8, n = 8 nc + n%8: for the forward
    k2[co=n, ci=k, kh, kw], for dgrad k2[co=k, ci=n, 2-kh, 2-kw]."""
    k2 = torch.from_numpy(rng.randn(64, 64, 3, 3).astype(np.float32))
    k2 = k2.to(torch.bfloat16)
    p = tb1.pack_conv_weights(tb1.conv_b_matrices(k2, flip))
    assert p.shape == (9, 4, 8, 2, 8, 8) and p.dtype == torch.bfloat16
    assert p.numel() * 2 == 9 * 4 * 2048 and p.is_contiguous()
    t, ks, nc, kc, ni, ki = np.meshgrid(*(np.arange(n) for n in p.shape),
                                        indexing="ij")
    k, n, kh, kw = 16 * ks + 8 * kc + ki, 8 * nc + ni, t // 3, t % 3
    want = (k2[k, n, 2 - kh, 2 - kw] if flip else k2[n, k, kh, kw])
    assert torch.equal(p, want)
    assert torch.equal(_unpack(p), tb1.conv_b_matrices(k2, flip))


def _covered(b: int, h: int, w: int, grid) -> torch.Tensor:
    """How often each pixel of a (b, h, w) output is written when
    persistent blocks walk tiles 0 .. b * ty * tx - 1 of `grid`, decoded
    as the kernels decode them, each tile's accumulator rows at
    tile_row_pixels() from its origin (16 ty, 16 tx), the ragged edge
    masked."""
    gb, ty, tx = grid
    assert gb == b
    tile = torch.arange(b * ty * tx)
    per_img = ty * tx
    bi, ti, xi = tile // per_img, (tile % per_img) // tx, tile % tx
    rows = tb1.tile_row_pixels().reshape(-1, 2)
    assert rows.shape == (256, 2)
    y = 16 * ti[:, None] + rows[None, :, 0]
    x = 16 * xi[:, None] + rows[None, :, 1]
    keep = (y < h) & (x < w)
    idx = ((bi[:, None] * h + y) * w + x)[keep]
    return torch.bincount(idx, minlength=b * h * w)


@pytest.mark.parametrize("b", [1, 3, 24])
@pytest.mark.parametrize("hc,wc", [(522, 522), (530, 530), (386, 510),
                                   (34, 34)])
def test_tile_plan_covers_each_pixel_once(b, hc, wc):
    """K3's and the route's tiles write every conv1_2 output pixel (every
    window of the pooled output) once; dgrad's every d(c11) pixel once."""
    plan = tb1.conv_tile_plan(b, hc, wc)
    ho, wo = hc - 2, wc - 2
    pool = _covered(b, ho, wo, plan["pool"])
    assert pool.numel() == b * ho * wo and bool((pool == 1).all())
    dgrad = _covered(b, hc, wc, plan["dgrad"])
    assert dgrad.numel() == b * hc * wc and bool((dgrad == 1).all())
    # the tile rows of a warpgroup's m64 tile: rows r and r + 8 of both
    # tiles are the four pixels of one 2x2 window, in scan order
    rows = tb1.tile_row_pixels()
    quads = torch.stack([rows[:, dy, :, h] for dy in (0, 1) for h in (0, 1)])
    assert torch.equal(quads - quads[0], torch.tensor(
        [[0, 0], [0, 1], [1, 0], [1, 1]])[:, None, None, None, :].expand_as(
            quads))


@pytest.mark.parametrize("b,hc,wc,dtype,want", [
    (24, 522, 522, torch.bfloat16, -(-24 * 520 * 9 // 64)),
    (24, 520, 520, torch.bfloat16, -(-24 * 518 * 9 // 64)),
    (1, 34, 34, torch.bfloat16, 1),
    (3, 386, 510, torch.bfloat16, -(-3 * 384 * 8 // 64)),
    (24, 522, 522, torch.float32, -(-24 * 520 * 520 // 4096)),
    (2, 9, 10, torch.bfloat16, 0),          # odd conv1_2 output side
    (0, 34, 34, torch.bfloat16, 0),         # no samples
    (65536, 34, 34, torch.float32, 0),      # past the batch limit
    (2000, 522, 522, torch.bfloat16, 0),    # pixels past 32-bit indices
])
def test_wgrad_chunk_rule(b, hc, wc, dtype, want):
    """block1_train_wgrad_chunks' rule: bf16 chunks are 64 row segments of
    64 pixels (the last segment of a row and the last chunk ragged), fp32
    chunks 4096 pixels; 0 for a shape the backward refuses."""
    n = tb1.wgrad_chunks(b, hc, wc, dtype)
    assert n == want
    if n and dtype == torch.bfloat16:
        segs = b * (hc - 2) * -(-(wc - 2) // tb1.WGRAD_SEG)
        assert (n - 1) * tb1.WGRAD_CHUNK_SEGS < segs <= n * \
            tb1.WGRAD_CHUNK_SEGS
        assert tb1.WGRAD_SEG * tb1.WGRAD_CHUNK_SEGS == tb1.WGRAD_CHUNK_PIX


def _gemm_form(c11, k2, b2, g):
    """What the bf16 kernels compute, in fp64 on the CPU: pre-activations
    as the sum over taps of the shifted c11 rows times the forward's B
    matrix unpacked from its packed image; pool and the first-max route
    (g to the first maximum in window scan order where pre > 0); dK2[t] =
    dz^T (c11 shifted by t), db2 the column sums of dz; d(c11) as the sum
    over taps of dz padded by 2, shifted, times dgrad's B."""
    bf = _unpack(tb1.pack_conv_weights(tb1.conv_b_matrices(k2))).double()
    bb = _unpack(tb1.pack_conv_weights(
        tb1.conv_b_matrices(k2, flip=True))).double()
    x = c11.double()
    n, hc, wc, _ = x.shape
    ho, wo = hc - 2, wc - 2
    pre = b2.double().expand(n, ho, wo, 64).clone()
    for t in range(9):
        kh, kw = divmod(t, 3)
        pre += x[:, kh:kh + ho, kw:kw + wo] @ bf[t]
    win = pre.view(n, ho // 2, 2, wo // 2, 2, 64).permute(0, 1, 3, 5, 2, 4)
    win = win.reshape(n, ho // 2, wo // 2, 64, 4)
    pooled = win.clamp(min=0).amax(-1)
    first = (win.clamp(min=0) == pooled[..., None]).double().argmax(-1)
    sel = F.one_hot(first, 4).double() * (win > 0)
    dz = (sel * g.double()[..., None]).view(n, ho // 2, wo // 2, 64, 2, 2)
    dz = dz.permute(0, 1, 4, 2, 5, 3).reshape(n, ho, wo, 64)
    dk = torch.stack([
        torch.einsum("byxo,byxi->oi", dz, x[:, t // 3:t // 3 + ho,
                                          t % 3:t % 3 + wo])
        for t in range(9)])
    dzp = F.pad(dz, (0, 0, 2, 2, 2, 2))
    dc = sum(dzp[:, t // 3:t // 3 + hc, t % 3:t % 3 + wc] @ bb[t]
             for t in range(9))
    dk2 = dk.view(3, 3, 64, 64).permute(2, 3, 0, 1)
    return pooled, (dc, dk2, dz.sum((0, 1, 2)))


def _rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


@pytest.mark.parametrize("shape", [(2, 34, 38), (1, 20, 50)])
def test_gemm_form_matches_plain(rng, shape):
    """The kernels' GEMM form (packed B matrices, tap order, route) vs
    conv2_pool_plain and its autograd on bf16-exact inputs: output and
    every gradient at relative norm < 1e-5 (fp32 rounding of the plain
    versions)."""
    c11 = torch.from_numpy(np.maximum(rng.randn(*shape, 64), 0)
                           .astype(np.float32)).to(torch.bfloat16).float()
    k2 = torch.from_numpy(rng.randn(64, 64, 3, 3).astype(np.float32) * 0.05)
    k2 = k2.to(torch.bfloat16).float()
    b2 = torch.from_numpy(rng.randn(64).astype(np.float32) * 0.1)
    want = tb1.conv2_pool_plain(c11, k2, b2)
    g = torch.from_numpy(rng.randn(*want.shape).astype(np.float32))
    pooled, grads = _gemm_form(c11, k2, b2, g)
    assert _rel(pooled, want) < 1e-5
    for name, a, w in zip(("dc11", "dk2", "db2"), grads,
                          tb1.conv2_pool_plain_backward(c11, k2, b2, g)):
        assert a.shape == w.shape, name
        assert _rel(a, w) < 1e-5, (name, _rel(a, w))


def test_gemm_form_matches_jax_two_stage(rng, monkeypatch):
    """The GEMM form on the conv1_1 activation vs the JAX two-stage
    `fused_block1` (K3/K4 in interpret mode) in fp32: the pooled output at
    atol 1e-4 and dK2, db2 at relative norm < 1e-4."""
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    xp = rng.randn(2, 30, 34, 3).astype(np.float32)
    k1 = rng.randn(3, 3, 3, 64).astype(np.float32) * 0.2
    b1 = rng.randn(64).astype(np.float32) * 0.1
    k2 = np.asarray(torch.from_numpy(
        rng.randn(3, 3, 64, 64).astype(np.float32) * 0.05).to(
            torch.bfloat16).float())
    b2 = rng.randn(64).astype(np.float32) * 0.1
    gseed = rng.randn(2, 13, 15, 64).astype(np.float32)

    def jloss(k2_, b2_):
        return jnp.sum(jb1.fused_block1(jnp.asarray(xp), jnp.asarray(k1),
                                        jnp.asarray(b1), k2_, b2_,
                                        dtype=jnp.float32) * gseed)

    jk2, jb2 = jnp.asarray(k2), jnp.asarray(b2)
    want = np.asarray(jb1.fused_block1(jnp.asarray(xp), jnp.asarray(k1),
                                       jnp.asarray(b1), jk2, jb2,
                                       dtype=jnp.float32))
    dk_want, db_want = jax.grad(jloss, argnums=(0, 1))(jk2, jb2)
    x = torch.from_numpy(xp).permute(0, 3, 1, 2)
    k1t = torch.from_numpy(np.ascontiguousarray(k1.transpose(3, 2, 0, 1)))
    c11 = torch.relu(F.conv2d(x, k1t) + torch.from_numpy(b1)[:, None, None])
    k2t = torch.from_numpy(np.ascontiguousarray(k2.transpose(3, 2, 0, 1)))
    pooled, (_, dk2, db2) = _gemm_form(c11.permute(0, 2, 3, 1), k2t,
                                       torch.from_numpy(b2),
                                       torch.from_numpy(gseed))
    np.testing.assert_allclose(pooled.numpy(), want, rtol=0, atol=1e-4)
    dk_hwio = dk2.permute(2, 3, 1, 0).numpy()
    for a, w in ((dk_hwio, np.asarray(dk_want)), (db2.numpy(),
                                                  np.asarray(db_want))):
        rel = np.linalg.norm(a - w) / np.linalg.norm(w)
        assert rel < 1e-4, rel


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 34, 34, 64), (1, 9, 10, 64),
                                   (2, 34, 34, 32)])
def test_wrappers_refuse_cpu_tensors(dtype, shape):
    """K3/K4's wrappers launch CUDA kernels only: a CPU tensor, well
    shaped or not, raises before any build or launch; the plain versions
    refuse the bad shapes themselves."""
    c11 = torch.zeros(shape, dtype=dtype)
    k2, b2 = torch.zeros(64, 64, 3, 3, dtype=dtype), torch.zeros(64)
    g = torch.zeros(1, 16, 16, 64, dtype=dtype)
    with pytest.raises(ValueError, match="CUDA"):
        tb1.conv2_pool(c11, k2, b2)
    with pytest.raises(ValueError, match="CUDA"):
        tb1.conv2_pool_backward(c11, k2, b2, g)
    with pytest.raises(ValueError, match="CUDA"):
        tb1.k4_buffers(c11, k2, b2, g)
    if shape != (1, 34, 34, 64):
        with pytest.raises(ValueError, match="conv2_pool"):
            tb1.conv2_pool_plain(c11, k2, b2)
