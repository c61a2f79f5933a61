"""Host-side pieces of bf16 K2 on the tensor cores (`block1_fused_wgmma`,
csrc/block1_fused.cu) on the CPU: conv1_1's packed weight image, the tile
plan its persistent blocks walk, and the GEMM form the kernel computes
(conv1_1 as a K = 32 product from each tile's 20x20x3 input patch, the
bf16 rounding before b1, conv1_2 as nine tap products with the packed B
matrices, + b2 in fp32, ReLU, pool) against `block1_plain` and the JAX
`fused_block1_full` in interpret mode. The kernel itself runs in
tests/test_torch_cuda.py and chip_smoke.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

import zeroshotsemanticsegmentation_tpu.ops.block1_fused as jb1
from zeroshotsemanticsegmentation_tpu_torch.ops import block1_fused as tb1

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.RandomState(11)


def _unpack(p: torch.Tensor) -> torch.Tensor:
    """pack_conv_weights' inverse: (T, K/16, 8, 2, 8, 8) -> (T, K, 64)."""
    t, ks = p.shape[:2]
    return p.permute(0, 1, 3, 5, 2, 4).reshape(t, 16 * ks, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv1_1_packed_weights_unpack_to_oihw(rng, dtype):
    """Element [0][ks][nc][kc][n%8][k%8] of conv1_1's 4 KB image is
    B[k][n] with k = 16 ks + 8 kc + k%8, n = 8 nc + n%8: k1[co=n, ci, kh,
    kw] for k = (kh * 3 + kw) * 3 + ci < 27, zero for the padding rows
    27-31."""
    k1 = torch.from_numpy(rng.randn(64, 3, 3, 3).astype(np.float32))
    k1 = k1.to(dtype)
    p = tb1.pack_conv_weights(tb1.conv1_1_b_matrix(k1)[None])
    assert p.shape == (1, 2, 8, 2, 8, 8) and p.dtype == torch.bfloat16
    assert p.numel() * 2 == 2 * 2048 and p.is_contiguous()
    b = _unpack(p)[0]
    assert b.shape == (32, 64)
    assert not b[27:].any()
    k = torch.arange(27)
    kh, kw, ci = k // 9, (k // 3) % 3, k % 3
    want = k1.to(torch.bfloat16)[:, ci, kh, kw].t()    # [k][co]
    assert torch.equal(b[:27], want)


def _pooled_writes(batch: int, hp: int, wp: int) -> torch.Tensor:
    """How often each pooled pixel of a (batch, (hp-4)/2, (wp-4)/2) output
    is stored when persistent blocks walk tiles 0 .. batch * ty * tx - 1 of
    `block1_tile_plan` and decode them as the kernel does (tile -> (b, ty,
    tx); thread (wg, warp, lane) stores pooled pixel (8 ty + 4 wg + warp,
    8 tx + lane / 4), masked past the output); also checks that every
    stored pixel's 6x6 input window lies inside both the image and the
    tile's 20x20 patch."""
    gb, ty, tx = tb1.block1_tile_plan(batch, hp, wp)
    assert gb == batch
    ph, pw = (hp - 4) // 2, (wp - 4) // 2
    tile = torch.arange(batch * ty * tx)
    per_img = ty * tx
    bi, ti, xi = tile // per_img, (tile % per_img) // tx, tile % tx
    wg, warp, quad = torch.meshgrid(torch.arange(2), torch.arange(4),
                                    torch.arange(8), indexing="ij")
    py = 8 * ti[:, None] + (4 * wg + warp).reshape(-1)[None]
    px = 8 * xi[:, None] + quad.reshape(-1)[None]
    keep = (py < ph) & (px < pw)
    # pooled (py, px) reads input rows 2 py .. 2 py + 5, columns likewise
    for p, t, side in ((py, ti, hp), (px, xi, wp)):
        lo, hi = 2 * p[keep], 2 * p[keep] + 5
        origin = 16 * t[:, None].expand_as(p)[keep]
        assert bool((hi < side).all())
        assert bool((lo >= origin).all() and (hi < origin + 20).all())
    idx = ((bi[:, None] * ph + py) * pw + px)[keep]
    return torch.bincount(idx, minlength=batch * ph * pw)


@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("hp,wp", [(522, 522), (386, 510), (530, 530),
                                   (38, 42)])
def test_tile_plan_covers_each_pooled_pixel_once(batch, hp, wp):
    writes = _pooled_writes(batch, hp, wp)
    assert writes.numel() == batch * ((hp - 4) // 2) * ((wp - 4) // 2)
    assert bool((writes == 1).all())


def _round(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(dtype).to(t.dtype)


def _gemm_form(xp, k1, b1, k2, b2, dtype) -> torch.Tensor:
    """What bf16 K2 computes, tile by tile, in fp64 on the CPU with the
    kernel's rounding points (none for fp32): each tile's 20x20x3 patch
    (zeros past the image), conv1_1 as im2col rows of K = 32 times the B
    matrix unpacked from its packed image, the fp32 sum rounded to `dtype`,
    + b1 in `dtype`, ReLU; conv1_2 as nine tap products with conv1_2's
    unpacked B matrices, + b2 in fp32, ReLU, 2x2 max, one rounding; the
    tiles' pooled pixels cropped to the output."""
    x = _round(xp.double(), dtype)
    n, hp, wp, _ = x.shape
    _, ty, tx = tb1.block1_tile_plan(n, hp, wp)
    bm1 = _unpack(tb1.pack_conv_weights(
        tb1.conv1_1_b_matrix(k1.to(dtype))[None]))[0].double()
    bm2 = _unpack(tb1.pack_conv_weights(
        tb1.conv_b_matrices(k2.to(dtype)))).double()
    xpad = F.pad(x, (0, 0, 0, 16 * tx + 4 - wp, 0, 16 * ty + 4 - hp))
    patch = xpad.unfold(1, 20, 16).unfold(2, 20, 16)     # (n, ty, tx, 3, 20, 20)
    patch = patch.reshape(-1, 3, 20, 20)
    cols = torch.stack([patch[:, ci, kh:kh + 18, kw:kw + 18]
                        for kh in range(3) for kw in range(3)
                        for ci in range(3)], -1)          # k = (kh*3+kw)*3+ci
    cols = F.pad(cols, (0, 5))                            # K 27 -> 32
    s = _round(_round(cols @ bm1, torch.float32), dtype)
    c11 = torch.relu(_round(s + _round(b1.double(), dtype), dtype))
    pre = b2.double().expand(c11.shape[0], 16, 16, 64).clone()
    for t in range(9):
        kh, kw = divmod(t, 3)
        pre += c11[:, kh:kh + 16, kw:kw + 16] @ bm2[t]
    pre = _round(pre, torch.float32)
    pooled = F.max_pool2d(torch.relu(pre).permute(0, 3, 1, 2), 2, 2)
    pooled = _round(pooled.permute(0, 2, 3, 1), dtype)    # (tiles, 8, 8, 64)
    out = pooled.reshape(n, ty, tx, 8, 8, 64).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(n, 8 * ty, 8 * tx, 64)
    return out[:, :(hp - 4) // 2, :(wp - 4) // 2]


def _weights(rng):
    return (torch.from_numpy(rng.randn(64, 3, 3, 3).astype(np.float32) * 0.2),
            torch.from_numpy(rng.randn(64).astype(np.float32) * 0.1),
            torch.from_numpy(rng.randn(64, 64, 3, 3).astype(np.float32) * 0.05),
            torch.from_numpy(rng.randn(64).astype(np.float32) * 0.1))


@pytest.mark.parametrize("shape", [(2, 38, 42), (1, 22, 54), (1, 30, 26)])
def test_gemm_form_matches_plain_fp32(rng, shape):
    """In fp32 (no rounding points) the tiled GEMM form is the plain
    version's block 1: max |err| <= 1e-4, as the fp32 kernel's bar. The
    weights are bf16-exact, as the packed images hold them."""
    xp = torch.from_numpy(rng.randn(*shape, 3).astype(np.float32))
    w = [t.to(torch.bfloat16).float() for t in _weights(rng)]
    got = _gemm_form(xp, *w, torch.float32)
    want = tb1.block1_plain(xp, *w, torch.float32)
    assert got.shape == want.shape
    assert (got - want.double()).abs().max().item() <= 1e-4


@pytest.mark.parametrize("shape", [(2, 38, 42), (1, 30, 26)])
def test_gemm_form_matches_jax_full_bf16(rng, monkeypatch, shape):
    """In bf16 the GEMM form rounds where the JAX `_kernel_full` rounds:
    against `fused_block1_full` (interpret mode) every output is within one
    bf16 ULP of the output's largest magnitude and almost all are equal
    (the fp32 sums differ only in order); against the plain bf16 version
    (conv1_2's sum rounded before b2) within the 2-ULP bar of
    tests/test_torch_kernels.py."""
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    xp = rng.randn(*shape, 3).astype(np.float32)
    w = _weights(rng)
    k1, b1, k2, b2 = (t.numpy() for t in w)
    full = np.asarray(jb1.fused_block1_full(
        jnp.asarray(xp), jnp.asarray(np.ascontiguousarray(k1.transpose(2, 3, 1, 0))),
        jnp.asarray(b1), jnp.asarray(np.ascontiguousarray(k2.transpose(2, 3, 1, 0))),
        jnp.asarray(b2), dtype=jnp.bfloat16).astype(np.float32))
    got = _gemm_form(torch.from_numpy(xp), *w, torch.bfloat16).float().numpy()
    plain = tb1.block1_plain(torch.from_numpy(xp), *w,
                             torch.bfloat16).float().numpy()
    assert got.shape == full.shape == plain.shape
    ulp = np.abs(full).max() * 2.0 ** -8
    assert np.abs(got - full).max() <= ulp
    assert (got != full).mean() < 1e-2
    assert np.abs(got - plain).max() <= 2 * ulp


@pytest.mark.parametrize("shape", [(1, 30, 30, 3), (64, 38, 42, 3)])
def test_bf16_wrapper_refuses_cpu_tensors(shape):
    """block1_fused launches a CUDA kernel only: a CPU tensor raises before
    any build or launch."""
    k = (torch.zeros(64, 3, 3, 3), torch.zeros(64), torch.zeros(64, 64, 3, 3),
         torch.zeros(64))
    with pytest.raises(ValueError, match="CUDA"):
        tb1.block1_fused(torch.zeros(shape), *k, torch.bfloat16)
