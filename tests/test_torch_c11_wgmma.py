"""bf16 K8 (`conv1_1_wgmma`, csrc/conv1_1.cu) on the host: its tile plan and
its GEMM form.

The CUDA kernel does not run here. It computes conv1_1 as an (M, 32) x
(32, 64) product over the flattened output pixels, tiles of C11_TILE_M
pixels; `conv1_1_gemm` below is that product in PyTorch with K8's
rounding points (inputs and weights rounded to the dtype, fp32 sums, + b1
in fp32, ReLU, one rounding). It is held against `conv1_1_pairs_plain` and the JAX
package's `conv1_1_pairs` (its Pallas kernel in interpret mode): fp32 at
1e-5, bf16 within one bf16 ulp (the sums' order differs). The kernel itself
is held against the plain version by tests/test_torch_cuda.py and
chip_smoke.py phase 16.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import zeroshotsemanticsegmentation_tpu.ops.block1_fused as jb1
from zeroshotsemanticsegmentation_tpu_torch.ops import block1_fused as tb1

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def tile_pixels(tile, batch, hp, wp):
    """(n, 3): the (b, y, x) of the output pixels bf16 K8's tile `tile`
    stores, in its staging rows' order (n < C11_TILE_M for the last)."""
    ho, wo = hp - 2, wp - 2
    m = torch.arange(tb1.C11_TILE_M * tile,
                     min(tb1.C11_TILE_M * (tile + 1), batch * ho * wo))
    return torch.stack((m // (ho * wo), (m % (ho * wo)) // wo, m % wo), -1)


def conv1_1_gemm(xp, k1, b1, dtype=torch.bfloat16):
    """bf16 K8's GEMM form: the (M, 32) im2col matrix of xp rounded to
    `dtype` (column k = (kh * 3 + kw) * 3 + ci, 27-31 zero) times
    `conv1_1_b_matrix` of k1 rounded to `dtype`, summed in fp32, + b1 in
    fp32, ReLU, one rounding to `dtype`; in the packed-pair shape."""
    x = xp.to(dtype).to(torch.float32)
    b, hp, wp, _ = x.shape
    ho, wo = hp - 2, wp - 2
    cols = [x[:, kh:kh + ho, kw:kw + wo, :] for kh in range(3)
            for kw in range(3)]
    a = torch.cat(cols + [x.new_zeros(b, ho, wo, 5)], -1).reshape(-1, 32)
    w = tb1.conv1_1_b_matrix(k1.to(dtype).to(torch.float32))
    acc = torch.relu(a @ w + b1.to(torch.float32))
    return acc.to(dtype).reshape(b, ho, wo // 2, 128)


def one_bf16_ulp(a, b):
    """|a - b| <= 2^-7 max(|a|, |b|) + 1e-6 elementwise: K8's bf16 bar."""
    return np.abs(a - b) <= 2.0 ** -7 * np.maximum(np.abs(a), np.abs(b)) \
        + 1e-6


@pytest.mark.parametrize("shape", [(2, 38, 42), (2, 66, 34), (1, 4, 132),
                                   (16, 530, 530), (3, 6, 4)])
def test_c11_tile_plan_covers_pixels_once(shape):
    b, hp, wp = shape
    plan = tb1.c11_tile_plan(b, hp, wp)
    m = b * (hp - 2) * (wp - 2)
    assert plan["pixels"] == m
    assert (plan["tiles"] - 1) * tb1.C11_TILE_M < m \
        <= plan["tiles"] * tb1.C11_TILE_M
    if m <= 20000:  # every tile's pixels, in order, are the (b, y, x) axis
        got = torch.cat([tile_pixels(t, b, hp, wp)
                         for t in range(plan["tiles"])])
        bb, yy, xx = torch.meshgrid(torch.arange(b), torch.arange(hp - 2),
                                    torch.arange(wp - 2), indexing="ij")
        want = torch.stack((bb, yy, xx), -1).reshape(-1, 3)
        assert torch.equal(got, want)
    else:  # the first and the clipped last tile
        first = tile_pixels(0, b, hp, wp)
        assert first.shape == (tb1.C11_TILE_M, 3)
        assert first[-1].tolist() == [0, 0, tb1.C11_TILE_M - 1]
        last = tile_pixels(plan["tiles"] - 1, b, hp, wp)
        assert last[-1].tolist() == [b - 1, hp - 3, wp - 3]
        assert 0 < last.shape[0] <= tb1.C11_TILE_M


def test_c11_tile_plan_is_the_kernels():
    """The tile that `conv1_1_pairs` passes (and the kernel checks, with
    the shared memory) is the one csrc/conv1_1.cu compiles."""
    src = (Path(tb1.__file__).parent.parent / "csrc" / "conv1_1.cu"
           ).read_text()
    m = re.search(r"constexpr int kTileM = (\d+);", src)
    assert m and tb1.c11_tile_plan(16, 530, 530)["tile_m"] == int(m.group(1))


def test_c11_staging_fits():
    """Two 16 KB staging buffers on a 1024-byte base (the 128-byte swizzle
    atom) and the 4 KB packed B; two blocks an SM fit."""
    assert tb1.C11_STAGE_BYTES == tb1.C11_TILE_M * 128
    assert tb1.C11_STAGE_BYTES % 1024 == 0
    plan = tb1.c11_tile_plan(16, 530, 530)
    assert plan["smem"] == 1024 + 2 * tb1.C11_STAGE_BYTES + 4096
    assert 2 * plan["smem"] <= 232448
    assert tb1.pack_conv_weights(tb1.conv1_1_b_matrix(
        torch.zeros(64, 3, 3, 3))[None]).numel() * 2 == 4096


def _inputs(rng, hw, b=2):
    xp = rng.randn(b, *hw, 3).astype(np.float32)
    k1 = rng.randn(3, 3, 3, 64).astype(np.float32) * 0.2   # HWIO
    b1 = rng.randn(64).astype(np.float32) * 0.1
    return xp, k1, b1


def _oihw(k1):
    return torch.from_numpy(np.ascontiguousarray(k1.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("hw", [(38, 42), (66, 34), (4, 132)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1_1_gemm_matches_plain_and_jax(rng, hw, dtype):
    xp, k1, b1 = _inputs(rng, hw)
    tdt = getattr(torch, dtype)
    args = (torch.from_numpy(xp), _oihw(k1), torch.from_numpy(b1))
    got = conv1_1_gemm(*args, dtype=tdt)
    plain = tb1.conv1_1_pairs_plain(*args, dtype=tdt)
    want = np.asarray(jb1.conv1_1_pairs(
        jnp.asarray(xp), jnp.asarray(k1), jnp.asarray(b1),
        dtype=getattr(jnp, dtype)).astype(jnp.float32))
    assert got.dtype == tdt
    assert got.shape == plain.shape == want.shape == (
        2, hw[0] - 2, (hw[1] - 2) // 2, 128)
    g = got.float().numpy()
    for ref in (plain.float().numpy(), want):
        if dtype == "float32":
            np.testing.assert_allclose(g, ref, rtol=0, atol=1e-5)
        else:
            ok = one_bf16_ulp(g, ref)
            assert ok.all(), (np.abs(g - ref)[~ok].max(), (~ok).sum())
            assert (g != ref).mean() <= 1e-3


def test_conv1_1_gemm_rounds_once(rng):
    """b1 is added to the fp32 sum before the one rounding (not to a
    rounded sum, as K2's conv1_1 does): the GEMM form equals the fp32
    product rounded once."""
    xp, k1, b1 = _inputs(rng, (10, 12))
    x = torch.from_numpy(xp).to(torch.bfloat16).float()
    w = _oihw(k1).to(torch.bfloat16).float()
    ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w,
                                     torch.from_numpy(b1))
    ref = torch.relu(ref).permute(0, 2, 3, 1)
    got = conv1_1_gemm(torch.from_numpy(xp), _oihw(k1),
                           torch.from_numpy(b1)).float().reshape(ref.shape)
    once = ref.to(torch.bfloat16).float()
    assert one_bf16_ulp(got.numpy(), once.numpy()).all()
    assert (got != once).float().mean().item() <= 1e-3
