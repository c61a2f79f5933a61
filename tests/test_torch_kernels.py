"""The port's kernel modules vs the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run as the JAX package's own tests run them here (interpret mode).
The CUDA kernels are held against their plain versions by
tests/test_torch_cuda.py and, at the serving shapes, by chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import zeroshotsemanticsegmentation_tpu.ops.block1_fused as jb1
from zeroshotsemanticsegmentation_tpu.ops import upsample_bilinear_cropped
from zeroshotsemanticsegmentation_tpu.ops.metrics import unseen_mask_vector
from zeroshotsemanticsegmentation_tpu.ops.nne import infer_labels_szn
from zeroshotsemanticsegmentation_tpu.ops.szn_fused import (
    infer_labels_nne_fused as j_nne_fused, infer_labels_szn_fused as j_szn)
from zeroshotsemanticsegmentation_tpu_torch.ops import block1_fused as tb1
from zeroshotsemanticsegmentation_tpu_torch.ops import szn_fused as tsz

torch.set_num_threads(1)

T = torch.from_numpy


def _embed(rng, k, c):
    e = rng.randn(k, c).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


# ---------------------------------------------------------------- SZN (K1)

@pytest.mark.parametrize("b,h32,w32,c,k,out", [
    (2, 5, 5, 20, 21, (96, 96)),
    (1, 4, 6, 20, 33, (70, 130)),
])
def test_szn_plain_matches_jax_kernel(rng, b, h32, w32, c, k, out):
    score = rng.randn(b, h32, w32, c).astype(np.float32)
    sm = rng.randn(b, h32, w32, 2).astype(np.float32)
    embed = _embed(rng, k, c)
    uv = unseen_mask_vector(k, [1, k - 2])
    want = np.asarray(j_szn(jnp.asarray(score), jnp.asarray(sm),
                            jnp.asarray(embed), jnp.asarray(uv), out,
                            row_tile=16))
    got = tsz.infer_labels_szn_fused(T(score), T(sm), embed, uv, out).numpy()
    assert got.shape == want.shape and got.dtype == np.int32
    assert (got != want).mean() < 1e-4
    assert got.max() < k


def test_szn_plain_edge_cases(rng):
    """Zero-norm score pixels, a zeroed embedding row and all-negative
    similarities (a masked-to-0.0 class must win then), vs the JAX kernel
    and the unfused JAX pipeline."""
    score = rng.randn(1, 4, 5, 8).astype(np.float32)
    score[0, :2] = 0.0
    embed = _embed(rng, 9, 8)
    embed[3] = 0.0
    uv = unseen_mask_vector(9, [3, 7])
    sm = rng.randn(1, 4, 5, 2).astype(np.float32)
    up = functools.partial(upsample_bilinear_cropped, stride=32,
                           kernel_size=64, crop_offset=19, out_h=70, out_w=90)
    unfused = np.asarray(infer_labels_szn(
        up(jnp.asarray(score)), up(jnp.asarray(sm)), jnp.asarray(embed),
        jnp.asarray(uv)))
    fused = np.asarray(j_szn(jnp.asarray(score), jnp.asarray(sm),
                             jnp.asarray(embed), jnp.asarray(uv), (70, 90),
                             row_tile=16))
    got = tsz.infer_labels_szn_fused(T(score), T(sm), embed, uv,
                                     (70, 90)).numpy()
    assert (got != fused).mean() < 1e-3
    assert (got != unfused).mean() < 1e-3
    assert got.max() < 9

    neg = -np.abs(rng.randn(1, 4, 5, 8)).astype(np.float32)
    want2 = np.asarray(j_nne_fused(jnp.asarray(neg), jnp.asarray(embed),
                                   (70, 90), row_tile=16))
    got2 = tsz.infer_labels_nne_fused(T(neg), embed, (70, 90)).numpy()
    assert (got2 != want2).mean() < 1e-3
    assert got2.max() < 9


def test_nne_plain_matches_jax_kernel(rng):
    score = rng.randn(2, 5, 5, 16).astype(np.float32)
    embed = _embed(rng, 11, 16)
    want = np.asarray(j_nne_fused(jnp.asarray(score), jnp.asarray(embed),
                                  (96, 96), row_tile=16))
    got = tsz.infer_labels_nne_fused(T(score), embed, (96, 96)).numpy()
    assert (got != want).mean() < 1e-4
    assert got.max() < 11


def test_szn_taps_reproduce_matrix():
    """The kernel's 2-tap tables are the interpolation matrix's nonzeros
    for every side the 1/32 heads take up to 1024 px."""
    for out_len in (64, 70, 375, 500, 512, 1024):
        in_len = (out_len + 198 - 2) // 32 - 5   # h32 of the FCN geometry
        for n in (in_len, in_len + 1):
            i0, w = tsz._taps(n, out_len, "cpu")
            assert i0.dtype == torch.int32 and w.shape == (2, out_len)


# ------------------------------------------------------------- block 1 (K2)

@pytest.fixture
def jax_interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _b1_params(rng):
    return (rng.randn(3, 3, 3, 64).astype(np.float32) * 0.2,
            rng.randn(64).astype(np.float32) * 0.1,
            rng.randn(3, 3, 64, 64).astype(np.float32) * 0.05,
            rng.randn(64).astype(np.float32) * 0.1)


def _oihw(k):
    return T(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("hw", [(78, 82), (30, 26)])
def test_block1_plain_matches_jax_fp32(rng, jax_interpret, hw):
    xp = rng.randn(2, *hw, 3).astype(np.float32)
    k1, b1, k2, b2 = _b1_params(rng)
    jargs = [jnp.asarray(a) for a in (xp, k1, b1, k2, b2)]
    full = np.asarray(jb1.fused_block1_full(*jargs, dtype=jnp.float32))
    ref = np.asarray(jb1.xla_block1(*jargs, dtype=jnp.float32))
    got = tb1.block1_op(T(xp), _oihw(k1), T(b1), _oihw(k2), T(b2),
                        torch.float32).numpy()
    assert got.shape == ref.shape == (2, (hw[0] - 4) // 2, (hw[1] - 4) // 2,
                                      64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, full, rtol=0, atol=1e-4)


def test_block1_plain_bf16_within_two_ulp(rng, jax_interpret):
    """bf16: every deviation from the fp32 reference and from the JAX bf16
    kernel stays within 2 bf16 ULPs at the output's max magnitude (the bar
    of the JAX package's test_full_vs_twostage_bf16_parity)."""
    xp = rng.randn(2, 30, 26, 3).astype(np.float32)
    k1, b1, k2, b2 = _b1_params(rng)
    jargs = [jnp.asarray(a) for a in (xp, k1, b1, k2, b2)]
    ref = np.asarray(jb1.xla_block1(*jargs, dtype=jnp.float32))
    full = np.asarray(jb1.fused_block1_full(
        *jargs, dtype=jnp.bfloat16)).astype(np.float32)
    got = tb1.block1_op(T(xp), _oihw(k1), T(b1), _oihw(k2), T(b2),
                        torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp_at_scale = np.abs(ref).max() * 2.0 ** -8
    assert np.abs(got - ref).max() <= 2 * ulp_at_scale
    assert np.abs(got - full).max() <= 2 * ulp_at_scale


def test_block1_geometry_checks(rng):
    k = torch.zeros(64, 3, 3, 3), torch.zeros(64), torch.zeros(64, 64, 3, 3)
    with pytest.raises(ValueError, match="even"):
        tb1.block1_op(torch.zeros(1, 77, 82, 3), *k, torch.zeros(64),
                      torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tb1.block1_fused(torch.zeros(1, 30, 30, 3), *k, torch.zeros(64),
                         torch.float32)


# ------------------------------------------- block 1 under training (K3/K4)

@pytest.fixture
def plain_train(monkeypatch):
    """Routes `Conv2Pool` (K3 forward, K4 backward) through the kernels'
    plain versions, so the CPU runs the training form itself."""
    monkeypatch.setattr(tb1, "conv2_pool", tb1.conv2_pool_plain)
    monkeypatch.setattr(tb1, "conv2_pool_backward",
                        tb1.conv2_pool_plain_backward)


@pytest.mark.parametrize("hw", [(30, 34), (30, 26), (78, 82)])
def test_block1_train_matches_jax_two_stage(rng, jax_interpret, plain_train,
                                            hw):
    """The training form (conv1_1 as torch ops, then K3/K4's plain
    versions) vs the JAX two-stage `fused_block1` (K3 and K4 in interpret
    mode): fp32 values at atol 1e-4 and the gradients of all five inputs
    under a weighted-sum loss at relative norm < 1e-4
    (test_block1_fused.py:62-88)."""
    xp = rng.randn(2, *hw, 3).astype(np.float32)
    k1, b1, k2, b2 = _b1_params(rng)
    gseed = rng.randn(2, (hw[0] - 4) // 2, (hw[1] - 4) // 2,
                      64).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (k1, b1, k2, b2, xp)]

    def jloss(k1_, b1_, k2_, b2_, xp_):
        return jnp.sum(jb1.fused_block1(xp_, k1_, b1_, k2_, b2_,
                                        dtype=jnp.float32) * gseed)

    want_out = np.asarray(jb1.fused_block1(jargs[4], *jargs[:4],
                                           dtype=jnp.float32))
    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*jargs)
    targs = [_oihw(k1).requires_grad_(), T(b1).requires_grad_(),
             _oihw(k2).requires_grad_(), T(b2).requires_grad_(),
             T(xp).requires_grad_()]
    out = tb1.block1_train(targs[4], *targs[:4], torch.float32)
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=0,
                               atol=1e-4)
    got = torch.autograd.grad(torch.sum(out * T(gseed)), targs)
    hwio = lambda g: g.permute(2, 3, 1, 0)  # noqa: E731  OIHW -> HWIO
    for name, a, b in zip(("k1", "b1", "k2", "b2", "xp"),
                          (hwio(got[0]), got[1], hwio(got[2]), got[3],
                           got[4]), want):
        a, b = a.double().numpy(), np.asarray(b, np.float64)
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
        assert rel < 1e-4, (name, rel)


def test_block1_train_bf16_within_two_ulp(rng, jax_interpret, plain_train):
    """bf16 training form vs the fp32 reference and the JAX bf16 two-stage
    kernel: within 2 bf16 ULPs at the output's max magnitude."""
    xp = rng.randn(2, 30, 26, 3).astype(np.float32)
    k1, b1, k2, b2 = _b1_params(rng)
    jargs = [jnp.asarray(a) for a in (xp, k1, b1, k2, b2)]
    ref = np.asarray(jb1.xla_block1(*jargs, dtype=jnp.float32))
    two = np.asarray(jb1.fused_block1(
        *jargs, dtype=jnp.bfloat16)).astype(np.float32)
    got = tb1.block1_train(T(xp), _oihw(k1), T(b1), _oihw(k2), T(b2),
                           torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp_at_scale = np.abs(ref).max() * 2.0 ** -8
    assert np.abs(got - ref).max() <= 2 * ulp_at_scale
    assert np.abs(got - two).max() <= 2 * ulp_at_scale


def test_block1_op_on_cpu_differentiates_plain(rng):
    """On the CPU block1_op under grad is block1_plain under autograd, and
    the training form's checks reject a bad c11 before any launch."""
    xp = T(rng.randn(1, 30, 34, 3).astype(np.float32))
    k1, b1, k2, b2 = (T(a) for a in _b1_params(rng))
    k1 = k1.permute(3, 2, 0, 1).contiguous().requires_grad_()
    out = tb1.block1_op(xp, k1, b1, k2.permute(3, 2, 0, 1), b2,
                        torch.float32)
    assert out.grad_fn is not None
    with pytest.raises(ValueError, match="even"):
        tb1.conv2_pool_plain(torch.zeros(1, 9, 10, 64), torch.zeros(
            64, 64, 3, 3), torch.zeros(64))
    with pytest.raises(ValueError, match="CUDA"):
        tb1.conv2_pool(torch.zeros(1, 10, 10, 64), torch.zeros(64, 64, 3, 3),
                       torch.zeros(64))
