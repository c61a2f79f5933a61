"""The port's fused cosine tail vs the JAX package's Pallas tail.

On the CPU `fused_cos_tail` runs its plain version (`cos_tail_plain`,
differentiated by autograd: the plain versions of K5 and K6); the JAX tail
runs its Pallas kernels in interpret mode, as the JAX package's own tests
run them here. Shapes, edge cases and bars are those of
tests/test_costail_fused.py. The CUDA kernels are held against the plain
versions by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotsemanticsegmentation_tpu.ops.costail_fused import (
    fused_cos_tail as j_tail)
from zeroshotsemanticsegmentation_tpu_torch.ops.costail_fused import (
    cos_tail_plain_backward, fused_cos_tail)
from zeroshotsemanticsegmentation_tpu_torch.ops.losses import l2_normalize

torch.set_num_threads(1)

T = torch.from_numpy


def _data(rng, b, h, w, c, n, *, zero_row=False, zero_pixels=False):
    score = rng.randn(b, h, w, c).astype(np.float32)
    label = rng.randint(-1, n, (b, h, w)).astype(np.int32)
    temb = rng.randn(n, c).astype(np.float32)
    iemb = rng.randn(n, c).astype(np.float32)
    if zero_row:
        temb[0] = 0.0
        iemb[3] = 0.0
    if zero_pixels:
        score[:, :2, :3] = 0.0
    return score, label, temb, iemb


def _hold_hist(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got.sum(axis=1), want.sum(axis=1))
    assert np.abs(got - want).sum() <= max(16, 0.005 * want.sum())


@pytest.mark.parametrize("shape", [(2, 16, 16), (3, 37, 53), (1, 8, 8)])
def test_forward_matches_jax(rng, shape):
    b, h, w = shape
    c, n = 20, 21
    score, label, temb, iemb = _data(rng, b, h, w, c, n, zero_row=True,
                                     zero_pixels=True)
    want = j_tail(jnp.asarray(score), jnp.asarray(label), jnp.asarray(temb),
                  jnp.asarray(iemb), n, tile=256)
    losses, hist, ssum = fused_cos_tail(T(score), T(label), temb, iemb, n)
    assert losses.shape == (b,) and hist.dtype == torch.int32
    np.testing.assert_allclose(losses.numpy(), np.asarray(want[0]),
                               rtol=2e-6, atol=2e-6)
    _hold_hist(hist.numpy(), want[1])
    np.testing.assert_allclose(ssum.item(), float(want[2]), rtol=1e-5,
                               atol=1e-7 * float(np.sum(np.abs(score))))


def test_all_ignore_sample(rng):
    """A sample with no valid pixel has loss 0 and adds nothing to the
    histogram."""
    c, n = 8, 5
    score, label, temb, iemb = _data(rng, 2, 8, 8, c, n)
    label[1] = -1
    want = j_tail(jnp.asarray(score), jnp.asarray(label), jnp.asarray(temb),
                  jnp.asarray(iemb), n, tile=64)
    losses, hist, _ = fused_cos_tail(T(score), T(label), temb, iemb, n)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want[0]),
                               rtol=2e-6, atol=2e-6)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(want[1]))
    assert losses[1].item() == 0.0


@pytest.mark.parametrize("zero_norm", [False, True])
def test_grad_matches_jax(rng, zero_norm):
    """d score of a weighted loss sum plus the score sum, including the
    double-where derivative (t^) at zero-norm pixels."""
    b, h, w, c, n = 2, 24, 16, 12, 9
    score, label, temb, iemb = _data(rng, b, h, w, c, n, zero_row=True,
                                     zero_pixels=True)
    if zero_norm:
        score[:, :4] = 0.0
    wvec = rng.randn(b).astype(np.float32)

    def j_scalar(s):
        losses, _, ssum = j_tail(s, jnp.asarray(label), jnp.asarray(temb),
                                 jnp.asarray(iemb), n, tile=128)
        return jnp.sum(losses * wvec) + 0.37 * ssum

    v_want, g_want = jax.value_and_grad(j_scalar)(jnp.asarray(score))
    s = T(score).requires_grad_()
    losses, _, ssum = fused_cos_tail(s, T(label), temb, iemb, n)
    v = torch.sum(losses * T(wvec)) + 0.37 * ssum
    g = torch.autograd.grad(v, s)[0]
    np.testing.assert_allclose(v.item(), float(v_want), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_want), rtol=2e-5,
                               atol=2e-6)
    g2 = cos_tail_plain_backward(T(score), T(label), T(temb), T(iemb), n,
                                 T(wvec), torch.tensor(0.37))
    torch.testing.assert_close(g2, g)


def test_l2_normalize_and_checks(rng):
    e = rng.randn(4, 6).astype(np.float32)
    e[2] = 0.0
    got = l2_normalize(T(e)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got[[0, 1, 3]], axis=1), 1.0,
                               rtol=1e-6)
    assert not got[2].any()
    score, label = T(np.zeros((1, 4, 4, 6), np.float32)), torch.zeros(
        1, 4, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="num_classes"):
        fused_cos_tail(score, label, e, e[:3], 4)
    big = np.zeros((128, 6), np.float32)
    with pytest.raises(ValueError, match="127"):
        fused_cos_tail(score, label, big, big, 128)
