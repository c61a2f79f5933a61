"""The port's conv1_1 alone (`ops.block1_fused.conv1_1_pairs`, K8) vs the
JAX package's `conv1_1_pairs` Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX kernel
runs in interpret mode, as tests/test_block1_fused.py runs it. The CUDA
kernel is held against the plain version by tests/test_torch_cuda.py and
chip_smoke.py phase 16.
"""

import functools

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


def _inputs(rng, hw):
    xp = rng.randn(2, *hw, 3).astype(np.float32)
    k1 = rng.randn(3, 3, 3, 64).astype(np.float32) * 0.2   # HWIO
    b1 = rng.randn(64).astype(np.float32) * 0.1
    return xp, k1, b1


def _oihw(k1):
    return torch.from_numpy(np.ascontiguousarray(k1.transpose(3, 2, 0, 1)))


def within_one_bf16_ulp(a, b):
    """|a - b| <= 2^-8 max(|a|, |b|) + 1e-6 elementwise; the atol covers
    pre-ReLU sums near 0 that the fp32 summation order puts on either
    side."""
    return np.abs(a - b) <= 2.0 ** -8 * np.maximum(np.abs(a), np.abs(b)) \
        + 1e-6


@pytest.mark.parametrize("hw", [(38, 42), (66, 34)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1_1_pairs_matches_jax_kernel(rng, hw, dtype):
    xp, k1, b1 = _inputs(rng, hw)
    want = np.asarray(jb1.conv1_1_pairs(
        jnp.asarray(xp), jnp.asarray(k1), jnp.asarray(b1),
        dtype=getattr(jnp, dtype)).astype(jnp.float32))
    got = tb1.conv1_1_pairs(torch.from_numpy(xp), _oihw(k1),
                            torch.from_numpy(b1),
                            dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape == (2, hw[0] - 2,
                                              (hw[1] - 2) // 2, 128)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        ok = within_one_bf16_ulp(got, want)
        assert ok.all(), (np.abs(got - want)[~ok].max(), (~ok).sum())


def test_conv1_1_pairs_feeds_conv2_pool(rng):
    """K8's output viewed as NHWC c11 and pooled by K3's plain version ==
    the JAX block-1 reference (fp32, the JAX block-1 bar)."""
    xp, k1, b1 = _inputs(rng, (38, 42))
    k2 = rng.randn(3, 3, 64, 64).astype(np.float32) * 0.05
    b2 = rng.randn(64).astype(np.float32) * 0.1
    want = np.asarray(jb1.xla_block1(
        *(jnp.asarray(a) for a in (xp, k1, b1, k2, b2)), dtype=jnp.float32))
    pairs = tb1.conv1_1_pairs(torch.from_numpy(xp), _oihw(k1),
                              torch.from_numpy(b1), dtype=torch.float32)
    c11 = pairs.view(2, 36, 40, 64)
    got = tb1.conv2_pool_plain(
        c11, torch.from_numpy(np.ascontiguousarray(k2.transpose(3, 2, 0, 1))),
        torch.from_numpy(b2)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [(1, 37, 42, 3), (1, 38, 41, 3),
                                   (1, 2, 8, 3), (1, 8, 8, 4)])
def test_conv1_1_pairs_refuses_geometry(shape):
    with pytest.raises(ValueError):
        tb1.conv1_1_pairs(torch.zeros(shape), torch.zeros(64, 3, 3, 3),
                          torch.zeros(64))
