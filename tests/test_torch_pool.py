"""The port's dense first-max max pool (`ops.pool_bwd`, K9) vs the JAX
package's experiment `scripts/experiments/pool_bwd_pallas.py`.

On the CPU the port's backward runs its plain PyTorch version; the JAX
module's backward runs its XLA chain here, and its Pallas kernel runs in
interpret mode. Every comparison is exact. The CUDA kernel is held against
the plain version by tests/test_torch_cuda.py and chip_smoke.py phase 17.
"""

import importlib.util
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotsemanticsegmentation_tpu_torch.ops import pool_bwd as tpb

torch.set_num_threads(1)

_SPEC = importlib.util.spec_from_file_location(
    "pool_bwd_pallas_reference",
    osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "scripts",
             "experiments", "pool_bwd_pallas.py"))
jpb = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(jpb)


def _x(rng, kind, shape):
    """The JAX test's three input kinds (test_pool_bwd_pallas.py:29-53)."""
    if kind == "dense_ties":   # small integers: most windows hold a tie
        return rng.randint(0, 3, shape).astype(np.float32)
    if kind == "relu_zeros":   # many exact zeros, the common tie in VGG
        x = np.maximum(rng.randn(*shape), 0).astype(np.float32)
        x[x < 0.5] = 0.0
        return x
    return rng.randn(*shape).astype(np.float32)


def _port_pool_and_grad(x, g, pool):
    xt = torch.from_numpy(x).requires_grad_()
    y = pool(xt)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    return y.detach().numpy(), dx.numpy()


def _jax_pool_and_grad(x, g, pool):
    y, vjp = jax.vjp(pool, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("kind", ["dense_ties", "relu_zeros", "smooth"])
def test_max_pool_matches_jax(rng, kind):
    x = _x(rng, kind, (2, 8, 10, 4))
    g = rng.randn(2, 4, 5, 4).astype(np.float32)
    got = _port_pool_and_grad(x, g, tpb.max_pool_2x2)
    want = _jax_pool_and_grad(x, g, jpb.max_pool_2x2)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(1, 7, 9, 2), (2, 9, 8, 3), (1, 8, 7, 5)])
def test_ceil_max_pool_matches_jax(rng, shape):
    x = _x(rng, "dense_ties", shape)
    g = rng.randn(shape[0], -(-shape[1] // 2), -(-shape[2] // 2),
                  shape[3]).astype(np.float32)
    got = _port_pool_and_grad(x, g, tpb.ceil_max_pool_2x2)
    want = _jax_pool_and_grad(x, g, jpb.ceil_max_pool_2x2)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_max_pool_bf16_matches_jax(rng):
    x = rng.randn(2, 6, 6, 8).astype(np.float32)
    g = rng.randn(2, 3, 3, 8).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    y = tpb.max_pool_2x2(xt)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g).to(torch.bfloat16))
    jy, vjp = jax.vjp(jpb.max_pool_2x2, jnp.asarray(x, jnp.bfloat16))
    (jdx,) = vjp(jnp.asarray(g, jnp.bfloat16))
    assert y.dtype == dx.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))
    np.testing.assert_array_equal(dx.float().numpy(),
                                  np.asarray(jdx.astype(jnp.float32)))


@pytest.mark.parametrize("kind", ["dense_ties", "relu_zeros", "smooth"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_bwd_plain_matches_pallas_kernel(rng, kind, dtype):
    """The plain version vs the TPU kernel body itself (interpret mode),
    with a row count the kernel pads to its tile (-inf rows)."""
    x = _x(rng, kind, (2, 20, 12, 16))
    g = rng.randn(2, 10, 6, 16).astype(np.float32)
    jx, jg = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, g))
    jy = jpb.max_pool_2x2(jx)
    want = np.asarray(jpb.pool_bwd_pallas(jx, jy, jg, interpret=True)
                      .astype(jnp.float32))
    tx, tg = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, g))
    ty = tpb.max_pool_2x2(tx)
    np.testing.assert_array_equal(ty.float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))
    got = tpb.pool_bwd(tx, ty, tg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_pool_bwd_routes_to_last_when_nothing_matches():
    """A window whose pooled value matches none of its elements (a NaN)
    sends the cotangent to element 11, as the TPU kernel does."""
    x = torch.zeros(1, 2, 2, 1)
    y = torch.full((1, 1, 1, 1), float("nan"))
    g = torch.full((1, 1, 1, 1), 3.0)
    dx = tpb.pool_bwd(x, y, g)
    assert dx.flatten().tolist() == [0.0, 0.0, 0.0, 3.0]


@pytest.mark.parametrize("args", [((1, 3, 4, 2), 0, 0), ((1, 4, 5, 2), 1, 0)])
def test_max_pool_refuses_odd_extents(args):
    shape, pb, pr = args
    with pytest.raises(ValueError):
        tpb.max_pool_2x2(torch.zeros(shape), pb, pr)
