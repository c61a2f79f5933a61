"""The H2D probe's two TPU kernels in the port: the row dot (`ops.rowdot`,
K10b) vs the probe's Pallas body, and the 512x512 fp32 product (K10a, on
`ops.pdot`) vs `jnp.dot` at HIGHEST; and the GPU-only scripts (the probe,
the block-1 bench, the serving bf16 bar) refusing to run without a card.

On the CPU the port's wrappers run their plain PyTorch versions; the Pallas
body runs in interpret mode. The CUDA kernels are held against the plain
versions by tests/test_torch_cuda.py and chip_smoke.py phase 18.
"""

import inspect
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from zeroshotsemanticsegmentation_tpu_torch.ops import pdot as tpd
from zeroshotsemanticsegmentation_tpu_torch.ops import rowdot as trd

torch.set_num_threads(1)

_ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _pallas_rowdot(a, b, th):
    """scripts/probe_h2d.py's `rowdot` (:763-778), row tile `th`."""
    def kern(a_ref, b_ref, o_ref):
        o_ref[...] = jnp.sum(a_ref[...] * b_ref[...], axis=-1)

    bsz, h, w, c = a.shape
    return pl.pallas_call(
        kern, grid=(bsz, h // th),
        in_specs=[pl.BlockSpec((1, th, w, c), lambda i, j: (i, j, 0, 0))] * 2,
        out_specs=pl.BlockSpec((1, th, w), lambda i, j: (i, j, 0)),
        out_shape=jax.ShapeDtypeStruct((bsz, h, w), jnp.float32),
        interpret=True)(a, b)


@pytest.mark.parametrize("shape,th", [((2, 16, 8, 21), 8), ((1, 4, 6, 1), 2),
                                      ((1, 4, 3, 300), 4)])
def test_rowdot_plain_matches_pallas_body(rng, shape, th):
    a = rng.randn(*shape).astype(np.float32)
    b = rng.randn(*shape).astype(np.float32)
    want = np.asarray(_pallas_rowdot(jnp.asarray(a), jnp.asarray(b), th))
    got = trd.rowdot(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:-1]
    # sums of C products in another order: fp32 rounding, scaled by the
    # terms' magnitudes
    scale = np.abs(a * b).sum(-1)
    np.testing.assert_array_less(np.abs(got.numpy() - want),
                                 1e-6 * (1.0 + scale))


def test_rowdot_plain_is_the_ordered_sum(rng):
    """The plain version sums in channel order from 0.0, one rounding per
    product and per addition (the contract K10b meets bit for bit)."""
    a = rng.randn(3, 5, 7).astype(np.float32)
    b = rng.randn(3, 5, 7).astype(np.float32)
    want = np.zeros((3, 5), np.float32)
    for c in range(7):
        want = want + a[..., c] * b[..., c]
    got = trd.rowdot(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("args", [((2, 3), (2, 4), torch.float32),
                                  ((2, 3), (2, 3), torch.float64)])
def test_rowdot_refuses(args):
    sa, sb, dtype = args
    with pytest.raises(ValueError):
        trd.rowdot(torch.zeros(sa, dtype=dtype), torch.zeros(sb, dtype=dtype))


def test_pdot_fp32_matches_jax_highest(rng):
    """K10a's product, (512, 512) @ (512, 512) in fp32 (on K7 on a card;
    the plain version here) vs jnp.dot at Precision.HIGHEST."""
    a = rng.randn(512, 512).astype(np.float32)
    b = rng.randn(512, 512).astype(np.float32)
    want = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(b),
                              precision=jax.lax.Precision.HIGHEST),
                      np.float64)
    got = tpd.pdot(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (512, 512)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    err = np.linalg.norm(got.numpy().astype(np.float64) - want)
    assert err / np.linalg.norm(want) < 1e-5
    assert np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref) < 1e-5


def _flat(text):
    return " ".join(text.split())


@pytest.mark.parametrize("body,copy", [
    # K10b: the body `_pallas_rowdot` copies
    ("o_ref[...] = jnp.sum(a_ref[...] * b_ref[...], axis=-1)",
     _pallas_rowdot),
    # K10a: the fp32 product the port runs on ops.pdot
    ("o_ref[...] = jnp.dot(a_ref[...], b_ref[...], "
     "preferred_element_type=jnp.float32)", None)])
def test_probe_kernel_bodies_unchanged(body, copy):
    """The probe's Pallas bodies are still the ones ported here: a change to
    scripts/probe_h2d.py fails this test before the copy above drifts."""
    with open(osp.join(_ROOT, "scripts", "probe_h2d.py")) as f:
        assert _flat(body) in _flat(f.read())
    if copy is not None:
        assert _flat(body) in _flat(inspect.getsource(copy))


@pytest.mark.parametrize("script", ["torch_probe_h2d.py",
                                    "torch_bench_block1.py",
                                    "torch_serving_bar.py",
                                    "torch_kernel_times.py"])
def test_gpu_scripts_refuse_without_a_card(script):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run")
    r = subprocess.run([sys.executable, osp.join(_ROOT, "scripts", script)],
                       capture_output=True, text=True, timeout=120,
                       cwd=_ROOT)
    assert r.returncode != 0
    assert "needs an NVIDIA GPU" in r.stderr
    assert r.stdout == ""
