"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is false. The module imports torch and the port only, so it runs on a GPU
machine without JAX; `--noconftest` keeps pytest from loading
tests/conftest.py, which imports JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
from zeroshotsemanticsegmentation_tpu_torch.ops import block1_fused as tb1
from zeroshotsemanticsegmentation_tpu_torch.ops import costail_fused as tct
from zeroshotsemanticsegmentation_tpu_torch.ops import szn_fused as tsz
from zeroshotsemanticsegmentation_tpu_torch.ops.metrics import (
    unseen_mask_vector)

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.RandomState(1337)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape,out", [((3, 17, 17, 20), (512, 500)),
                                       ((2, 5, 5, 20), (96, 96))])
def test_szn_kernel_matches_plain(rng, cuda, shape, out):
    score = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda)
    sm = torch.from_numpy(
        rng.randn(*shape[:3], 2).astype(np.float32)).to(cuda)
    embed = rng.randn(21, shape[-1]).astype(np.float32)
    uv = unseen_mask_vector(21, [1, 13])
    before = _kernels.launch_counts["szn_fused"]
    got = tsz.infer_labels_szn_fused(score, sm, embed, uv, out)
    assert _kernels.launch_counts["szn_fused"] == before + 1
    want = tsz.infer_labels_szn_fused(score.cpu(), sm.cpu(), embed, uv, out)
    assert got.shape == (shape[0], *out) and got.dtype == torch.int32
    assert (got.cpu() != want).float().mean().item() < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(46, 38), (30, 26)])
def test_block1_kernel_matches_plain(rng, cuda, dtype, hw):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)

    xp = t(rng.randn(2, *hw, 3).astype(np.float32))
    args = (t(rng.randn(64, 3, 3, 3).astype(np.float32) * 0.2),
            t(rng.randn(64).astype(np.float32) * 0.1),
            t(rng.randn(64, 64, 3, 3).astype(np.float32) * 0.05),
            t(rng.randn(64).astype(np.float32) * 0.1))
    before = _kernels.launch_counts["block1_fused"]
    with torch.inference_mode():
        got = tb1.block1_op(xp, *args, dtype)
        ref = tb1.block1_plain(xp, *args, torch.float32)
    assert _kernels.launch_counts["block1_fused"] == before + 1
    assert got.dtype == dtype and got.shape == ref.shape
    err = (got.float() - ref).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4
    else:
        assert err <= 2 * ref.abs().max().item() * 2.0 ** -8


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _b1_weights(rng, dev):
    return (_t(rng.randn(64, 3, 3, 3).astype(np.float32) * 0.2, dev),
            _t(rng.randn(64).astype(np.float32) * 0.1, dev),
            _t(rng.randn(64, 64, 3, 3).astype(np.float32) * 0.05, dev),
            _t(rng.randn(64).astype(np.float32) * 0.1, dev))


def _rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp(min=1e-12)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(28, 32), (28, 24), (76, 80)])
def test_conv2_pool_kernel_matches_plain(rng, cuda, dtype, hw):
    """K3 vs its plain version: fp32 at atol 1e-4, bf16 within 2 ULPs at
    the output's scale."""
    c11 = _t(np.maximum(rng.randn(2, *hw, 64), 0).astype(np.float32),
             cuda).to(dtype)
    _, _, k2, b2 = _b1_weights(rng, cuda)
    before = _kernels.launch_counts["block1_train_fwd"]
    got = tb1.conv2_pool(c11, k2, b2)
    assert _kernels.launch_counts["block1_train_fwd"] == before + 1
    ref = tb1.conv2_pool_plain(c11.float(), k2.to(dtype), b2)
    assert got.dtype == dtype and got.shape == ref.shape
    err = (got.float() - ref).abs().max().item()
    bar = 1e-4 if dtype == torch.float32 else \
        2 * ref.abs().max().item() * 2.0 ** -8
    assert err <= bar, (err, bar)


@pytest.mark.parametrize("hw", [(28, 32), (28, 24), (76, 80)])
def test_conv2_pool_backward_matches_plain(rng, cuda, hw):
    """K4 vs autograd of the plain K3 version, fp32, every output at
    relative norm < 1e-4."""
    c11 = _t(np.maximum(rng.randn(2, *hw, 64), 0).astype(np.float32), cuda)
    _, _, k2, b2 = _b1_weights(rng, cuda)
    g = _t(rng.randn(2, (hw[0] - 2) // 2, (hw[1] - 2) // 2, 64)
           .astype(np.float32), cuda)
    before = _kernels.launch_counts["block1_train_bwd"]
    got = tb1.conv2_pool_backward(c11, k2, b2, g)
    assert _kernels.launch_counts["block1_train_bwd"] == before + 1
    want = tb1.conv2_pool_plain_backward(c11, k2, b2, g)
    for name, a, b in zip(("dc11", "dk2", "db2"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel(a, b) < 1e-4, (name, _rel(a, b))


def test_block1_op_under_grad_runs_k3_k4(rng, cuda):
    """block1_op under grad on the card launches K3 forward and K4 backward
    and not K2; its gradients equal autograd of the plain version."""
    xp = _t(rng.randn(2, 30, 34, 3).astype(np.float32), cuda)
    wts = [w.requires_grad_() for w in _b1_weights(rng, cuda)]
    g = _t(rng.randn(2, 13, 15, 64).astype(np.float32), cuda)
    _kernels.reset_launch_counts()
    out = tb1.block1_op(xp, *wts, torch.float32)
    got = torch.autograd.grad(out, wts, g)
    counts = dict(_kernels.launch_counts)
    assert counts["block1_train_fwd"] == 1 and counts["block1_train_bwd"] \
        == 1 and counts["block1_fused"] == 0, counts
    ref = tb1.block1_plain(xp, *wts, torch.float32)
    want = torch.autograd.grad(ref, wts, g)
    assert (out - ref).abs().max().item() <= 1e-4
    for name, a, b in zip(("k1", "b1", "k2", "b2"), got, want):
        assert _rel(a, b) < 1e-4, (name, _rel(a, b))


@pytest.mark.parametrize("shape", [(2, 16, 16), (3, 37, 53), (1, 8, 8)])
def test_cos_tail_kernels_match_plain(rng, cuda, shape):
    """K5 and K6 vs their plain versions with ignore labels, a zeroed
    embedding row, zero-norm pixels and an all-ignore sample."""
    b, h, w = shape
    c, n = 20, 21
    score = rng.randn(b, h, w, c).astype(np.float32)
    score[:, :2, :3] = 0.0
    label = rng.randint(-1, n, (b, h, w)).astype(np.int32)
    if b > 1:
        label[-1] = -1  # an all-ignore sample
    temb = rng.randn(n, c).astype(np.float32)
    iemb = rng.randn(n, c).astype(np.float32)
    temb[0] = 0.0
    iemb[3] = 0.0
    s, lbl = _t(score, cuda).requires_grad_(), _t(label, cuda)
    gw = _t(rng.randn(b).astype(np.float32), cuda)
    before = (_kernels.launch_counts["costail_fwd"],
              _kernels.launch_counts["costail_bwd"])
    losses, hist, ssum = tct.fused_cos_tail(s, lbl, temb, iemb, n)
    ds = torch.autograd.grad((losses * gw).sum() + 0.37 * ssum, s)[0]
    assert (_kernels.launch_counts["costail_fwd"],
            _kernels.launch_counts["costail_bwd"]) == (before[0] + 1,
                                                       before[1] + 1)
    te, ie = torch.from_numpy(temb).to(cuda), torch.from_numpy(iemb).to(cuda)
    w_losses, w_hist, w_ssum = tct.cos_tail_plain(s.detach(), lbl, te, ie, n)
    w_ds = tct.cos_tail_plain_backward(s.detach(), lbl, te, ie, n, gw,
                                       torch.tensor(0.37, device=cuda))
    torch.testing.assert_close(losses, w_losses, rtol=1e-5, atol=2e-6)
    torch.testing.assert_close(ssum, w_ssum, rtol=1e-5,
                               atol=1e-7 * float(np.abs(score).sum()))
    hg, hw_ = hist.cpu().numpy(), w_hist.cpu().numpy()
    np.testing.assert_array_equal(hg.sum(axis=1), hw_.sum(axis=1))
    assert np.abs(hg - hw_).sum() <= max(16, 0.005 * hw_.sum())
    torch.testing.assert_close(ds, w_ds, rtol=2e-5, atol=2e-6)


def test_cos_tail_kernel_limits(cuda):
    """The tail kernels keep a pixel's C scores in registers (C <= 32):
    wider embeddings raise on the card, where the JAX tail takes any C
    (ROADMAP.md queue 3)."""
    score = torch.zeros(1, 8, 8, 50, device=cuda)
    label = torch.zeros(1, 8, 8, dtype=torch.int32, device=cuda)
    emb = torch.ones(5, 50, device=cuda)
    with pytest.raises(ValueError, match="C <= 32"):
        tct.fused_cos_tail(score, label, emb, emb, 5)
