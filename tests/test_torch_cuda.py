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
from zeroshotsemanticsegmentation_tpu_torch.ops import conv1x1 as tc1
from zeroshotsemanticsegmentation_tpu_torch.ops import conv7x7 as tc7
from zeroshotsemanticsegmentation_tpu_torch.ops import costail_fused as tct
from zeroshotsemanticsegmentation_tpu_torch.ops import dotpolicy as tdp
from zeroshotsemanticsegmentation_tpu_torch.ops import pdot as tpd
from zeroshotsemanticsegmentation_tpu_torch.ops import pool_bwd as tpb
from zeroshotsemanticsegmentation_tpu_torch.ops import ring_pad as rp
from zeroshotsemanticsegmentation_tpu_torch.ops import rowdot as trd
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


@pytest.mark.parametrize("shape", [(1, 22, 26), (3, 38, 42), (2, 70, 134),
                                   (1, 386, 510)])
def test_block1_wgmma_matches_plain_and_repeats(rng, cuda, shape):
    """bf16 K2 (`block1_fused_wgmma`, persistent: more tiles than SMs at
    (1, 386, 510)) vs the fp32 plain version at the 2-ULP bar, and two
    calls bit-equal."""
    xp = _t(rng.randn(*shape, 3).astype(np.float32), cuda)
    args = _b1_weights(rng, cuda)
    with torch.inference_mode():
        got = tb1.block1_fused(xp, *args, torch.bfloat16)
        again = tb1.block1_fused(xp, *args, torch.bfloat16)
        ref = tb1.block1_plain(xp, *args, torch.float32)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert (got.float() - ref).abs().max().item() <= \
        2 * ref.abs().max().item() * 2.0 ** -8
    assert torch.equal(got, again)


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


@pytest.mark.parametrize("b,hc,wc", [(1, 34, 34), (3, 34, 34),
                                     (1, 386, 510), (1, 522, 522),
                                     (1, 530, 530), (3, 66, 130)])
def test_conv2_pool_wgmma_matches_plain(rng, cuda, b, hc, wc):
    """bf16 K3 and K4 (the wgmma kernels) vs their plain versions at ragged
    tile edges, at the bars of chip_smoke.py phase 7: K3 within 2 bf16 ULPs
    at the output's scale, every K4 output at relative norm < 2^-8."""
    c11 = _t(np.maximum(rng.randn(b, hc, wc, 64), 0).astype(np.float32),
             cuda).to(torch.bfloat16)
    _, _, k2, b2 = _b1_weights(rng, cuda)
    k2 = k2.to(torch.bfloat16)
    got = tb1.conv2_pool(c11, k2, b2)
    want = tb1.conv2_pool_plain(c11, k2, b2)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2 * want.float().abs().max().item() * 2.0 ** -8, err
    g = torch.randn_like(want)
    dgot = tb1.conv2_pool_backward(c11, k2, b2, g)
    dwant = tb1.conv2_pool_plain_backward(c11, k2, b2, g)
    for name, a, w in zip(("dc11", "dk2", "db2"), dgot, dwant):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        assert _rel(a, w) < 2.0 ** -8, (name, _rel(a, w))


@pytest.mark.parametrize("b,hc,wc", [(2, 34, 34), (1, 386, 510)])
def test_conv2_pool_wgmma_route_and_determinism(rng, cuda, b, hc, wc):
    """With g = 1 each 2x2 window of K4's dz holds exactly one 1 where
    K3's pooled output is > 0 and only zeros where it is 0 (the route
    recomputes K3's pre-activations bit for bit); two K4 calls give
    bit-equal dK2, db2 and d(c11). The kernel's dK2 chunk count is the
    Python mirror's."""
    c11 = _t(rng.randn(b, hc, wc, 64).astype(np.float32), cuda).relu().to(
        torch.bfloat16)
    _, _, k2, b2 = _b1_weights(rng, cuda)
    k2 = k2.to(torch.bfloat16)
    pooled = tb1.conv2_pool(c11, k2, b2)
    bufs = tb1.k4_buffers(c11, k2, b2, torch.ones_like(pooled))
    assert bufs["n_chunks"] == tb1.wgrad_chunks(b, hc, wc, torch.bfloat16)
    tb1.k4_launch(bufs, tb1.K4_ROUTE)
    dz = bufs["dz"].float()
    windows = dz.view(b, hc // 2 - 1, 2, wc // 2 - 1, 2, 64).sum((2, 4))
    ones = (dz == 1).view(b, hc // 2 - 1, 2, wc // 2 - 1, 2, 64).sum((2, 4))
    assert torch.equal(windows, (pooled > 0).float())
    assert torch.equal(ones, (pooled > 0).long())
    g = torch.randn_like(pooled)
    first = tb1.conv2_pool_backward(c11, k2, b2, g)
    second = tb1.conv2_pool_backward(c11, k2, b2, g)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


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


def _cos_tail_case(cuda, score, label, temb, iemb, n):
    """K5 and K6 through `fused_cos_tail` vs their plain versions: one
    launch each, the bars of tests/test_costail_fused.py, and a second call
    bit-equal in losses, score sum, histogram and d score."""
    b = score.shape[0]
    s, lbl = _t(score, cuda).requires_grad_(), _t(label, cuda)
    gw = _t(np.linspace(-1.0, 1.5, b).astype(np.float32), cuda)
    runs = []
    for _ in range(2):
        before = (_kernels.launch_counts["costail_fwd"],
                  _kernels.launch_counts["costail_bwd"])
        losses, hist, ssum = tct.fused_cos_tail(s, lbl, temb, iemb, n)
        ds = torch.autograd.grad((losses * gw).sum() + 0.37 * ssum, s)[0]
        assert (_kernels.launch_counts["costail_fwd"],
                _kernels.launch_counts["costail_bwd"]) == (before[0] + 1,
                                                           before[1] + 1)
        runs.append((losses.detach(), hist, ssum.detach(), ds))
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)
    losses, hist, ssum, ds = runs[0]
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


@pytest.mark.parametrize("shape,c", [((2, 16, 16), 20), ((3, 37, 53), 20),
                                     ((1, 8, 8), 20), ((2, 353, 375), 21),
                                     ((2, 353, 375), 5), ((1, 3, 5), 20),
                                     ((1, 3, 5), 300), ((3, 9, 7), 50)])
def test_cos_tail_kernels_match_plain(rng, cuda, shape, c):
    """K5 and K6 vs their plain versions with ignore labels, a zeroed
    embedding row, zero-norm pixels and an all-ignore sample; at odd H*W
    with odd C (353x375 at C=21 and C=5: a sample's base off 16-byte
    alignment, the tensor's end a plain-load tail) and with fewer pixels
    than one tile. Launch counts one a call, two calls bit-equal."""
    b, h, w = shape
    n = 21
    score = rng.randn(b, h, w, c).astype(np.float32)
    score[:, :2, :3] = 0.0
    label = rng.randint(-1, n, (b, h, w)).astype(np.int32)
    if b > 1:
        label[-1] = -1  # an all-ignore sample
    temb = rng.randn(n, c).astype(np.float32)
    iemb = rng.randn(n, c).astype(np.float32)
    temb[0] = 0.0
    iemb[3] = 0.0
    _cos_tail_case(cuda, score, label, temb, iemb, n)


@pytest.mark.parametrize("c,n", [(50, 21), (300, 33), (2, 33), (21, 21),
                                 (33, 33), (59, 59), (100, 21), (200, 33),
                                 (5, 21), (10, 21), (20, 33)])
def test_cos_tail_kernel_limits(rng, cuda, c, n):
    """K5 and K6 at every bundled width: the word2vec tables (2 to 300
    dims) with pascal's K=21 and context's K=33 classes, and the one-hot
    tables (21, 33, 59 dims). C in {2, 5, 10, 20, 21} takes the register
    form, every other C the wide form (8 lanes a pixel pair, tiles sized
    to fit 3-4 stages beside the tables, the launch opted in past 48 KB).
    Same bars as C=20."""
    b, h, w = 2, 37, 53
    score = rng.randn(b, h, w, c).astype(np.float32)
    score[:, :2, :3] = 0.0
    label = rng.randint(-1, n, (b, h, w)).astype(np.int32)
    label[-1, :5] = -1
    temb = rng.randn(n, c).astype(np.float32)
    iemb = rng.randn(n, c).astype(np.float32)
    temb[0] = 0.0
    _cos_tail_case(cuda, score, label, temb, iemb, n)


@pytest.mark.parametrize("c,n", [(20, 21), (300, 33)])
def test_cos_tail_coherent_labels(rng, cuda, c, n):
    """Spatially coherent labels, constant over 32x32 patches, with scores
    the target row plus noise, so that the predictions cohere too: a warp's
    histogram counts fall in one bin. Same bars, bit-equal repeats."""
    b, h, w = 2, 96, 80
    patch = rng.randint(-1, n, (b, h // 32 + 1, w // 32 + 1))
    label = np.repeat(np.repeat(patch, 32, 1), 32, 2)[:, :h, :w]
    label = label.astype(np.int32)
    temb = rng.randn(n, c).astype(np.float32)
    temb /= np.linalg.norm(temb, axis=1, keepdims=True)
    score = (temb[np.clip(label, 0, None)]
             + 0.3 * rng.randn(b, h, w, c)).astype(np.float32)
    _cos_tail_case(cuda, score, label, temb, temb.copy(), n)


def test_szn_kernel_limits(cuda):
    """The SZN-labels kernel sizes its shared memory itself ((K+1) x w32
    fp32 rows, two buffers where they fit): a row past the card's
    per-block limit is refused at launch and the wrapper raises."""
    aug = torch.zeros(1, 2, 1000, 60, device=cuda)
    parts = tsz._partition(np.ones(59, bool), np.zeros(59, bool))
    with pytest.raises(RuntimeError, match="CUDA error"):
        tsz.szn_labels(aug, *parts, 64, 64)
    # past 48 KB it opts in: (K+1) x w32 = 60 x 300 fp32 is 72 KB a row
    aug = torch.randn(1, 2, 300, 60, device=cuda)
    got = tsz.szn_labels(aug, *parts, 40, 9000)
    want = tsz.szn_labels_plain(aug, *parts, 40, 9000)
    assert (got != want).float().mean().item() < 1e-4


def _tie_heavy_aug(rng, k, cuda):
    """(2, 4, 5, K+1) on a 1/8 grid (every upsampled value exact in fp32):
    duplicated classes, an all-zero class, exact-zero gates."""
    aug = rng.randint(-4, 5, (2, 4, 5, k + 1)).astype(np.float32) / 8
    aug[..., 3] = aug[..., 1]
    aug[..., k - 1] = aug[..., 0]
    aug[..., 2] = 0.0
    aug[0, 1, :, k] = 0.0
    return _t(aug, cuda)


@pytest.mark.parametrize("k", [9, 21, 33, 70])
@pytest.mark.parametrize("unseen", [[1, 5], [], "all"])
def test_szn_kernel_ties_equal_plain(rng, cuda, k, unseen):
    """K1 on tie-heavy inputs (exact ties between classes, with the 0.0
    fill and at gate 0; all classes negative; an empty partition) equals
    its plain version exactly, at the unrolled widths (K+1 = 22, 34) and
    the generic one (10; 71, two mask words); two calls bit-equal."""
    uv = np.ones(k, bool) if unseen == "all" else np.isin(np.arange(k),
                                                          unseen)
    parts = tsz._partition(~uv, uv)
    for aug in (_tie_heavy_aug(rng, k, cuda),
                -_tie_heavy_aug(rng, k, cuda).abs() - 0.125):
        before = _kernels.launch_counts["szn_fused"]
        got = tsz.szn_labels(aug, *parts, 70, 90)
        again = tsz.szn_labels(aug, *parts, 70, 90)
        assert _kernels.launch_counts["szn_fused"] == before + 2
        want = tsz.szn_labels_plain(aug, *parts, 70, 90)
        assert torch.equal(got, want)
        assert torch.equal(got, again)


@pytest.mark.parametrize("small,out", [((17, 17), (512, 512)),
                                       ((12, 16), (375, 500)),
                                       ((2, 3), (33, 70))])
def test_szn_kernel_context_width(rng, cuda, small, out):
    """K1 at the context width (K = 33, C = 300 embeddings) vs its plain
    version: flips < 1e-4; two calls bit-equal."""
    k, c = 33, 300
    score = _t(rng.randn(2, *small, c).astype(np.float32), cuda)
    sm = _t(rng.randn(*score.shape[:3], 2).astype(np.float32), cuda)
    embed = rng.randn(k, c).astype(np.float32)
    uv = unseen_mask_vector(k, [2, 9, 30])
    got = tsz.infer_labels_szn_fused(score, sm, embed, uv, out)
    again = tsz.infer_labels_szn_fused(score, sm, embed, uv, out)
    with_plain = tsz.szn_labels
    try:
        tsz.szn_labels = tsz.szn_labels_plain
        want = tsz.infer_labels_szn_fused(score, sm, embed, uv, out)
    finally:
        tsz.szn_labels = with_plain
    assert torch.equal(got, again)
    assert (got != want).float().mean().item() < 1e-4


@pytest.mark.parametrize("small,out", [((64, 64), (512, 512)),
                                       ((63, 47), (500, 375)),
                                       ((3, 5), (17, 33))])
def test_szn_kernel_x8_matches_plain(rng, cuda, small, out):
    """K1 at DeepLab-v2's x8 geometry (stride 8, kernel 16, crop 4) vs its
    plain version: flips < 1e-4, one launch a call, two calls bit-equal;
    on tie-heavy inputs equal."""
    geo = (8, 16, 4)
    score = _t(rng.randn(4, *small, 20).astype(np.float32), cuda)
    sm = _t(rng.randn(*score.shape[:3], 2).astype(np.float32), cuda)
    embed = rng.randn(21, 20).astype(np.float32)
    uv = unseen_mask_vector(21, [1, 13])
    before = _kernels.launch_counts["szn_fused"]
    got = tsz.infer_labels_szn_fused(score, sm, embed, uv, out, None, geo)
    again = tsz.infer_labels_szn_fused(score, sm, embed, uv, out, None, geo)
    assert _kernels.launch_counts["szn_fused"] == before + 2
    want = tsz.infer_labels_szn_fused(score.cpu(), sm.cpu(), embed, uv, out,
                                      None, geo)
    assert got.shape == (4, *out) and torch.equal(got, again)
    assert (got.cpu() != want).float().mean().item() < 1e-4
    parts = tsz._partition(~uv, uv)
    aug = _tie_heavy_aug(rng, 21, cuda)
    h8, w8 = aug.shape[1], aug.shape[2]
    o = ((h8 - 1) * 8 + 12, (w8 - 1) * 8 + 12)
    assert torch.equal(tsz.szn_labels(aug, *parts, *o, None, geo),
                       tsz.szn_labels_plain(aug, *parts, *o, None, geo))


def test_szn_kernel_refuses_malformed_partition(cuda):
    """The wrapper reads the partition on the host: a CUDA mask, a class in
    both partitions or a mask of another width raises before any launch."""
    aug = torch.randn(1, 2, 3, 10, device=cuda)
    seen, unseen, fill = tsz._partition(np.ones(9, bool), np.zeros(9, bool))
    before = _kernels.launch_counts["szn_fused"]
    with pytest.raises(ValueError, match="host data"):
        tsz.szn_labels(aug, torch.from_numpy(np.array(seen)).to(cuda),
                       unseen, fill, 64, 64)
    both = np.array(unseen)
    both[0] = 1
    with pytest.raises(ValueError, match="partition"):
        tsz.szn_labels(aug, seen, both, fill, 64, 64)
    with pytest.raises(ValueError, match="rows"):
        tsz.szn_labels(aug[..., :9].contiguous(), seen, unseen, fill, 64, 64)
    assert _kernels.launch_counts["szn_fused"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("trans_a", [False, True])
@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (17, 21, 33),
                                   (130, 257, 140), (1, 300, 1),
                                   (4096, 2000, 20), (300, 1000, 264)])
def test_pdot_kernel_matches_plain(rng, cuda, dtype, trans_a, m, k, n):
    """K7 vs its plain version at the JAX tests' edge shapes, a narrow
    weight-gradient shape (split K) and unaligned rows; fp32 out. fp32
    inputs: relative Frobenius norm < 1e-5 vs an fp64 product; bf16: the
    fp32 product of the rounded inputs at rtol 1e-4, atol 1e-3 of the
    output's scale."""
    a = _t(rng.randn(*((k, m) if trans_a else (m, k))).astype(np.float32),
           cuda).to(dtype)
    b = _t(rng.randn(k, n).astype(np.float32), cuda).to(dtype)
    before = _kernels.launch_counts["pdot"]
    got = tpd.pdot(a, b, out_dtype=torch.float32, trans_a=trans_a)
    assert _kernels.launch_counts["pdot"] == before + 1
    assert got.shape == (m, n) and got.dtype == torch.float32
    if dtype == torch.float32:
        a64 = a.double().t() if trans_a else a.double()
        assert _rel(got, a64 @ b.double()) < 1e-5
    else:
        want = tpd.pdot_plain(a, b, out_dtype=torch.float32, trans_a=trans_a)
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3 * scale)
        got16 = tpd.pdot(a, b, trans_a=trans_a)
        assert got16.dtype == torch.bfloat16
        torch.testing.assert_close(got16, got.to(torch.bfloat16), rtol=0,
                                   atol=0)


@pytest.mark.parametrize("m,k,n,trans_a,variant", [
    (300, 1000, 264, False, "tma"), (512, 1000, 264, True, "tma"),
    (640, 4096, 768, False, "tma"), (1000, 2000, 20, True, "narrow"),
    (4096, 700, 2, True, "narrow"), (256, 300, 16, True, "narrow"),
    (300, 1000, 264, True, "wmma"), (17, 2000, 33, False, "wmma"),
    (512, 512, 512, False, "fp32"), (1024, 2000, 1024, True, "fp32"),
    (4096, 6936, 20, True, "fp32_narrow"),
    (4096, 6936, 2, True, "fp32_narrow_scalar")])
def test_pdot_variants_match_plain_and_repeat(rng, cuda, m, k, n, trans_a,
                                              variant):
    """Each K7 variant, chosen by `pdot_plan`, vs the plain version (bf16:
    rtol 1e-4, atol 1e-3 of the output's rms; fp32: relative norm < 1e-5 vs
    fp64), its own launch count, and two calls bit-equal."""
    dtype = torch.float32 if variant.startswith("fp32") else torch.bfloat16
    a = _t(rng.randn(*((k, m) if trans_a else (m, k))).astype(np.float32),
           cuda).to(dtype)
    b = _t(rng.randn(k, n).astype(np.float32), cuda).to(dtype)
    assert tpd.plan_for(a, b, trans_a=trans_a)["variant"] == variant
    key = "pdot_" + variant
    before = _kernels.launch_counts[key]
    got = tpd.pdot(a, b, out_dtype=torch.float32, trans_a=trans_a)
    again = tpd.pdot(a, b, out_dtype=torch.float32, trans_a=trans_a)
    assert _kernels.launch_counts[key] == before + 2
    assert torch.equal(got, again)
    if dtype == torch.float32:
        a64 = a.double().t() if trans_a else a.double()
        assert _rel(got, a64 @ b.double()) < 1e-5
    else:
        want = tpd.pdot_plain(a, b, out_dtype=torch.float32, trans_a=trans_a)
        rms = (want.norm() / want.numel() ** 0.5).item()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3 * rms)


# K7's fp32 instances: (variant, M, N, K for 1 / 2 / 4 / 8 splits); one
# output tile each, so on any card with >= 8 SMs the plan splits K into
# cdiv(K, 64) chunks, one cluster of that many blocks
F32_INSTANCES = [("fp32", 120, 124, (64, 128, 256, 512)),
                 ("fp32_scalar", 121, 123, (63, 127, 255, 511)),
                 ("fp32_narrow", 248, 20, (64, 128, 256, 512)),
                 ("fp32_narrow_scalar", 250, 19, (63, 127, 255, 511))]


@pytest.mark.parametrize("trans_a", [False, True])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("variant,m,n,ks", F32_INSTANCES)
def test_pdot_fp32_instances_and_clusters(rng, cuda, variant, m, n, ks,
                                          cluster, trans_a):
    """Every fp32 instance (wide and narrow tile, 16- and 4-byte copies) at
    cluster sizes 1, 2, 4 and 8, both layouts: relative norm < 1e-5 vs an
    fp64 product, two calls bit-equal, its own launch count, and bf16 out
    the fp32 sums rounded once."""
    k = ks[[1, 2, 4, 8].index(cluster)]
    a = _t(rng.randn(*((k, m) if trans_a else (m, k))).astype(np.float32),
           cuda)
    b = _t(rng.randn(k, n).astype(np.float32), cuda)
    plan = tpd.plan_for(a, b, trans_a=trans_a)
    assert (plan["variant"], plan["splits"]) == (variant, cluster)
    key = "pdot_" + variant
    before = _kernels.launch_counts[key]
    got = tpd.pdot(a, b, trans_a=trans_a)
    again = tpd.pdot(a, b, trans_a=trans_a)
    got16 = tpd.pdot(a, b, out_dtype=torch.bfloat16, trans_a=trans_a)
    assert _kernels.launch_counts[key] == before + 3
    assert torch.equal(got, again)
    a64 = a.double().t() if trans_a else a.double()
    assert _rel(got, a64 @ b.double()) < 1e-5
    assert torch.equal(got16, got.to(torch.bfloat16))


def test_pdot_fp32_is_one_kernel(cuda):
    """One fp32 `pdot` call at 512^3 (8 K splits) is one kernel on the
    profiler (four calls, four launches of one kernel): the splits add up
    inside their cluster."""
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(512, 512, device=cuda)
    b = torch.randn(512, 512, device=cuda)
    assert tpd.plan_for(a, b)["splits"] == 8
    tpd.pdot(a, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a window can miss the kernels of its first milliseconds: a
        # ~30 ms spin kernel (left out below) takes that gap
        torch.cuda._sleep(50_000_000)
        for _ in range(4):
            tpd.pdot(a, b)
        torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages()
               if e.self_device_time_total > 0
               and "spin_kernel" not in e.key]
    # one kernel name, at most one launch a call (the profiler can miss one)
    assert len(kernels) == 1 and 2 <= kernels[0][1] <= 4, kernels
    assert "pdot_f32" in kernels[0][0], kernels


@pytest.mark.parametrize("plan", [
    {"variant": "fp32", "splits": 9, "k_chunk": 64},   # past a cluster
    {"variant": "fp32", "splits": 1, "k_chunk": 580},  # not a ring step
    {"variant": "fp32_narrow", "splits": 1, "k_chunk": 576}])  # K % 4
def test_pdot_fp32_refuses_what_it_cannot_run(cuda, monkeypatch, plan):
    """A plan the fp32 kernel cannot run raises; nothing falls back to
    another route."""
    a = torch.randn(64, 575 if plan["variant"] == "fp32_narrow" else 576,
                    device=cuda)
    b = torch.randn(a.shape[1], 16, device=cuda)
    monkeypatch.setattr(tpd, "pdot_plan", lambda *args, **kw: plan)
    before = dict(_kernels.launch_counts)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tpd.pdot(a, b)
    assert _kernels.launch_counts == before


def test_pdot_refuses_strided_operands(cuda):
    a = torch.randn(64, 32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tpd.pdot(a.t(), a)


@pytest.mark.parametrize("name", ["conv1x1", "conv7x7"])
def test_dot_free_conv_matches_default(rng, cuda, name):
    """The conv ops' gradients through K7 (dot-free) vs through cuDNN /
    cuBLAS (default), fp32 with TF32 off: relative norm < 1e-5."""
    ci, co, ks = (48, 20, 1) if name == "conv1x1" else (24, 40, 7)
    x = _t(rng.randn(2, ci, 17, 17).astype(np.float32), cuda).contiguous(
        memory_format=torch.channels_last)
    w = _t((rng.randn(co, ci, ks, ks) * 0.1).astype(np.float32), cuda)
    op = (tc1.conv1x1_mmwgrad if name == "conv1x1"
          else tc7.conv_valid_mmgrad)
    grads = []
    try:
        for mode in (False, True):
            tdp.set_dot_free(mode)
            xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
            y = op(xs, ws)
            before = _kernels.launch_counts["pdot"]
            y.backward(torch.ones_like(y) + y.detach())
            assert _kernels.launch_counts["pdot"] == before + int(mode)
            grads.append((xs.grad, ws.grad))
    finally:
        tdp.set_dot_free(None)
    for a, b in zip(*grads):
        assert _rel(b, a) < 1e-5, _rel(b, a)


# fc6's implicit-GEMM forward: (B, Cin, IH, IW) and Cout
IGEMM_SHAPES = {"serve-b16": ((16, 512, 23, 23), 4096),
                "train-b24": ((24, 512, 23, 23), 4096),
                "cli-b1": ((1, 512, 23, 23), 4096),
                "band-tp-shard": ((2, 512, 29, 13), 2048)}


@pytest.mark.parametrize("case", list(IGEMM_SHAPES))
def test_conv7x7_igemm_matches_conv2d(rng, cuda, case):
    """fc6's kernel vs the exact product of the same bf16 inputs (fp64):
    every output within one bf16 ulp of it (2^-8 |ref|) plus 2^-13 of the
    output's scale (max |ref|) for the fp32 sums on the tensor cores, which
    do not round to nearest inside an accumulation (at K = 25088 the card
    left up to about 1e-4 of a 5.5 scale); its relative error norm no
    wider than cuDNN's bf16 output's own (both round, once, fp32 sums of
    the same products: 1% covers the accumulations' differences; on the
    card 1.0002x); one launch a call, two calls bit-equal, channels_last
    NCHW out."""
    shape, cout = IGEMM_SHAPES[case]
    b, ci, ih, iw = shape
    x = _t(rng.randn(b, ih, iw, ci).astype(np.float32), cuda).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    w = _t((rng.randn(cout, ci, 7, 7) / np.sqrt(ci * 49)).astype(np.float32),
           cuda).to(torch.bfloat16)
    wp = tc7.pack_weight(w, torch.bfloat16)
    assert tc7.igemm_route(x, cout)
    before = _kernels.launch_counts["conv7x7_igemm"]
    got = tc7.conv7x7_igemm(x, wp)
    assert _kernels.launch_counts["conv7x7_igemm"] == before + 1
    again = tc7.conv7x7_igemm(x, wp)
    assert _kernels.launch_counts["conv7x7_igemm"] == before + 2
    km = wp.double().permute(0, 2, 3, 1).reshape(cout, -1)
    ref = (tc7.patches(x.double(), 7, 7) @ km.t()).view(
        b, ih - 6, iw - 6, cout).permute(0, 3, 1, 2)
    lib = torch.nn.functional.conv2d(x, w)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (b, cout, ih - 6, iw - 6)
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, again)
    err = (got.double() - ref).abs()
    bar = 2.0 ** -8 * ref.abs() + 2.0 ** -13 * ref.abs().max()
    assert bool((err <= bar).all()), (err - bar).max()
    assert _rel(got, ref) <= 1.01 * _rel(lib, ref), (_rel(got, ref),
                                                     _rel(lib, ref))


def test_conv7x7_igemm_refuses_what_it_cannot_run(cuda):
    """The wrapper raises (and counts nothing) for what the kernel does not
    take: fp32, Cout off its granule, a weight not packed; the op keeps
    F.conv2d there."""
    x = torch.zeros(1, 512, 9, 9, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(256, 512, 7, 7, device=cuda)
    before = _kernels.launch_counts["conv7x7_igemm"]
    for xs, wp in ((x.float(), tc7.pack_weight(w, torch.float32)),
                   (x, tc7.pack_weight(w[:100], torch.bfloat16)),
                   (x, w.to(torch.bfloat16))):
        assert not tc7.runs_igemm(xs, wp)
        with pytest.raises(ValueError, match="conv7x7_igemm"):
            tc7.conv7x7_igemm(xs, wp)
    assert _kernels.launch_counts["conv7x7_igemm"] == before


def test_stage1_step_with_the_igemm_forward_holds_the_bf16_bar(cuda,
                                                               monkeypatch):
    """A stage-1 step (cos loss, fused tail, Adam, dropout) of a 1/8-width
    FCN-32s (fc6 64 -> 512 channels) at B=2, 256x256: in bf16 with fc6's
    forward on the kernel (one launch) and on F.conv2d (none), each
    parameter's gradient vs the fp32 step's (TF32 off); the kernel's run
    at most 2x as far from fp32 as the F.conv2d run (the stage-1 bf16
    bar)."""
    from zeroshotsemanticsegmentation_tpu_torch.models import FCN32s
    from zeroshotsemanticsegmentation_tpu_torch.train import (
        TrainState, make_fcn_optimizer, make_fcn_train_step)
    r = np.random.RandomState(5)
    embed = r.randn(21, 20).astype(np.float32)
    embed /= np.linalg.norm(embed, axis=1, keepdims=True)
    step = make_fcn_train_step(loss_name="cos", num_classes=21,
                               embeddings=embed)
    hw = 256
    batch = {"image": _t(r.randn(2, hw, hw, 3).astype(np.float32) * 40,
                         cuda),
             "label": _t(r.randint(-1, 21, (2, hw, hw)).astype(np.int32),
                         cuda),
             "sizes": torch.full((2, 2), hw, dtype=torch.int32, device=cuda),
             "num_real": torch.tensor(2, device=cuda)}
    kernel_route = tc7.igemm_route

    def grads(dtype, route):
        monkeypatch.setattr(tc7, "igemm_route", route)
        m = FCN32s(20, dtype=dtype, channel_scale=1 / 8, device=cuda,
                   generator=torch.Generator().manual_seed(1))
        st = TrainState.create(m, make_fcn_optimizer(m, optim="adam",
                                                     lr=1e-5))
        before = _kernels.launch_counts["conv7x7_igemm"]
        step(st, batch, torch.Generator(device=cuda).manual_seed(1))
        torch.cuda.synchronize()
        return (_kernels.launch_counts["conv7x7_igemm"] - before,
                {n: p.grad.detach().float().clone()
                 for n, p in m.named_parameters() if p.grad is not None})

    n32, g32 = grads(torch.float32, kernel_route)
    nk, gk = grads(torch.bfloat16, kernel_route)
    nc, gc = grads(torch.bfloat16, lambda h, co: False)
    assert (n32, nk, nc) == (0, 1, 0)
    assert g32.keys() == gk.keys() == gc.keys()
    errs = {n: (_rel(gk[n], g32[n]), _rel(gc[n], g32[n])) for n in g32}
    misses = {n: e for n, e in errs.items() if not e[0] <= 2 * e[1]}
    assert not misses, misses


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(38, 42), (66, 34), (4, 132)])
def test_conv1_1_kernel_matches_plain(rng, cuda, dtype, hw):
    """K8 vs its plain version: fp32 max |err| <= 1e-5; bf16 (`wgmma`, its
    own order of the fp32 sums) within one bf16 ulp, 2^-7 max(|a|, |b|) +
    1e-6 elementwise, with at most 1e-3 of the elements differing, and at
    most 2x as far from an fp32 conv1_1 of the same rounded inputs (TF32
    off) as the plain version; two calls bit-equal."""
    xp = _t(rng.randn(2, *hw, 3).astype(np.float32), cuda)
    k1 = _t(rng.randn(64, 3, 3, 3).astype(np.float32) * 0.2, cuda)
    b1 = _t(rng.randn(64).astype(np.float32) * 0.1, cuda)
    before = _kernels.launch_counts["conv1_1_pairs"]
    got = tb1.conv1_1_pairs(xp, k1, b1, dtype)
    again = tb1.conv1_1_pairs(xp, k1, b1, dtype)
    assert _kernels.launch_counts["conv1_1_pairs"] == before + 2
    want = tb1.conv1_1_pairs_plain(xp, k1, b1, dtype)
    assert got.shape == want.shape == (2, hw[0] - 2, (hw[1] - 2) // 2, 128)
    assert got.dtype == dtype
    assert torch.equal(got, again)
    a, b = got.float(), want.float()
    if dtype == torch.float32:
        assert (a - b).abs().max().item() <= 1e-5
        return
    bar = 2.0 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-6
    assert bool(((a - b).abs() <= bar).all())
    assert (a != b).float().mean().item() <= 1e-3
    x = xp.to(dtype).float().permute(0, 3, 1, 2)
    ref = torch.relu(torch.nn.functional.conv2d(x, k1.to(dtype).float(), b1))
    ref = ref.permute(0, 2, 3, 1).reshape(a.shape)
    scale = ref.abs().max()
    err_k = ((a - ref).abs().max() / scale).item()
    err_p = ((b - ref).abs().max() / scale).item()
    assert err_k <= 2 * err_p, (err_k, err_p)


def test_conv1_1_kernel_refuses_other_tile_plan(cuda, monkeypatch):
    """bf16 K8 runs only the tile plan it was built for: the wrapper passes
    `c11_tile_plan`'s tile and shared memory, and the kernel refuses any
    other (the wrapper raises)."""
    plan = tb1.c11_tile_plan(2, 38, 42)
    monkeypatch.setattr(tb1, "c11_tile_plan",
                        lambda *a: {**plan, "tile_m": 2 * plan["tile_m"]})
    with pytest.raises(RuntimeError, match="CUDA error"):
        tb1.conv1_1_pairs(torch.zeros(2, 38, 42, 3, device=cuda),
                          torch.zeros(64, 3, 3, 3, device=cuda),
                          torch.zeros(64, device=cuda), torch.bfloat16)


@pytest.mark.parametrize("change", [{"u0": 0}, {"gate": 2}, {"u0": 21}])
def test_szn_kernel_refuses_overlapping_layout(cuda, monkeypatch, change):
    """K1 takes its layout from `k1_plan` and checks only that it keeps
    the kernel in bounds: overlapping ranges, or an unrolled instance's
    range off a 4-float boundary, are refused at launch."""
    plan = tsz.k1_plan
    monkeypatch.setattr(tsz, "k1_plan", lambda *a: {**plan(*a), **change})
    uv = np.isin(np.arange(21), [1, 13])
    with pytest.raises(RuntimeError, match="CUDA error"):
        tsz.szn_labels(torch.zeros(1, 17, 17, 22, device=cuda),
                       *tsz._partition(~uv, uv), 64, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 10, 64), (1, 7, 9, 3),
                                   (2, 9, 8, 16), (1, 6, 6, 5)])
def test_pool_bwd_kernel_matches_plain_and_autograd(rng, cuda, dtype, shape):
    """K9 through `ceil_max_pool_2x2` vs its plain version and vs
    F.max_pool2d's autograd (ceil mode), exactly, with dense ties."""
    x = _t(rng.randint(0, 3, shape).astype(np.float32), cuda).to(dtype)
    xs = x.clone().requires_grad_()
    y = tpb.ceil_max_pool_2x2(xs)
    g = torch.randn_like(y)
    before = _kernels.launch_counts["pool_bwd"]
    (dx,) = torch.autograd.grad(y, xs, g)
    assert _kernels.launch_counts["pool_bwd"] == before + 1
    xl = x.permute(0, 3, 1, 2).clone().requires_grad_()
    yl = torch.nn.functional.max_pool2d(xl, 2, 2, ceil_mode=True)
    (dl,) = torch.autograd.grad(yl, xl, g.permute(0, 3, 1, 2))
    assert torch.equal(y.detach(), yl.detach().permute(0, 2, 3, 1))
    assert torch.equal(dx, dl.permute(0, 2, 3, 1))
    if shape[1] % 2 == 0 and shape[2] % 2 == 0:
        assert torch.equal(tpb.pool_bwd(x, y.detach(), g),
                           tpb.pool_bwd_plain(x, y.detach(), g))


@pytest.mark.parametrize("shape", [(2, 8, 16, 21), (3, 5, 7, 1),
                                   (1, 3, 5, 300), (1, 1, 33, 32)])
def test_rowdot_kernel_matches_plain(rng, cuda, shape):
    """K10b vs its plain version: the same ordered fp32 sum, bit for bit
    (the phase-18 bar is rtol 1e-6, atol 1e-6); also from a storage
    offset that is not 16-byte aligned (one float per thread)."""
    a = _t(rng.randn(*shape).astype(np.float32), cuda)
    b = _t(rng.randn(*shape).astype(np.float32), cuda)
    before = _kernels.launch_counts["rowdot"]
    got = trd.rowdot(a, b)
    assert _kernels.launch_counts["rowdot"] == before + 1
    assert torch.equal(got, trd.rowdot_plain(a, b))
    flat = torch.cat([torch.zeros(1, device=cuda), a.flatten()])
    a1 = flat[1:].view(shape)
    assert a1.data_ptr() % 16 != 0
    assert torch.equal(trd.rowdot(a1, b), got)


# ---- the ring pads (csrc/ring_pad.cu) --------------------------------------

# (top, bottom, left, right): the ring pad, its band-edge forms and the
# alignment pads of `models.pruned.run_pruned_blocks`
RING_PADS = [(2, 2, 2, 2), (2, 0, 2, 2), (0, 2, 2, 2), (1, 0, 1, 0),
             (0, 1, 0, 1), (0, 0, 0, 1)]


def _ring_input(cuda, dtype, ch, layout, h=13, w=17):
    """(2, ch, h, w) NCHW in the layout named: channels_last, NCHW (the
    kernel reads its channels_last copy), a column slice of an NHWC tensor
    (read in place, rows strided), or channels_last from a storage offset
    that is not 16-byte aligned (one element a thread)."""
    g = torch.Generator(device=cuda).manual_seed(ch)
    nhwc = torch.randn(2, h, w + 1, ch, device=cuda, generator=g).to(dtype)
    if layout == "nhwc":
        return nhwc[:, :, :w].contiguous().permute(0, 3, 1, 2)
    if layout == "nchw":
        return nhwc[:, :, :w].permute(0, 3, 1, 2).contiguous()
    if layout == "column_slice":
        return nhwc[:, :, :w].permute(0, 3, 1, 2)
    flat = torch.cat([torch.zeros(1, device=cuda, dtype=dtype),
                      nhwc[:, :, :w].flatten()])
    a = flat[1:].view(2, h, w, ch).permute(0, 3, 1, 2)
    assert a.data_ptr() % 16 != 0
    return a


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ch", [8, 64, 512, 3])
@pytest.mark.parametrize("layout", ["nhwc", "nchw", "column_slice",
                                    "unaligned"])
def test_ring_pad_kernel_equals_plain(cuda, dtype, ch, layout):
    """`ring_pad` vs its plain version (the two concatenations and the
    channels_last copy), bit for bit, at odd h and w, for every pad form;
    one launch a call, channels_last out."""
    a = _ring_input(cuda, dtype, ch, layout)
    c = torch.randn(ch, device=cuda).to(dtype)
    for pads in RING_PADS:
        before = _kernels.launch_counts["ring_pad"]
        got = rp.ring_pad(a, c, *pads)
        assert _kernels.launch_counts["ring_pad"] == before + 1
        want = rp.ring_pad_plain(a, c, *pads)
        torch.cuda.synchronize()
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.equal(got, want), pads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["channels_last", "nchw", "expanded"])
def test_ring_sum_kernel_matches_the_sum_over_the_ring(cuda, dtype, layout):
    """`ring_sum` vs the fp64 sum over the ring (a mask): fp32 within
    1e-5 of the sum of magnitudes (another order of fp32 additions), bf16
    within one bf16 ulp of the fp32 sum plus that; two calls bit-equal (a
    fixed order); one launch a call; an expanded (stride 0) gradient too."""
    g = torch.randn(3, 64, 20, 23, device=cuda).to(dtype)
    if layout == "channels_last":
        g = g.contiguous(memory_format=torch.channels_last)
    elif layout == "expanded":
        g = g[:, :, :1, :1].expand(3, 64, 20, 23)
    for pads in RING_PADS:
        top, bottom, left, right = pads
        mask = torch.ones(20, 23, dtype=torch.bool, device=cuda)
        mask[top:20 - bottom, left:23 - right] = False
        want = (g.double() * mask).sum(dim=(0, 2, 3))
        scale = (g.double().abs() * mask).sum(dim=(0, 2, 3))
        before = _kernels.launch_counts["ring_sum"]
        got = rp.ring_sum(g, *pads)
        again = rp.ring_sum(g, *pads)
        assert _kernels.launch_counts["ring_sum"] == before + 2
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (64,)
        assert torch.equal(got, again)
        bar = 1e-5 * scale + (2.0 ** -8 * want.abs()
                              if dtype == torch.bfloat16 else 0)
        assert bool(((got.double() - want).abs() <= bar).all()), pads


def test_ring_pad_refuses_what_it_cannot_run(cuda):
    """Every CUDA tensor takes the kernel's route; the kernel refuses a
    dtype other than bf16 and fp32 (so does `_padc` on the card), a
    constant on another device and a CPU input, before any launch."""
    from zeroshotsemanticsegmentation_tpu_torch.models import pruned
    a = torch.zeros(1, 8, 4, 4, device=cuda, dtype=torch.float16)
    before = dict(_kernels.launch_counts)
    assert rp.kernel_takes(a) and rp.kernel_takes(a.float())
    assert not rp.kernel_takes(a.float().cpu())
    with pytest.raises(ValueError, match="ring_pad"):
        rp.ring_pad(a, torch.zeros(8, device=cuda), 1, 1, 1, 1)
    with pytest.raises(ValueError, match="ring_pad"):
        rp.ring_pad(a.float(), torch.zeros(8), 1, 1, 1, 1)
    with pytest.raises(ValueError, match="ring_pad"):
        pruned._padc(a, torch.ones(8, device=cuda), 1, 1, 1, 1)
    with pytest.raises(ValueError, match="ring_sum"):
        rp.ring_sum(torch.zeros(1, 8, 6, 6, device=cuda,
                                dtype=torch.float16), 1, 1, 1, 1)
    assert _kernels.launch_counts == before


def test_fcn32s_ring_pads_launch_the_kernels(cuda, monkeypatch):
    """A 1/8-width bf16 FCN-32s at B=2, 96x96: one `ring_pad` launch a
    `_padc` call (a `model.ringpad` span with `kernel` 1) in the forward;
    in a forward and backward, one `ring_sum` a pad (every ring constant
    is differentiated to the weights); the fp32 gradients equal the plain
    route's to 1e-5 (the constants' sums in another order; TF32 off)."""
    from zeroshotsemanticsegmentation_tpu_torch.models import FCN32s
    from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import (
        clear_spans, force_tracing, spans)
    x = torch.randn(2, 96, 96, 3, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    x = x * 40

    def model(dtype):
        return FCN32s(20, dtype=dtype, channel_scale=1 / 8, dropout_rate=0.0,
                      device=cuda, generator=torch.Generator().manual_seed(1))

    m = model(torch.bfloat16)
    clear_spans()
    _kernels.reset_launch_counts()
    with force_tracing(), torch.no_grad():
        m(x, mode="raw")
    pads = [r for r in spans(0, 2 ** 63 - 1) if r.name == "model.ringpad"]
    assert len(pads) >= 8
    assert all(r.work["kernel"] == 1 for r in pads)
    assert _kernels.launch_counts["ring_pad"] == len(pads)
    assert _kernels.launch_counts["ring_sum"] == 0

    def grads(route):
        monkeypatch.setattr(rp, "kernel_takes", route)
        mm = model(torch.float32)
        _kernels.reset_launch_counts()
        f, s = mm(x, mode="raw")
        (f.square().sum() + s.sum()).backward()
        torch.cuda.synchronize()
        return (dict(_kernels.launch_counts),
                {n: p.grad for n, p in mm.named_parameters()
                 if p.grad is not None})

    kernel_takes = rp.kernel_takes
    nk, gk = grads(kernel_takes)
    npl, gp = grads(lambda a: False)
    assert nk["ring_pad"] == nk["ring_sum"] == len(pads)
    assert npl["ring_pad"] == npl["ring_sum"] == 0
    assert gk.keys() == gp.keys() and "conv2_1.weight" in gk
    for n in gk:
        assert _rel(gk[n], gp[n]) < 1e-5, (n, _rel(gk[n], gp[n]))


# ---- the mesh layer (parallel/) on the card --------------------------------

def _mesh_setup(cuda):
    """tests/test_torch_parallel.py's inputs (1/16 width, 64x64, B=4),
    with port-initialised weights."""
    import torch_mesh_ranks as ranks
    from zeroshotsemanticsegmentation_tpu_torch.models import FCN32s
    _kernels.build(("szn_fused", "costail_fused"))  # before ranks spawn
    rng = np.random.RandomState(1337)
    batch = ranks.np_batch(rng, 4)
    embed = rng.randn(8, 8).astype(np.float32)
    embed /= np.linalg.norm(embed, axis=1, keepdims=True)
    sd = FCN32s(8, channel_scale=ranks.SCALE, device=cuda,
                generator=torch.Generator().manual_seed(0)).state_dict()
    return ranks, batch, embed, sd


def test_world1_nccl_mesh_step_equals_bare(cuda):
    """`make_mesh(1, 1)` on a one-rank NCCL group: every collective of the
    mesh path is called, and two Adam steps with dropout equal the bare
    steps bit for bit (cuDNN deterministic)."""
    import socket
    import torch.distributed as dist
    from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
        init_distributed, make_mesh)
    ranks, batch, embed, sd = _mesh_setup(cuda)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    init_distributed("nccl", f"tcp://localhost:{port}", 0, 1, timeout=60)
    torch.backends.cudnn.deterministic = True
    try:
        mesh = make_mesh(1, 1)
        kw = dict(fused_tail=True, dropout=0.5, device=cuda)
        bare = ranks.train_job(None, sd, batch, embed, **kw)
        got = ranks.train_job(mesh, sd, batch, embed, **kw)
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()
    for k, v in bare["params"].items():
        assert torch.equal(got["params"][k], v), k


@pytest.mark.parametrize("sizes", [(2, 1), (1, 2), (2, 1, 1)],
                         ids=["dp2", "tp2", "slice2"])
def test_two_ranks_gloo_on_one_card(cuda, sizes):
    """Two ranks sharing the card over gloo: the stage-1 step's gradients
    (dropout on) and the predictor's labels vs one device."""
    from zeroshotsemanticsegmentation_tpu_torch.parallel import dryrun
    ranks, batch, embed, sd = _mesh_setup(cuda)
    _hold_mesh_ranks(cuda, sizes, ["cuda:0"] * 2, "gloo")


def test_nccl_mesh_across_cards(cuda):
    """One rank a card over NCCL, on every card present (two or more):
    DP, and DP x TP where the world is even and >= 4, vs one device; with
    four cards or more also height-sharded serving over data=4 (the
    height halos over NCCL)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    sizes = (n // 2, 2) if n >= 4 and n % 2 == 0 else (n, 1)
    _hold_mesh_ranks(cuda, sizes, [f"cuda:{r}" for r in range(n)], "nccl")
    if n >= 4:
        _hold_spatial_ranks(cuda, [f"cuda:{r}" for r in range(4)], "nccl")


def test_spatial_two_ranks_gloo_on_one_card(cuda):
    """Height-sharded serving, data=2, two ranks sharing the card over
    gloo, vs one device."""
    _hold_spatial_ranks(cuda, ["cuda:0"] * 2, "gloo")


# a height whose bands carry through fc6 on four ranks (pool5 25 rows)
SPATIAL_IMAGE = (1, 768, 64)


def _hold_spatial_ranks(cuda, devices, backend):
    """Height-sharded serving (`spatial=True`, the pristine gate, and the
    int8 forward) with one band a rank of `devices` over `backend`, at 1/16
    width on a (1, 768, 64) image, vs one device: flips < 1e-4; the int8
    labels equal."""
    from zeroshotsemanticsegmentation_tpu_torch.parallel import dryrun
    ranks, batch, embed, sd = _mesh_setup(cuda)
    image = np.random.RandomState(5).randn(*SPATIAL_IMAGE, 3).astype(
        np.float32) * 40
    flags = {"spatial": {}, "int8_spatial": {"int8": True}}
    jobs = {name: ("serve", dict(unseen_classes=[1, 3], spatial=True,
                                 images=image, **kw))
            for name, kw in flags.items()}
    sd_cpu = {k: v.cpu() for k, v in sd.items()}
    out = dryrun.spawn(ranks.mesh_jobs, len(devices), (
        (len(devices), 1), devices, sd_cpu, batch, embed, jobs, backend),
        timeout_s=300)
    for name, kw in flags.items():
        want = ranks.serve_job(None, sd, batch, embed, unseen_classes=[1, 3],
                               device=cuda, images=image, **kw)
        for r in out:
            assert r[name].shape == want.shape
            assert (r[name] != want).mean() < 1e-4, name
            if kw:
                np.testing.assert_array_equal(r[name], want)


def _hold_mesh_ranks(cuda, sizes, devices, backend):
    """The stage-1 step's gradients (dropout on) and the predictor's labels
    of ranks on `devices` over `backend` vs one device: relative norm <
    1e-4 a parameter, flips < 1e-4."""
    from zeroshotsemanticsegmentation_tpu_torch.parallel import dryrun
    ranks, batch, embed, sd = _mesh_setup(cuda)
    jobs = {"train": ("train", dict(fused_tail=True, dropout=0.5, steps=1)),
            "serve": ("serve", dict(unseen_classes=[1, 3]))}
    sd_cpu = {k: v.cpu() for k, v in sd.items()}
    out = dryrun.spawn(ranks.mesh_jobs, len(devices), (
        sizes, devices, sd_cpu, batch, embed, jobs, backend), timeout_s=300)
    ref = ranks.train_job(None, sd, batch, embed, fused_tail=True,
                          dropout=0.5, steps=1, device=cuda)
    labels = ranks.serve_job(None, sd, batch, embed, unseen_classes=[1, 3],
                             device=cuda)
    for r in out:
        for k, g in ref["grads"].items():
            d = (r["train"]["grads"][k].double() - g.double()).norm()
            assert d / g.double().norm().clamp(min=1e-30) < 1e-4, k
        assert (r["serve"] != labels).mean() < 1e-4


def test_pinned_native_batch_outlives_its_copy(cuda, tmp_path):
    """The native decoder writes a batch into pinned tensors of the caching
    host allocator and `put_batch` copies from those tensors: freed while
    the copy waits behind other work on its stream, their memory is not
    handed out again until the copy is done (the allocator's event)."""
    import importlib.util
    import os.path as osp
    import shutil

    from zeroshotsemanticsegmentation_tpu_torch.data import (
        BatchLoader, PascalVOC)
    from zeroshotsemanticsegmentation_tpu_torch.train import trainer_fcn
    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "fx", osp.join(root, "scripts", "torch_make_decode_fixtures.py"))
    fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx)
    voc = tmp_path / "pascal" / "VOCdevkit" / "VOC2012"
    (voc / "JPEGImages").mkdir(parents=True)
    (voc / "SegmentationClass").mkdir()
    (tmp_path / "assets" / "pascal").mkdir(parents=True)
    ids = []
    for i, name in enumerate(sorted(fx.SPECS)):
        h, w = fx.SPECS[name][:2]
        shutil.copy(osp.join(fx.FIXTURE_DIR, f"{name}.jpg"),
                    voc / "JPEGImages" / f"{name}.jpg")
        fx.write_png(str(voc / "SegmentationClass" / f"{name}.png"),
                     fx.label_array(i, h, w), seed=i)
        ids.append(name)
    (tmp_path / "assets" / "pascal" / "val.txt").write_text(
        "\n".join(ids) + "\n")
    ds = PascalVOC("val", data_dir=str(tmp_path),
                   assets_dir=str(tmp_path / "assets"))
    loader = BatchLoader(ds, 2, compact=True, pin_memory=True)
    assert loader.decoder == "native"
    stream = torch.cuda.Stream()
    for batch in loader:
        assert all(t.is_pinned() for t in batch["pinned"].values())
        want = {k: batch[k].copy() for k in ("image", "label", "sizes")}
        with torch.cuda.stream(stream):
            torch.cuda._sleep(200_000_000)  # the copies wait behind this
        dbatch, event = trainer_fcn.put_batch(batch, cuda, stream)
        del batch
        # freed host blocks come back only after the copies' events
        other = [torch.full(v.shape, 77, dtype=torch.from_numpy(v).dtype,
                            pin_memory=True) for v in want.values()]
        event.synchronize()
        for k, v in want.items():
            assert np.array_equal(dbatch[k].cpu().numpy(), v), k
        del other
