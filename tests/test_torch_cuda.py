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


def test_block1_kernel_refuses_grad(cuda):
    xp = torch.zeros(1, 30, 30, 3, device=cuda)
    k1 = torch.zeros(64, 3, 3, 3, device=cuda, requires_grad=True)
    rest = (torch.zeros(64, device=cuda), torch.zeros(64, 64, 3, 3,
                                                      device=cuda),
            torch.zeros(64, device=cuda))
    with pytest.raises(RuntimeError, match="no backward"):
        tb1.block1_op(xp, k1, *rest, torch.float32)
