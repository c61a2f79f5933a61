"""K7's variant rule (`ops.pdot.pdot_plan`) on the CPU: which kernel each
product of the dot-free model, of the JAX package's edge-shape tests and
of the H2D probe takes on a 132-SM H100, and the K splits and chunks
`pdot_launch` checks. The kernels run in tests/test_torch_cuda.py and
chip_smoke.py."""

import pytest
import torch

from zeroshotsemanticsegmentation_tpu_torch.ops import pdot as tpd

SMS = 132   # an H100 SXM
BF16, F32 = torch.bfloat16, torch.float32


def _plan(m, k, n, trans_a, dtype=BF16, aligned=True):
    return tpd.pdot_plan(m, k, n, trans_a=trans_a, dtype=dtype, sms=SMS,
                         aligned=aligned)


# the dot-free model's products at B=24, 512x512 (6936 = 24 * 17^2 fc6
# output pixels): (M, K, N, trans_a) -> (variant, splits)
MODEL = [((6936, 4096, 25088, False), ("tma", 1)),     # fc6 input gradient
         ((4096, 6936, 4096, True), ("tma", 1)),       # fc7 weight gradient
         ((4096, 6936, 20, True), ("narrow", 14)),     # score_fr weights
         ((4096, 6936, 2, True), ("narrow", 14))]      # seenmask_score


@pytest.mark.parametrize("shape,want", MODEL)
def test_model_products(shape, want):
    plan = _plan(*shape)
    assert (plan["variant"], plan["splits"]) == want
    if plan["variant"] == "narrow":
        assert plan["k_chunk"] == tpd.NARROW_K_CHUNK == 512
    else:
        assert plan["k_chunk"] == shape[1]


@pytest.mark.parametrize("rows,model", [(12, 2), (24, 2), (2, 2), (6, 4),
                                        (3, 8)])
def test_tp_shard_products(rows, model):
    """The dot-free model's products on a mesh: `rows` samples a rank,
    fc6 / fc7 split over `model` ranks (fc6's input gradient with K =
    4096/model, fc7's weight gradient with M = 4096/model; the heads keep
    fc7's full 4096 outputs). The TP shards keep tma, unsplit."""
    px = rows * 17 * 17
    for shape, want in [((px, 4096 // model, 25088, False), ("tma", 1)),
                        ((4096 // model, px, 4096, True), ("tma", 1)),
                        ((4096, px, 20, True),
                         ("narrow", -(-px // tpd.NARROW_K_CHUNK)))]:
        plan = _plan(*shape)
        assert (plan["variant"], plan["splits"]) == want, shape


@pytest.mark.parametrize("trans_a", [False, True])
@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (17, 21, 33),
                                   (130, 257, 140), (1, 300, 1)])
def test_edge_shapes_take_wmma(m, k, n, trans_a):
    """The JAX tests' edge shapes: rows that are not 16-byte aligned, or M
    or N below a wgmma tile, take the WMMA kernel, unsplit (K <= 512)."""
    plan = _plan(m, k, n, trans_a)
    assert plan["variant"] == "wmma" and plan["splits"] == 1


@pytest.mark.parametrize("m,k,n,trans_a,want", [
    (300, 1000, 264, False, "tma"),      # ragged M, N and K tiles
    (300, 1000, 264, True, "wmma"),      # a's rows (M = 300) unaligned
    (512, 1000, 264, True, "tma"),
    (64, 64, 64, False, "tma"),          # one tile
    (64, 64, 60, False, "wmma"),         # b's rows unaligned
    (4096, 2000, 20, True, "narrow"),
    (4096, 2000, 24, True, "narrow"),    # the widest narrow tile
    (4096, 2000, 32, True, "wmma"),      # too wide for narrow, N < 64
    (4096, 2000, 20, False, "wmma"),     # narrow is for trans_a only
    (4100, 2000, 20, True, "wmma"),      # M % 8 != 0
])
def test_variant_rule(m, k, n, trans_a, want):
    assert _plan(m, k, n, trans_a)["variant"] == want


@pytest.mark.parametrize("shape", [s for s, _ in MODEL])
def test_unaligned_bases_take_wmma(shape):
    """A base that is not 16-byte aligned rules out TMA and cp.async: the
    product takes the WMMA kernel, whatever its shape."""
    assert _plan(*shape, aligned=False)["variant"] == "wmma"


@pytest.mark.parametrize("m,k,n,dtype", [
    (17, 2000, 33, BF16), (8, 128, 128, BF16), (4096, 6936, 20, BF16),
    (6936, 4096, 25088, BF16), (512, 512, 512, F32), (1, 300, 1, F32),
    (4096, 6936, 4096, F32), (130, 257, 140, F32), (64, 100000, 64, F32)])
def test_splits_cover_k_in_fixed_chunks(m, k, n, dtype):
    """Whatever the variant, K splits into `splits` chunks of `k_chunk`
    (the last one shorter, none empty), a multiple of the kernel's K step:
    16 for fp32, 32 for wmma."""
    plan = _plan(m, k, n, False, dtype)
    s, c = plan["splits"], plan["k_chunk"]
    assert s >= 1 and (s - 1) * c < k <= s * c
    step = {"fp32": 16, "wmma": 32, "tma": 1, "narrow": 512}[plan["variant"]]
    assert c % step == 0


def test_wmma_splits_only_small_outputs_with_deep_k():
    """wmma splits K into <= 512-deep chunks only when the output has fewer
    128x128 tiles than the card has SMs and K > 512."""
    assert _plan(17, 2000, 33, False)["splits"] == 4
    assert _plan(17, 500, 33, False)["splits"] == 1
    assert _plan(2000, 2000, 1500, False, aligned=False)["splits"] == 1


def test_fp32_fills_the_card():
    """fp32 splits K when the output has fewer 64x64 tiles than SMs,
    whatever K: the probe's 512^2 product (64 tiles) runs 5 chunks of 112,
    320 blocks; a large output is not split."""
    plan = _plan(512, 512, 512, False, F32)
    assert plan == {"variant": "fp32", "splits": 5, "k_chunk": 112}
    tiles = (512 // tpd.F32_TILE) ** 2
    assert tiles < SMS <= tiles * plan["splits"]
    assert _plan(4096, 6936, 4096, True, F32)["splits"] == 1
    # each chunk at least F32_MIN_CHUNK deep
    plan = _plan(64, 100, 64, False, F32)
    assert plan["splits"] == 2 and plan["k_chunk"] >= tpd.F32_MIN_CHUNK
