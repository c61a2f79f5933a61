"""The port's int8 serving forward (models/quantized.py) vs the JAX
package's, on the CPU.

`int8_conv` (torch._int_mm over a patch matrix) against XLA's int8
convolution with int32 accumulation: exact. `_qconv` against the JAX
`_qconv`: within one bf16 ulp. `quantized_raw_forward` against the JAX one
at rtol 2e-2 on the raw heads; the int8 predictor's labels against the JAX
int8 predictor (flip rate <= 1e-3) and against the port's fp predictor
(< 0.08, the JAX bar of tests/test_serving.py:238-250).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotsemanticsegmentation_tpu.models import FCN8s as JFCN8s
from zeroshotsemanticsegmentation_tpu.models import FCN32s as JFCN32s
from zeroshotsemanticsegmentation_tpu.models import quantized as jq
from zeroshotsemanticsegmentation_tpu.serving import (
    make_szn_predictor as j_predictor)
from zeroshotsemanticsegmentation_tpu_torch.models import FCN8s, FCN32s
from zeroshotsemanticsegmentation_tpu_torch.models import quantized as tq
from zeroshotsemanticsegmentation_tpu_torch.models.jax_weights import (
    load_jax_params, state_dict_from_jax_params)
from zeroshotsemanticsegmentation_tpu_torch.serving import make_szn_predictor

torch.set_num_threads(1)

# (batch, H, W, C in, C out, kernel, padding): a 3x3 layer, conv1_1's K = 27
# (padded to 32) with its big pad, fc6's 7x7 VALID, a 1x1 head with N = 2
# (padded to 16), and a product of M = 4 rows (padded past 16)
CONV_CASES = [(2, 9, 11, 16, 24, 3, 1), (1, 6, 7, 3, 8, 3, 5),
              (2, 9, 8, 8, 16, 7, 0), (2, 5, 6, 16, 2, 1, 0),
              (1, 2, 2, 8, 20, 1, 0)]


def _bf16_ulp_close(got, want):
    """|got - want| within one bf16 ulp of the larger magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(got), np.abs(want))
                                   + 1e-30)) - 7)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(map(
    str, c)))
def test_int8_conv_accumulators_exact(rng, case):
    b, h, w, ci, co, k, pad = case
    a = rng.randint(-127, 128, (b, h, w, ci)).astype(np.int8)
    kern = rng.randint(-127, 128, (k, k, ci, co)).astype(np.int8)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(a), jnp.asarray(kern), (1, 1), ((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    got = tq.int8_conv(torch.from_numpy(a),
                       torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()),
                       pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_conv_chunks_equal_one_pass(rng, monkeypatch):
    """Patch matrices built a few images at a time give the one-pass
    result."""
    a = torch.from_numpy(rng.randint(-127, 128, (5, 9, 10, 8)).astype(
        np.int8))
    kern = torch.from_numpy(rng.randint(-127, 128, (16, 8, 3, 3)).astype(
        np.int8))
    whole = tq.int8_conv(a, kern, 1)
    monkeypatch.setattr(tq, "PATCH_CHUNK_BYTES", 2 * 9 * 10 * 72)
    assert torch.equal(tq.int8_conv(a, kern, 1), whole)


@pytest.mark.parametrize("case", CONV_CASES[:4], ids=lambda c: "x".join(map(
    str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qconv_matches_jax(rng, case, dtype):
    b, h, w, ci, co, k, pad = case
    a = (rng.randn(b, h, w, ci) * 3).astype(np.float32)
    kern = (rng.randn(k, k, ci, co) * 0.1).astype(np.float32)
    kern[..., 0] = 0.0  # a zero output channel: its scale is set to 1
    bias = (rng.randn(co) * 0.1).astype(np.float32)
    aj = jnp.asarray(a).astype(dtype)
    for relu in (True, False):
        want = jq._qconv(aj, jnp.asarray(kern), jnp.asarray(bias),
                         padding=((pad, pad), (pad, pad)), relu=relu)
        got = tq._qconv(
            torch.from_numpy(np.array(aj.astype(jnp.float32))).to(
                getattr(torch, dtype)),
            torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(bias), padding=pad, relu=relu)
        assert got.dtype == torch.bfloat16
        _bf16_ulp_close(got.float().numpy(),
                        np.asarray(want.astype(jnp.float32)))


def _jax_init(jm, hw):
    return jax.tree.map(np.asarray, jax.jit(
        lambda k, x: jm.init(k, x, mode="both"))(
        jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)))["params"])


def _jax_fcn32s(rng, hw, num_classes=8):
    jm = JFCN32s(num_classes=num_classes, channel_scale=1 / 16)
    tree = _jax_init(jm, hw)
    for leaves in tree.values():
        if "bias" in leaves:
            leaves["bias"] = (rng.randn(*leaves["bias"].shape)
                              .astype(np.float32) * 0.05)
    return jm, tree


@pytest.mark.parametrize("hw", [(64, 64), (61, 70), (12, 14)],
                         ids=["pruned", "pruned-odd", "unpruned"])
def test_quantized_raw_forward_matches_jax(rng, hw, monkeypatch):
    """The raw heads vs the JAX int8 forward (rtol 2e-2), from a state dict
    and from the model; the support-pruned path is taken once a call where
    the geometry allows it (4 blocks deep here, below 16 pixels not at
    all). The JAX forward runs op by op, as its own tests run it, and there
    the port's heads are equal to it: the quantise arithmetic rounds at the
    same points (under `jit` XLA fuses the bf16 steps in fp32, and the
    heads differ from the op-by-op ones by more than this bar)."""
    _, tree = _jax_fcn32s(rng, hw)
    x = rng.randn(2, *hw, 3).astype(np.float32) * 40
    jf, js = jq.quantized_raw_forward(tree, jnp.asarray(x))
    calls = []
    real = tq.run_pruned_blocks
    monkeypatch.setattr(tq, "run_pruned_blocks", lambda *a, **kw: (
        calls.append(len(a[0])), real(*a, **kw))[1])
    sd = state_dict_from_jax_params(tree)
    model = load_jax_params(FCN32s(8, channel_scale=1 / 16, device="cpu"),
                            tree)
    for src in (sd, model):
        tf, ts = tq.quantized_raw_forward(src, torch.from_numpy(x))
        for g, w in ((tf, jf), (ts, js)):
            w = np.asarray(w.astype(jnp.float32))
            assert g.dtype == torch.bfloat16 and g.shape == w.shape
            np.testing.assert_allclose(g.float().numpy(), w, rtol=2e-2,
                                       atol=2e-2 * np.abs(w).max())
            np.testing.assert_array_equal(g.float().numpy(), w)
    assert calls == ([] if hw == (12, 14) else [4, 4])


def test_int8_predictor_matches_jax(rng):
    """Labels of the int8 predictor vs the JAX int8 predictor (flip rate
    <= 1e-3) and vs the port's fp predictor on the same weights (< 0.08)."""
    hw = (64, 64)
    jm, tree = _jax_fcn32s(rng, hw)
    embed = rng.randn(9, 8).astype(np.float32)
    embed /= np.linalg.norm(embed, axis=1, keepdims=True)
    unseen = [2, 5]
    imgs = rng.randn(2, *hw, 3).astype(np.float32) * 40
    want = np.asarray(j_predictor(jm, tree, embed, unseen, int8=True,
                                  upscore_trained=False)(jnp.asarray(imgs)))
    port = FCN32s(8, channel_scale=1 / 16, device="cpu")
    sd = state_dict_from_jax_params(tree)
    got = make_szn_predictor(port, sd, embed, unseen, int8=True,
                             device="cpu")(imgs).numpy()
    fp = make_szn_predictor(port, sd, embed, unseen,
                            device="cpu")(imgs).numpy()
    assert got.shape == (2, *hw) and got.dtype == np.int32
    assert (got != want).mean() <= 1e-3
    assert (got != fp).mean() < 0.08


def test_int8_refuses_fcn8s():
    embed = np.eye(9, 8, dtype=np.float32)
    jm = JFCN8s(num_classes=8, channel_scale=1 / 16)
    tree = _jax_init(jm, (32, 32))
    with pytest.raises(ValueError, match="int8"):
        j_predictor(jm, tree, embed, [2], int8=True)
    with pytest.raises(ValueError, match="int8"):
        make_szn_predictor(FCN8s(8, channel_scale=1 / 16, device="cpu"),
                           None, embed, [2], int8=True, device="cpu")
