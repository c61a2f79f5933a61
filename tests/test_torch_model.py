"""The port's FCN-32s, pruned geometry and SZN predictor vs the JAX package
(fp32 on the CPU, dropout off, same weights through the bridge)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotsemanticsegmentation_tpu.models import FCN32s as JFCN32s
from zeroshotsemanticsegmentation_tpu.models import pruned as jpruned
from zeroshotsemanticsegmentation_tpu.serving import (
    make_szn_predictor as j_predictor)
from zeroshotsemanticsegmentation_tpu_torch.models import pruned as tpruned
from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
from zeroshotsemanticsegmentation_tpu_torch.models.jax_weights import (
    load_jax_params, state_dict_from_jax_params)
from zeroshotsemanticsegmentation_tpu_torch.serving import (
    make_szn_predictor, upscore_trained_numeric)

torch.set_num_threads(1)

T = torch.from_numpy


@pytest.mark.parametrize("num_blocks", [3, 4])
def test_plan_blocks_equals_jax(num_blocks):
    """Pure-integer geometry plan, exact, for every side 16..600 (square and
    with an odd/even partner side) and the probe sides."""
    for s in range(16, 601):
        assert tpruned.probe_side(s, num_blocks) == \
            jpruned.probe_side(s, num_blocks)
        for w in (s, s + 1):
            assert tpruned.plan_blocks(s, w, 100, num_blocks) == \
                jpruned.plan_blocks(s, w, 100, num_blocks), (s, w)


def _jax_model(rng, num_classes=8, hw=(64, 64)):
    model = JFCN32s(num_classes=num_classes, channel_scale=1 / 16)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)),
                        mode="both")["params"]
    tree = jax.tree.map(np.asarray, params)
    # non-zero biases so every bias add is exercised
    for name, leaves in tree.items():
        if "bias" in leaves:
            leaves["bias"] = (rng.randn(*leaves["bias"].shape)
                              .astype(np.float32) * 0.05)
    return model, tree


def _port_model(tree, num_classes=8, **kw):
    port = FCN32s(num_classes, channel_scale=1 / 16, device="cpu", **kw)
    return load_jax_params(port, tree).eval()


@pytest.mark.parametrize("hw", [(64, 64), (61, 70)])
def test_fcn32s_heads_match_jax(rng, hw):
    """Modes raw / fcn / both vs the JAX model (fp32, dropout off); the
    port's fused-block-1 branch (its plain version on the CPU) too."""
    jm, tree = _jax_model(rng, hw=hw)
    x = rng.randn(2, *hw, 3).astype(np.float32) * 40
    jv = {"params": tree}
    port = _port_model(tree)
    fused = _port_model(tree, fused_block1=True)

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())

    with torch.no_grad():
        jf, js = jm.apply(jv, jnp.asarray(x), mode="raw")
        for m in (port, fused):
            tf, ts = m(T(x), mode="raw")
            close(tf, jf)
            close(ts, js)
        close(port(T(x), mode="fcn"), jm.apply(jv, jnp.asarray(x),
                                               mode="fcn"))
        jf, js = jm.apply(jv, jnp.asarray(x), mode="both")
        tf, ts = port(T(x), mode="both")
        close(tf, jf)
        close(ts, js)


def test_pruned_matches_unpruned(rng):
    """The support-pruned path (4 blocks at 64x70, 3 at 61x61) equals the
    plain pad-100 path of the port itself."""
    _, tree = _jax_model(rng)
    pruned = _port_model(tree)
    plain = _port_model(tree, prune_pad=False)
    fused = _port_model(tree, fused_block1=True)
    for hw in ((64, 70), (61, 61), (49, 52)):
        x = T(rng.randn(1, *hw, 3).astype(np.float32) * 40)
        with torch.no_grad():
            want = plain(x, mode="raw")[0]
            for m in (pruned, fused):
                got = m(x, mode="raw")[0]
                torch.testing.assert_close(
                    got, want, rtol=1e-4,
                    atol=1e-4 * want.abs().max().item())


def _perturbed(rng, tree):
    tree = {k: dict(v) for k, v in tree.items()}
    up = tree["seenmask_upscore"]["kernel"]
    tree["seenmask_upscore"]["kernel"] = (
        up + rng.randn(*up.shape).astype(np.float32))
    return tree


@pytest.mark.parametrize("trained", [False, True])
def test_predictor_matches_jax(rng, trained):
    """make_szn_predictor(device="cpu") vs the JAX predictor on the same
    weights: fresh parameters (fused bilinear gate) and a perturbed
    seenmask_upscore with upscore_trained=True (exact gate route)."""
    jm, tree = _jax_model(rng, num_classes=8)
    if trained:
        tree = _perturbed(rng, tree)
    embed = rng.randn(9, 8).astype(np.float32)
    embed /= np.linalg.norm(embed, axis=1, keepdims=True)
    unseen = [2, 5]
    imgs = rng.randn(2, 64, 64, 3).astype(np.float32) * 40
    want = np.asarray(j_predictor(jm, tree, embed, unseen,
                                  upscore_trained=trained)(jnp.asarray(imgs)))
    port = FCN32s(8, channel_scale=1 / 16, device="cpu")
    got = make_szn_predictor(port, state_dict_from_jax_params(tree), embed,
                             unseen, upscore_trained=trained,
                             device="cpu")(imgs).numpy()
    assert got.shape == (2, 64, 64) and got.dtype == np.int32
    assert (got != want).mean() < 1e-4
    raw = rng.randint(0, 256, (1, 64, 64, 3)).astype(np.uint8)
    want_u8 = np.asarray(j_predictor(jm, tree, embed, unseen,
                                     upscore_trained=trained)(
        jnp.asarray(raw)))
    got_u8 = make_szn_predictor(port, None, embed, unseen,
                                upscore_trained=trained,
                                device="cpu")(torch.from_numpy(raw)).numpy()
    assert (got_u8 != want_u8).mean() < 1e-4


def test_upscore_guard_matches_jax(rng):
    """The tri-state guard: explicit False on drifted values raises in both
    packages; None detects; the numeric probe agrees."""
    from zeroshotsemanticsegmentation_tpu.serving import (
        upscore_trained_numeric as j_numeric)
    jm, tree = _jax_model(rng)
    trained = _perturbed(rng, tree)
    embed = np.eye(9, 8, dtype=np.float32)
    port = FCN32s(8, channel_scale=1 / 16, device="cpu")
    for t in (tree, trained):
        assert upscore_trained_numeric(state_dict_from_jax_params(t)) == \
            j_numeric(t)
    with pytest.raises(ValueError, match="differs from its bilinear init"):
        j_predictor(jm, trained, embed, [2, 5], upscore_trained=False)
    with pytest.raises(ValueError, match="differs from its bilinear init"):
        make_szn_predictor(port, state_dict_from_jax_params(trained), embed,
                           [2, 5], upscore_trained=False, device="cpu")
    assert upscore_trained_numeric({}) is False
    with pytest.raises(ValueError, match="pass `mesh`"):
        make_szn_predictor(port, None, embed, [2, 5], spatial=True,
                           device="cpu")


def test_entry_points_need_the_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FCN32s(8, channel_scale=1 / 16)
    port = FCN32s(8, channel_scale=1 / 16, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_szn_predictor(port, None, np.eye(9, 8, dtype=np.float32), [2])
