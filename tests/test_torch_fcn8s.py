"""The port's FCN-8s vs the JAX package's, on the CPU: the forward in every
mode (pruned and unpruned, block 1 fused and not, non-zero skip heads), the
zero init and the refusal of mode="raw", the weight bridge, the stage-1 step's
gradients (the fused-tail branch: the port's plain tail, the JAX Pallas tail
in interpret mode), the stage-2 step without `seenmask_upscore`, the unfused
eval steps, the trainer's eval route and its refusal of `chunked_loss`.

Same weights on both sides through `models/jax_weights`, dropout off, fp32.
Bars: the forward rtol 1e-5, atol 1e-5; gradients per parameter at relative
norm < 1e-4; losses rtol 1e-5; histogram rows exact and flips <=
max(16, 0.5%) (fp32 argmax near-ties), as tests/test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zeroshotsemanticsegmentation_tpu.models import FCN8s as JFCN8s
from zeroshotsemanticsegmentation_tpu.train import (
    make_seenmask_optimizer as j_sm_opt)
from zeroshotsemanticsegmentation_tpu.train import steps as j_steps
from zeroshotsemanticsegmentation_tpu.train.state import (
    TrainState as JTrainState)
from zeroshotsemanticsegmentation_tpu_torch import configs
from zeroshotsemanticsegmentation_tpu_torch.models import FCN8s, FCN32s
from zeroshotsemanticsegmentation_tpu_torch.models.jax_weights import (
    load_jax_params, state_dict_from_jax_params)
from zeroshotsemanticsegmentation_tpu_torch.train import (
    FCNTrainer, TrainState, make_fcn_eval_step, make_fcn_optimizer,
    make_fcn_train_step, make_seenmask_optimizer, make_seenmask_train_step,
    make_szn_eval_step)
from zeroshotsemanticsegmentation_tpu_torch.train import trainer_fcn

torch.set_num_threads(1)

C, N, HW, SCALE = 4, 21, 64, 1 / 32
TRAIN_UNSEEN = np.isin(np.arange(N), [1, 13])
VAL_UNSEEN = np.isin(np.arange(N), [1, 6, 13, 14])


def _jax_tree(rng, num_classes, hw, scale, **kw):
    """A JAX FCN8s and its params with non-zero biases and skip heads."""
    jm = JFCN8s(num_classes=num_classes, channel_scale=scale,
                dropout_rate=0.0, **kw)
    params = jax.jit(lambda k, x: jm.init(k, x, mode="both"))(
        jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)))["params"]
    tree = jax.tree.map(np.asarray, params)
    for name, leaves in tree.items():
        leaves["bias"] = rng.randn(*leaves["bias"].shape).astype(
            np.float32) * 0.05
        if name.startswith("score_pool"):
            leaves["kernel"] = rng.randn(*leaves["kernel"].shape).astype(
                np.float32) * 0.1
    return jm, tree


def _port(tree, num_classes=C, scale=SCALE, **kw):
    return load_jax_params(FCN8s(num_classes, channel_scale=scale,
                                 dropout_rate=0.0, device="cpu", **kw), tree)


@pytest.mark.parametrize("hw", [(97, 113), (64, 70)])
@pytest.mark.parametrize("prune", [True, False], ids=["pruned", "unpruned"])
def test_fcn8s_forward_matches_jax(rng, hw, prune):
    """Modes fcn / seenmask / both at the JAX test's 97x113 and at 64x70
    (3 pruned blocks at both), with block 1 fused (its plain version on the
    CPU) and not, vs the JAX FCN8s."""
    jm, tree = _jax_tree(rng, 8, hw, 1 / 16, prune_pad=prune)
    x = rng.randn(2, *hw, 3).astype(np.float32) * 40
    for fused in (False, True):
        port = _port(tree, 8, 1 / 16, prune_pad=prune,
                     fused_block1=fused).eval()
        for mode in ("fcn", "seenmask", "both"):
            want = jm.apply({"params": tree}, jnp.asarray(x), mode=mode)
            with torch.no_grad():
                got = port(torch.from_numpy(x), mode=mode)
            if mode != "both":
                got, want = (got,), (want,)
            for g, w in zip(got, want):
                assert g.dtype == torch.float32
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=f"{mode} fused={fused}")


def test_fcn8s_zero_init_and_raw_refusal():
    """Fresh skip heads are zero (weights and biases) and the trunk draws
    FCN-32s's weights from the same generator; there is no raw mode and no
    seenmask_upscore, in either package."""
    m8 = FCN8s(C, channel_scale=SCALE, device="cpu",
               generator=torch.Generator().manual_seed(3))
    m32 = FCN32s(C, channel_scale=SCALE, device="cpu",
                 generator=torch.Generator().manual_seed(3))
    sd8, sd32 = m8.state_dict(), m32.state_dict()
    for name in ("score_pool3", "score_pool4"):
        assert not sd8[f"{name}.weight"].any()
        assert not sd8[f"{name}.bias"].any()
    assert sd8["score_pool3.weight"].shape == (C, m8.width(256), 1, 1)
    assert sd8["score_pool4.weight"].shape == (C, m8.width(512), 1, 1)
    for k, v in sd32.items():
        if k != "seenmask_upscore.weight":
            assert torch.equal(sd8[k], v), k
    assert "seenmask_upscore.weight" not in sd8
    assert FCN8s.RAW_HEADS is False and FCN32s.RAW_HEADS is True
    x = torch.zeros(1, HW, HW, 3)
    with pytest.raises(ValueError, match="raw"):
        m8(x, mode="raw")
    jm = JFCN8s(num_classes=C, channel_scale=SCALE)
    with pytest.raises(ValueError, match="raw"):
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)), mode="raw")


def test_weight_bridge_carries_the_skip_heads(rng):
    _, tree = _jax_tree(rng, C, (HW, HW), SCALE)
    sd = state_dict_from_jax_params(tree)
    assert set(sd) == set(_port(tree).state_dict())
    for name in ("score_pool3", "score_pool4"):
        np.testing.assert_array_equal(
            sd[f"{name}.weight"].numpy(),
            tree[name]["kernel"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd[f"{name}.bias"].numpy(),
                                      tree[name]["bias"])
    model = _port(tree)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(11)
    jm, tree = _jax_tree(rng, C, (HW, HW), SCALE)
    embed = rng.randn(N, C).astype(np.float32)
    sizes = np.array([[50, 60], [HW, 40]], np.int32)
    batches = []
    for _ in range(2):
        raw = rng.randint(0, 256, (2, HW, HW, 3)).astype(np.uint8)
        lbl = rng.randint(-1, N, (2, HW, HW)).astype(np.int8)
        for i, (h, w) in enumerate(sizes):
            raw[i, h:], raw[i, :, w:] = 0, 0
            lbl[i, h:], lbl[i, :, w:] = -1, -1
        batches.append({"image": raw, "label": lbl, "sizes": sizes,
                        "num_real": np.int32(2)})
    return jm, tree, embed, batches


def _grab_grads():
    """An optax transformation that leaves the parameters as they are and
    keeps the step's gradients in its state."""
    return optax.GradientTransformation(
        lambda params: {"g": jax.tree.map(jnp.zeros_like, params)},
        lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g),
                                       {"g": g}))


def _hold_hist(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got.sum(axis=-1), want.sum(axis=-1))
    assert np.abs(got - want).sum() <= max(16, 0.005 * want.sum())


def test_fcn8s_stage1_step_gradients_match_jax(setup):
    """One stage-1 step through the fused-tail branch (cos loss): every
    gradient vs the JAX step's, the skip heads' among them."""
    jm, tree, embed, batches = setup
    params = jax.tree.map(jnp.asarray, tree)
    tx = _grab_grads()
    jstate = JTrainState(params=params, opt_state=tx.init(params),
                         step=jnp.zeros((), jnp.int32))
    jstate, want = j_steps.make_fcn_train_step(
        jm, tx, loss_name="cos", num_classes=N, embeddings=embed,
        fused_tail=True)(jstate, jax.tree.map(jnp.asarray, batches[0]),
                         jax.random.PRNGKey(1))
    jgrads = state_dict_from_jax_params(
        jax.tree.map(np.asarray, jstate.opt_state["g"]))

    model = _port(tree)
    state = TrainState.create(model, make_fcn_optimizer(model, optim="adam",
                                                        lr=1e-5))
    _, got = make_fcn_train_step(loss_name="cos", num_classes=N,
                                 embeddings=embed)(state, batches[0])
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-5, atol=1e-7)
    _hold_hist(got["hist"].numpy(), want["hist"])
    trained = {n for n, p in model.named_parameters() if p.grad is not None}
    assert {"score_pool3.weight", "score_pool4.bias",
            "conv1_1.weight"} <= trained
    assert not {"seenmask_score.weight", "seenmask_score.bias"} & trained
    for name, p in model.named_parameters():
        want_g = jgrads[name]
        if p.grad is None:  # no path to the loss: zero on the JAX side
            assert not want_g.any(), name
            continue
        rel = ((p.grad - want_g).norm() / want_g.norm().clamp(
            min=1e-30)).item()
        assert rel < 1e-4, (name, rel)


def test_fcn8s_stage2_steps_match_jax(setup):
    """Stage 2 on FCN-8s: only `seenmask_score` is trained (there is no
    `seenmask_upscore`), two steps vs the JAX steps."""
    jm, tree, _, batches = setup
    seen = ~TRAIN_UNSEEN
    params = jax.tree.map(jnp.asarray, tree)
    tx = j_sm_opt(params, lr=1e-3)
    jstate = JTrainState(params=params, opt_state=tx.init(params),
                         step=jnp.zeros((), jnp.int32))
    jstep = j_steps.make_seenmask_train_step(jm, tx, seen_vec=seen)
    model = _port(tree)
    opt = make_seenmask_optimizer(model, lr=1e-3)
    assert [p.shape for g in opt.param_groups for p in g["params"]] == [
        model.seenmask_score.weight.shape, model.seenmask_score.bias.shape]
    state = TrainState.create(model, opt)
    step = make_seenmask_train_step(seen_vec=seen)
    for batch in batches:
        jstate, want = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                             jax.random.PRNGKey(1))
        state, got = step(state, batch)
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                                   rtol=1e-5, atol=1e-7)
        _hold_hist(got["hist"].numpy(), want["hist"])
    want_sd = state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                      jstate.params))
    before = state_dict_from_jax_params(tree)
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want_sd[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        moved = not torch.equal(value, before[name])
        assert moved == name.startswith("seenmask_score"), name


@pytest.mark.parametrize("kind", ["fcn", "szn"])
def test_fcn8s_unfused_eval_steps_match_jax(setup, kind):
    jm, tree, embed, batches = setup
    kw = dict(loss_name="cos", num_classes=N, embeddings=embed,
              val_unseen_vec=VAL_UNSEEN)
    if kind == "szn":
        kw["all_unseen_vec"] = TRAIN_UNSEEN
    j_make = (j_steps.make_fcn_eval_step if kind == "fcn"
              else j_steps.make_szn_eval_step)
    make = make_fcn_eval_step if kind == "fcn" else make_szn_eval_step
    want = j_make(jm, **kw)(jax.tree.map(jnp.asarray, tree),
                            jax.tree.map(jnp.asarray, batches[0]))
    got = make(**kw)(_port(tree).eval(), batches[0])
    np.testing.assert_allclose(got["loss_sum"].item(),
                               float(want["loss_sum"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["score_sum"].item(),
                               float(want["score_sum"]), rtol=1e-4)
    assert got["hists"].shape == (3, N, N)
    _hold_hist(got["hists"].numpy(), want["hists"])


def _trainer(model, **cfg_kw):
    cfg = configs.Config(
        mode="train", dataset="pascal", embed_dim=C, train_unseen=(1, 13),
        val_unseen=(6, 7), bucket=(HW, HW), compute_dtype="float32",
        channel_scale=SCALE, num_viz=0, **cfg_kw)
    embed = np.eye(N, C, dtype=np.float32)
    return FCNTrainer(
        cfg=cfg, model=model,
        optimizer=make_fcn_optimizer(model, optim="adam", lr=1e-5),
        train_loader=None, val_loader=None, logger=None, embeddings=embed,
        target_embeddings=embed, upscore_trained=False)


@pytest.mark.parametrize("arch", ["fcn8s", "fcn32s"])
def test_trainer_fused_eval_only_with_raw_heads(monkeypatch, arch):
    """fused_eval="on" takes the fused K1 route for FCN-32s; FCN-8s, whose
    raw heads do not exist, validates on the unfused route."""
    fused = {}
    for name in ("make_fcn_eval_step", "make_szn_eval_step"):
        real = getattr(trainer_fcn, name)
        monkeypatch.setattr(trainer_fcn, name, lambda real=real, name=name,
                            **kw: (fused.__setitem__(name, kw["fused"]),
                                   real(**kw))[1])
    cls = FCN8s if arch == "fcn8s" else FCN32s
    _trainer(cls(C, channel_scale=SCALE, device="cpu"), fused_eval="on")
    want = arch == "fcn32s"
    assert fused == {"make_fcn_eval_step": want, "make_szn_eval_step": want}


def test_chunked_loss_refused_for_fcn8s():
    with pytest.raises(ValueError, match="chunked_loss"):
        _trainer(FCN8s(C, channel_scale=SCALE, device="cpu"),
                 chunked_loss=True)
    _trainer(FCN32s(C, channel_scale=SCALE, device="cpu"), chunked_loss=True)
