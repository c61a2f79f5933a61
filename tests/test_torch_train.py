"""The port's stage-1 train step vs the JAX package's, on the CPU.

Same weights through the bridge (`models/jax_weights`), same batch, fresh
optimizer state on both sides, dropout off. The port runs its plain
versions here (the fused tail's `cos_tail_plain`); the JAX step runs its
Pallas tail in interpret mode. Bars: those of the JAX package's own
fused-vs-plain step test (tests/test_costail_fused.py:141-155).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotsemanticsegmentation_tpu.models import FCN32s as JFCN32s
from zeroshotsemanticsegmentation_tpu.train import (
    make_fcn_optimizer as j_optimizer)
from zeroshotsemanticsegmentation_tpu.train.state import (
    TrainState as JTrainState)
from zeroshotsemanticsegmentation_tpu.train.steps import (
    make_fcn_train_step as j_train_step)
from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
from zeroshotsemanticsegmentation_tpu_torch.models.jax_weights import (
    load_jax_params, state_dict_from_jax_params)
from zeroshotsemanticsegmentation_tpu_torch.train import (
    TrainState, make_fcn_optimizer, make_fcn_train_step)
from zeroshotsemanticsegmentation_tpu_torch.train.optim import (
    FROZEN_MODULES)

torch.set_num_threads(1)

C, N, HW, SCALE = 4, 21, 64, 1 / 32


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(7)
    jm = JFCN32s(num_classes=C, dtype=jnp.float32, channel_scale=SCALE,
                 dropout_rate=0.0)
    params = jax.jit(lambda k, x: jm.init(k, x, mode="both"))(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))["params"]
    tree = jax.tree.map(np.asarray, params)
    for leaves in tree.values():  # non-zero biases: every bias add counts
        if "bias" in leaves:
            leaves["bias"] = (rng.randn(*leaves["bias"].shape)
                              .astype(np.float32) * 0.05)
    embed = rng.randn(N, C).astype(np.float32)
    img = rng.randn(2, HW, HW, 3).astype(np.float32) * 10
    lbl = rng.randint(-1, N, (2, HW, HW)).astype(np.int32)
    batch = {"image": img, "label": lbl,
             "sizes": np.full((2, 2), HW, np.int32), "num_real": np.int32(2)}
    sizes = np.array([[50, 60], [HW, 40]], np.int32)
    raw = rng.randint(0, 256, (2, HW, HW, 3)).astype(np.uint8)
    lbl8 = lbl.astype(np.int8)
    for i, (h, w) in enumerate(sizes):
        raw[i, h:], raw[i, :, w:] = 0, 0
        lbl8[i, h:], lbl8[i, :, w:] = -1, -1
    compact = {"image": raw, "label": lbl8, "sizes": sizes,
               "num_real": np.int32(2)}
    return jm, tree, embed, batch, compact


def _port(tree):
    model = FCN32s(C, channel_scale=SCALE, dropout_rate=0.0, device="cpu")
    return load_jax_params(model, tree)


def _jax_step(jm, tree, batch, embed, *, optim, lr, **kw):
    params = jax.tree.map(jnp.asarray, tree)
    tx = j_optimizer(params, optim=optim, lr=lr)
    state = JTrainState(params=params, opt_state=tx.init(params),
                        step=jnp.zeros((), jnp.int32))
    step = j_train_step(jm, tx, num_classes=N, embeddings=embed, **kw)
    state, aux = step(state, jax.tree.map(jnp.asarray, batch),
                      jax.random.PRNGKey(1))
    return state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                   state.params)), aux


def _port_step(tree, batch, embed, *, optim, lr, **kw):
    model = _port(tree)
    state = TrainState.create(model, make_fcn_optimizer(model, optim=optim,
                                                        lr=lr))
    step = make_fcn_train_step(num_classes=N, embeddings=embed, **kw)
    state, aux = step(state, batch)
    assert state.step == 1
    return model, aux


def _hold_hist(got, want):
    # the NNE argmax may flip on fp32 near-ties; row sums (true labels
    # only) are exact and the flipped mass is a sliver of the batch
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got.sum(axis=1), want.sum(axis=1))
    assert np.abs(got - want).sum() <= max(16, 0.005 * want.sum())


@pytest.mark.parametrize("case", [
    dict(loss_name="cos", fused_tail=True, optim="adam", lr=1e-5),
    dict(loss_name="cos", fused_tail=False, optim="adam", lr=1e-5),
    dict(loss_name="mse", fused_tail=False, optim="adam", lr=1e-5),
    dict(loss_name="cos", fused_tail=True, optim="sgd", lr=1e-3),
    dict(loss_name="cos", fused_tail=True, optim="adam", lr=1e-5,
         compact=True),
    dict(loss_name="cos", chunked_loss=True, optim="adam", lr=1e-5),
    dict(loss_name="cos", forced_unseen=True, optim="adam", lr=1e-5,
         all_unseen_vec=np.isin(np.arange(N), [1, 13])),
], ids=["fused-adam", "plain-cos", "plain-mse", "fused-sgd", "compact",
        "chunked", "forced-unseen"])
def test_train_step_matches_jax(setup, case):
    jm, tree, embed, batch, compact = setup
    case = dict(case)
    if case.pop("compact", False):
        batch = compact
    want_sd, want = _jax_step(jm, tree, batch, embed, **case)
    model, got = _port_step(tree, batch, embed, **case)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-5, atol=1e-7)
    _hold_hist(got["hist"].numpy(), want["hist"])
    np.testing.assert_allclose(got["score_sum"].item(),
                               float(want["score_sum"]), rtol=1e-4)
    np.testing.assert_allclose(got["score_fr_grad_sum"].item(),
                               float(want["score_fr_grad_sum"]), rtol=1e-3,
                               atol=1e-9)
    before = state_dict_from_jax_params(tree)
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want_sd[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        if name.split(".")[0] in FROZEN_MODULES:
            assert torch.equal(value, before[name]), name


def test_grad_accum_equals_whole_batch(setup):
    """grad_accum=2 (two microbatches, each normalised by the whole batch)
    leaves the same gradients, metrics and parameters as one pass."""
    _, tree, embed, batch, _ = setup
    runs = [_port_step(tree, batch, embed, loss_name="cos", optim="adam",
                       lr=1e-5, grad_accum=k) for k in (1, 2)]
    (m1, a1), (m2, a2) = runs
    np.testing.assert_allclose(a2["loss"].item(), a1["loss"].item(),
                               rtol=1e-6)
    np.testing.assert_array_equal(a2["hist"].numpy(), a1["hist"].numpy())
    np.testing.assert_allclose(a2["score_sum"].item(),
                               a1["score_sum"].item(), rtol=1e-6)
    for (name, p1), p2 in zip(m1.named_parameters(), m2.parameters()):
        if p1.grad is None:
            assert p2.grad is None, name
            continue
        rel = ((p2.grad - p1.grad).norm() / p1.grad.norm().clamp(
            min=1e-30)).item()
        assert rel < 1e-5, (name, rel)
        np.testing.assert_allclose(p2.detach().numpy(), p1.detach().numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    with pytest.raises(ValueError, match="not divisible"):
        _port_step(tree, batch, embed, loss_name="cos", optim="adam",
                   lr=1e-5, grad_accum=3)


def test_frozen_heads_untouched_and_groups(setup):
    """seenmask_score and seenmask_upscore sit in no optimizer group and are
    bit-identical after an SGD step (whose weight decay would move them);
    biases take 2x lr, decay applies to the weights only."""
    _, tree, embed, batch, _ = setup
    model = _port(tree)
    opt = make_fcn_optimizer(model, optim="sgd", lr=1e-3)
    (wg, bg) = opt.param_groups
    assert bg["lr"] == 2 * wg["lr"] and bg["weight_decay"] == 0.0 \
        and wg["weight_decay"] == 5e-4
    grouped = {id(p) for g in opt.param_groups for p in g["params"]}
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.split(".")[0] in FROZEN_MODULES}
    assert len(frozen) == 3
    assert not any(id(p) in grouped for n, p in model.named_parameters()
                   if n in frozen)
    step = make_fcn_train_step(loss_name="cos", num_classes=N,
                               embeddings=embed)
    step(TrainState.create(model, opt), batch)
    for name, p in model.named_parameters():
        if name in frozen:
            assert torch.equal(p.detach(), frozen[name]), name
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_fcn_optimizer(model, optim="rmsprop", lr=1e-3)


def test_dropout_draws_from_the_generator(setup):
    """Channel dropout: whole channels per sample, from the generator
    passed in; the same seed gives the same masks, no train flag none."""
    _, tree, _, batch, _ = setup
    model = FCN32s(C, channel_scale=SCALE, dropout_rate=0.5, device="cpu")
    load_jax_params(model, tree)
    x = torch.from_numpy(batch["image"])
    with torch.no_grad():
        ref = model(x, mode="raw")[0]
        a = model(x, mode="raw", train=True,
                  generator=torch.Generator().manual_seed(3))[0]
        b = model(x, mode="raw", train=True,
                  generator=torch.Generator().manual_seed(3))[0]
        h = torch.ones(2, 64, 3, 5)
        d = model._dropout(h, True, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, ref)
    per_channel = d.amax(dim=(2, 3))
    assert torch.equal(d, per_channel[..., None, None].expand_as(d))
    assert set(per_channel.unique().tolist()) == {0.0, 2.0}
    with pytest.raises(ValueError, match="Generator"):
        model(x, mode="raw", train=True)


@pytest.mark.parametrize("hw", [(64, 64), (70, 90)])
def test_pruned_gradients_match_jax(hw):
    """Gradients of a weighted sum of both raw heads w.r.t. every parameter
    flow through the ring pads, the frame probe and the slice assignment of
    the pruned path as they do in the JAX package."""
    rng = np.random.RandomState(11)
    jm = JFCN32s(num_classes=C, dtype=jnp.float32, channel_scale=SCALE,
                 dropout_rate=0.0)
    params = jax.jit(lambda k, x: jm.init(k, x, mode="both"))(
        jax.random.PRNGKey(2), jnp.zeros((1, *hw, 3)))["params"]
    tree = jax.tree.map(np.asarray, params)
    for leaves in tree.values():
        if "bias" in leaves:
            leaves["bias"] = (rng.randn(*leaves["bias"].shape)
                              .astype(np.float32) * 0.05)
    x = rng.randn(2, *hw, 3).astype(np.float32) * 40
    f_shape, s_shape = (a.shape for a in jax.eval_shape(
        lambda p: jm.apply({"params": p}, jnp.asarray(x), mode="raw"), tree))
    wf = rng.randn(*f_shape).astype(np.float32)
    ws = rng.randn(*s_shape).astype(np.float32)

    def jloss(p):
        f, s = jm.apply({"params": p}, jnp.asarray(x), mode="raw")
        return jnp.sum(f * wf) + jnp.sum(s * ws)

    want = state_dict_from_jax_params(jax.tree.map(
        np.asarray, jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, tree))))
    model = _port(tree)
    f, s = model(torch.from_numpy(x), mode="raw")
    (torch.sum(f * torch.from_numpy(wf))
     + torch.sum(s * torch.from_numpy(ws))).backward()
    for name, p in model.named_parameters():
        w = want[name].double()
        g = torch.zeros_like(w) if p.grad is None else p.grad.double()
        rel = ((g - w).norm() / w.norm().clamp(min=1e-30)).item()
        assert rel < 1e-4 or (w.norm() == 0 and g.norm() == 0), (name, rel)


def test_step_after_serving_under_inference_mode(setup):
    """Constants cached on the device while serving (under
    torch.inference_mode) stay usable by a training step afterwards."""
    _, tree, embed, _, compact = setup
    model = _port(tree)
    with torch.inference_mode():
        model(torch.from_numpy(compact["image"]).to(torch.float32) - 100.0,
              mode="fcn")
        from zeroshotsemanticsegmentation_tpu_torch.data.transforms import (
            prepare_images)
        prepare_images(torch.from_numpy(compact["image"]))
    state = TrainState.create(model, make_fcn_optimizer(model, optim="adam",
                                                        lr=1e-5))
    step = make_fcn_train_step(loss_name="cos", num_classes=N,
                               embeddings=embed)
    _, aux = step(state, compact)
    assert torch.isfinite(aux["loss"])
