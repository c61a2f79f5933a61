"""`remat` (rematerialized conv blocks) in the port's FCN-32s and FCN-8s,
on the CPU: the JAX modules' segmentation (the support-pruned run one
segment, each later block one more) in `torch.utils.checkpoint`.

- remat against the same model without it: forward outputs and every
  parameter's gradient bit-equal in fp32, pruned and unpruned;
- against the JAX modules with `remat=True` (weights carried across by
  `models/jax_weights`): gradients at relative norm < 1e-4, the port's
  gradient bar (tests/test_torch_train.py);
- one stage-1 Adam step with remat against the JAX step, at
  tests/test_torch_train.py's bars;
- a `saved_tensors_hooks` count: with remat the blocks hold only each
  segment's input between the forward and the backward;
- without autograd (serving, eval, the frozen trunk) and on the
  height-sharded bands remat changes nothing and checkpoints nothing; no
  segment draws from the default random generators.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotsemanticsegmentation_tpu.models import FCN8s as JFCN8s
from zeroshotsemanticsegmentation_tpu.models import FCN32s as JFCN32s
from zeroshotsemanticsegmentation_tpu.train import (
    make_fcn_optimizer as j_optimizer)
from zeroshotsemanticsegmentation_tpu.train.state import (
    TrainState as JTrainState)
from zeroshotsemanticsegmentation_tpu.train.steps import (
    make_fcn_train_step as j_train_step)
from zeroshotsemanticsegmentation_tpu_torch.models import fcn32s
from zeroshotsemanticsegmentation_tpu_torch.models import FCN8s, FCN32s
from zeroshotsemanticsegmentation_tpu_torch.models.jax_weights import (
    load_jax_params, state_dict_from_jax_params)
from zeroshotsemanticsegmentation_tpu_torch.parallel.spatial import (
    Bands, plan_bands)
from zeroshotsemanticsegmentation_tpu_torch.train import (
    TrainState, make_fcn_optimizer, make_fcn_train_step)

torch.set_num_threads(1)

C, N, SCALE = 4, 21, 1 / 16
HW = {"pruned": (64, 72), "unpruned": (40, 56)}
ARCHS = {"fcn32s": (FCN32s, JFCN32s), "fcn8s": (FCN8s, JFCN8s)}
CASES = [(a, g) for a in ARCHS for g in HW]
IDS = [f"{a}-{g}" for a, g in CASES]


def _tree(jcls, hw, seed):
    """JAX params with non-zero biases (and skip heads): every add counts."""
    rng = np.random.RandomState(seed)
    jm = jcls(num_classes=C, channel_scale=SCALE, dropout_rate=0.0)
    params = jax.jit(lambda k, x: jm.init(k, x, mode="both"))(
        jax.random.PRNGKey(seed), jnp.zeros((1, *hw, 3)))["params"]
    tree = jax.tree.map(np.asarray, params)
    for name, leaves in tree.items():
        if "bias" in leaves:
            leaves["bias"] = rng.randn(*leaves["bias"].shape).astype(
                np.float32) * 0.05
        if name.startswith("score_pool"):
            leaves["kernel"] = rng.randn(*leaves["kernel"].shape).astype(
                np.float32) * 0.1
    return tree


def _port(arch, tree, remat, geometry):
    model = ARCHS[arch][0](C, channel_scale=SCALE, dropout_rate=0.0,
                           remat=remat, prune_pad=geometry == "pruned",
                           device="cpu")
    return load_jax_params(model, tree)


def _inputs(hw, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *hw, 3).astype(np.float32) * 40
    wf = rng.randn(2, *hw, C).astype(np.float32)
    ws = rng.randn(2, *hw, 2).astype(np.float32)
    return x, wf, ws


def _port_grads(model, x, wf, ws):
    f, s = model(torch.from_numpy(x), mode="both")
    (torch.sum(f * torch.from_numpy(wf))
     + torch.sum(s * torch.from_numpy(ws))).backward()
    return (f.detach(), s.detach(),
            {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None})


@pytest.mark.parametrize("arch,geometry", CASES, ids=IDS)
def test_remat_is_bit_equal_to_the_plain_model(arch, geometry):
    hw = HW[geometry]
    tree = _tree(ARCHS[arch][1], hw, 3)
    x, wf, ws = _inputs(hw, 4)
    f0, s0, g0 = _port_grads(_port(arch, tree, False, geometry), x, wf, ws)
    f1, s1, g1 = _port_grads(_port(arch, tree, True, geometry), x, wf, ws)
    assert torch.equal(f1, f0) and torch.equal(s1, s0)
    assert g1.keys() == g0.keys() and "conv1_1.weight" in g0
    for name in g0:
        assert torch.equal(g1[name], g0[name]), name


@pytest.mark.parametrize("arch,geometry", CASES, ids=IDS)
def test_remat_gradients_match_jax_remat(arch, geometry):
    """The port's remat model against the JAX module with `remat=True`
    (its `jax.checkpoint` / `nn.remat` segments), the same weights."""
    hw = HW[geometry]
    tree = _tree(ARCHS[arch][1], hw, 5)
    x, wf, ws = _inputs(hw, 6)
    jm = ARCHS[arch][1](num_classes=C, channel_scale=SCALE, dropout_rate=0.0,
                        remat=True, prune_pad=geometry == "pruned")

    def jloss(p):
        f, s = jm.apply({"params": p}, jnp.asarray(x), mode="both")
        return jnp.sum(f * wf) + jnp.sum(s * ws)

    want = state_dict_from_jax_params(jax.tree.map(
        np.asarray, jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray,
                                                          tree))))
    model = _port(arch, tree, True, geometry)
    _, _, got = _port_grads(model, x, wf, ws)
    for name, _ in model.named_parameters():
        w = want[name].double()
        g = got[name].double() if name in got else torch.zeros_like(w)
        rel = ((g - w).norm() / w.norm().clamp(min=1e-30)).item()
        assert rel < 1e-4 or (w.norm() == 0 and g.norm() == 0), (name, rel)


def test_remat_adam_step_matches_jax():
    """One stage-1 step (cos loss, fused-tail branch, Adam) with remat on
    both sides; the bars of tests/test_torch_train.py."""
    hw = HW["pruned"]
    tree = _tree(JFCN32s, hw, 7)
    rng = np.random.RandomState(8)
    embed = rng.randn(N, C).astype(np.float32)
    batch = {"image": rng.randn(2, *hw, 3).astype(np.float32) * 10,
             "label": rng.randint(-1, N, (2, *hw)).astype(np.int32),
             "sizes": np.full((2, 2), hw, np.int32),
             "num_real": np.int32(2)}
    jm = JFCN32s(num_classes=C, channel_scale=SCALE, dropout_rate=0.0,
                 remat=True)
    params = jax.tree.map(jnp.asarray, tree)
    tx = j_optimizer(params, optim="adam", lr=1e-5)
    jstate = JTrainState(params=params, opt_state=tx.init(params),
                         step=jnp.zeros((), jnp.int32))
    jstate, want = j_train_step(jm, tx, loss_name="cos", num_classes=N,
                                embeddings=embed, fused_tail=True)(
        jstate, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(1))
    want_sd = state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                      jstate.params))
    model = _port("fcn32s", tree, True, "pruned")
    state = TrainState.create(model, make_fcn_optimizer(model, optim="adam",
                                                        lr=1e-5))
    _, got = make_fcn_train_step(loss_name="cos", num_classes=N,
                                 embeddings=embed)(state, batch)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-5, atol=1e-7)
    hist, jhist = got["hist"].numpy(), np.asarray(want["hist"])
    np.testing.assert_array_equal(hist.sum(axis=1), jhist.sum(axis=1))
    assert np.abs(hist - jhist).sum() <= max(16, 0.005 * jhist.sum())
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want_sd[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def _saved(fn) -> tuple:
    """(shapes, elements) of the tensors autograd saves while fn() runs,
    and fn()'s result."""
    seen = []

    def pack(t):
        seen.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return seen, sum(int(np.prod(s)) for s in seen), out


@pytest.mark.parametrize("geometry", list(HW))
def test_remat_holds_only_segment_inputs_until_the_backward(geometry):
    """What the blocks leave for the backward: without remat the pruned
    run's and every later block's activations; with remat each segment's
    input alone (the image for the pruned run, the pool before each later
    block), run again from there in the backward. The whole forward
    saves that much less."""
    hw = HW[geometry]
    tree = _tree(JFCN32s, hw, 9)
    x = torch.from_numpy(_inputs(hw, 10)[0])
    plain, remat = (_port("fcn32s", tree, r, geometry) for r in (False, True))
    shapes_plain, e_plain, pools = _saved(lambda: plain._blocks(x))
    shapes_remat, e_remat, _ = _saved(lambda: remat._blocks(x))
    start = 4 if geometry == "pruned" else 0  # the first block after the run
    first = tuple(x.shape) if geometry == "pruned" else \
        (x.shape[0], 3, *hw)  # the unpruned stack's NCHW image
    assert shapes_remat == [first] + [tuple(pools[bi - 1].shape)
                                      for bi in range(max(start, 1), 5)]
    assert e_remat < e_plain / 10
    whole_plain = _saved(lambda: plain(x, mode="raw"))[1]
    whole_remat = _saved(lambda: remat(x, mode="raw"))[1]
    assert whole_plain - whole_remat == e_plain - e_remat


class _OneBandMesh:
    """A 'data' axis of one rank: the mesh attributes `Bands` reads."""
    shape = {"data": 1, "model": 1}
    coords = {"data": 0, "model": 0}
    data_size = model_size = 1
    data_rank = model_rank = 0

    def all_reduce(self, t, axes=("data",), op="sum"):
        pass


def test_remat_changes_nothing_without_autograd_or_on_bands(monkeypatch):
    """Serving, eval and the frozen trunk (no autograd) and the
    height-sharded bands run no segment and give the plain model's
    values; no segment draws from the default generators, so the RNG
    state is not stashed (`preserve_rng_state=False`)."""
    hw = HW["pruned"]
    tree = _tree(JFCN32s, hw, 11)
    x, wf, ws = _inputs(hw, 12)
    x = torch.from_numpy(x)
    plain, remat = (_port("fcn32s", tree, r, "pruned") for r in (False, True))
    bands = Bands(plan_bands(*hw, 1), _OneBandMesh())
    with torch.no_grad():
        want = plain(x, mode="raw")
        want_bands = plain(x, mode="raw", bands=bands)

    def no_segment(*a, **k):
        raise AssertionError("a remat segment ran")

    with monkeypatch.context() as m:
        m.setattr(fcn32s, "checkpoint", no_segment)
        with torch.no_grad():
            got = remat(x, mode="raw")
        frozen = remat(x, mode="raw", frozen_trunk=True)
        got_bands = remat(x, mode="raw", bands=bands)
    for a, b in ((got, want), (frozen, want), (got_bands, want_bands)):
        assert all(torch.equal(u.detach(), v) for u, v in zip(a, b))
    state = torch.get_rng_state()
    f, s = remat(x, mode="both")
    (torch.sum(f * torch.from_numpy(wf))
     + torch.sum(s * torch.from_numpy(ws))).backward()
    assert torch.equal(torch.get_rng_state(), state)
