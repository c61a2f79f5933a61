"""The port's multi-device layer (`parallel/`) vs the JAX package's, on the
CPU.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py, as
tests/test_parallel.py runs it; the port side runs in gloo processes
(`parallel.dryrun.spawn`, rank functions in tests/torch_mesh_ranks.py).
Inputs come from one numpy seed, weights cross over through
`models.jax_weights`. Setup: `channel_scale` 1/16, a 64x64 bucket, B=4, 8
classes (tests/test_parallel.py:21-31); dropout off for the comparisons
with JAX. Height-sharded serving at tests/test_serving.py's (1, 64, 96)
image. Bars: those of tests/test_parallel.py (loss rtol 1e-5,
parameters rtol 2e-3 / atol 1e-4, hist exact; the fused tail's near-tie
allowance); with dropout on, the port's mesh step against its one-device
step at the port's gradient bar (relative norm < 1e-4).
"""

import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotsemanticsegmentation_tpu.models import FCN8s as JFCN8s
from zeroshotsemanticsegmentation_tpu.models import FCN32s as JFCN32s
from zeroshotsemanticsegmentation_tpu.models import ref_import as j_import
from zeroshotsemanticsegmentation_tpu.ops.metrics import unseen_mask_vector
from zeroshotsemanticsegmentation_tpu.parallel import (
    make_mesh as j_make_mesh, make_multislice_mesh as j_make_multislice,
    shard_batch as j_shard_batch,
    shard_params as j_shard_params)
from zeroshotsemanticsegmentation_tpu.serving import (
    make_szn_predictor as j_predictor)
from zeroshotsemanticsegmentation_tpu.train import (
    make_fcn_optimizer as j_optimizer)
from zeroshotsemanticsegmentation_tpu.train.state import (
    TrainState as JTrainState)
from zeroshotsemanticsegmentation_tpu.train.steps import (
    make_fcn_train_step as j_train_step, make_szn_eval_step as j_szn_eval)
from zeroshotsemanticsegmentation_tpu_torch.models import FCN8s, FCN32s
from zeroshotsemanticsegmentation_tpu_torch.models.jax_weights import (
    state_dict_from_jax_params)
from zeroshotsemanticsegmentation_tpu_torch.parallel import dryrun
from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
    TP_RULES, Mesh, data_axes, group_ranks, rank_grid, shard_batch,
    shard_params, shard_shape)
from zeroshotsemanticsegmentation_tpu_torch.serving import make_szn_predictor
from zeroshotsemanticsegmentation_tpu_torch.train import checkpoint as ckpt

import torch_mesh_ranks as ranks

torch.set_num_threads(1)

C = N = 8
B = 4
UNSEEN = [1, 3]
LAYOUTS = {"4x2": (("data", "model"), (4, 2)),
           "2x2x2": (("slice", "data", "model"), (2, 2, 2))}
SPATIAL_HW = (64, 96)  # tests/test_serving.py:226


def _jax_mesh(sizes, devices=None):
    devices = jax.devices() if devices is None else devices
    if len(sizes) == 3:
        return j_make_multislice(*sizes, devices=devices)
    return j_make_mesh(*sizes, devices=devices)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(1337)
    jm = JFCN32s(num_classes=C, channel_scale=1 / 16, dropout_rate=0.0)
    batch = ranks.np_batch(rng, B)
    embed = rng.randn(N, C).astype(np.float32)
    embed /= np.linalg.norm(embed, axis=1, keepdims=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(batch["image"][:1]),
                     mode="both")["params"]
    tree = jax.tree.map(np.asarray, params)
    for leaves in tree.values():  # non-zero biases: every bias add counts
        if "bias" in leaves:
            leaves["bias"] = (rng.randn(*leaves["bias"].shape)
                              .astype(np.float32) * 0.05)
    return jm, tree, batch, embed


def _jax_steps(jm, tree, batch, embed, mesh, n_steps=2):
    params = jax.tree.map(jnp.asarray, tree)
    tx = j_optimizer(params, optim="adam", lr=1e-3)
    params = j_shard_params(params, mesh)
    jb = j_shard_batch(batch, mesh)
    state = JTrainState(params=params, opt_state=jax.jit(tx.init)(params),
                        step=jnp.zeros((), jnp.int32))
    step = j_train_step(jm, tx, loss_name="cos", num_classes=N,
                        embeddings=embed)
    for _ in range(n_steps):
        state, aux = step(state, jb, jax.random.PRNGKey(42))
    return (state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                    state.params)),
            jax.tree.map(np.asarray, aux))


def _spawn_jobs(sizes, tree, batch, embed, jobs):
    world = int(np.prod(sizes))
    return dryrun.spawn(ranks.mesh_jobs, world, (
        sizes, ["cpu"] * world, state_dict_from_jax_params(tree), batch,
        embed, jobs), timeout_s=300)


def _uv():
    return unseen_mask_vector(N, UNSEEN)


@pytest.fixture(scope="module")
def spatial_setup():
    """The height-sharded image (tests/test_serving.py's, randn x 40) and
    a JAX FCN8s tree with non-zero biases and skip heads."""
    rng = np.random.RandomState(4242)
    image = rng.randn(1, *SPATIAL_HW, 3).astype(np.float32) * 40
    jm8 = JFCN8s(num_classes=C, channel_scale=1 / 16, dropout_rate=0.0)
    tree8 = jax.tree.map(np.asarray, jm8.init(
        jax.random.PRNGKey(1), jnp.zeros((1, *SPATIAL_HW, 3)),
        mode="both")["params"])
    for name, leaves in tree8.items():
        leaves["bias"] = rng.randn(*leaves["bias"].shape).astype(
            np.float32) * 0.05
        if name.startswith("score_pool"):
            leaves["kernel"] = rng.randn(*leaves["kernel"].shape).astype(
                np.float32) * 0.1
    return image, jm8, tree8


@pytest.fixture(scope="module")
def mesh42(setup, spatial_setup):
    """One 8-process run on the 4x2 mesh: the stage-1 step with the plain
    and the fused tail (two steps, and one), with dropout, the SZN eval
    (unfused and fused), mesh serving (both gate routes, FCN-8s), the
    same three height-sharded, and int8 serving batch-sharded and
    height-sharded."""
    _, tree, batch, embed = setup
    image, _, tree8 = spatial_setup
    serve = dict(unseen_classes=UNSEEN)
    spatial = dict(serve, spatial=True, images=image)
    jobs = {
        "plain": ("train", dict(fused_tail=False)),
        "fused": ("train", dict(fused_tail=True)),
        "one_step": ("train", dict(fused_tail=False, steps=1)),
        "dropout": ("train", dict(fused_tail=True, dropout=0.5, steps=1)),
        "eval": ("eval", dict(unseen=_uv())),
        "eval_fused": ("eval", dict(unseen=_uv(), fused=True)),
        **{"serve_" + route: ("serve", dict(serve, route=route))
           for route in ("pristine", "trained", "fcn8s")},
        "spatial_pristine": ("serve", spatial),
        "spatial_trained": ("serve", dict(spatial, route="trained")),
        "spatial_fcn8s": ("serve", dict(
            spatial, route="fcn8s",
            sd8=state_dict_from_jax_params(tree8))),
        "int8": ("serve", dict(serve, int8=True)),
        "int8_spatial": ("serve", dict(spatial, int8=True)),
    }
    return _spawn_jobs((4, 2), tree, batch, embed, jobs)


@pytest.fixture(scope="module")
def multislice(setup):
    """A 4-process 2x1x2 multislice run: two steps, one step with two
    microbatches a rank (dropout off, and on), and the gradient
    all-reduce with every gradient in place and with none."""
    _, tree, batch, embed = setup
    jobs = {"plain": ("train", dict(fused_tail=False)),
            "accum": ("train", dict(fused_tail=False, steps=1,
                                    grad_accum=2)),
            "accum_dropout": ("train", dict(fused_tail=True, dropout=0.5,
                                            steps=1, grad_accum=2)),
            "reduce_in_place": ("reduce", dict(in_place_numel=1)),
            "reduce_flat": ("reduce", dict(in_place_numel=1 << 30))}
    return _spawn_jobs((2, 1, 2), tree, batch, embed, jobs)


@pytest.fixture(scope="module")
def jax42(setup):
    """Two steps of the JAX package's step on `make_mesh(4, 2)`."""
    jm, tree, batch, embed = setup
    return _jax_steps(jm, tree, batch, embed, _jax_mesh((4, 2)))


def _hold_params(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-3, atol=1e-4, err_msg=k)


def _hold_hist(got, want, exact):
    got, want = np.asarray(got), np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    # the fused tail's near-tie allowance (test_costail_fused)
    np.testing.assert_array_equal(got.sum(axis=1), want.sum(axis=1))
    assert np.abs(got - want).sum() <= max(16, 0.005 * want.sum())


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(b.norm(), 1e-30))


# ---- layout: pure functions, no processes -----------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mesh_coords_equal_jax_device_positions(layout):
    names, sizes = LAYOUTS[layout]
    jmesh = _jax_mesh(sizes)
    assert tuple(jmesh.axis_names) == names
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    np.testing.assert_array_equal(rank_grid(sizes), ids)
    data_groups, model_groups = group_ranks(sizes)
    for r in range(int(np.prod(sizes))):
        m = Mesh(names, sizes, r, "cpu")
        pos = tuple(int(i) for i in np.argwhere(ids == r)[0])
        assert tuple(m.coords[a] for a in names) == pos
        # the data group spans every data axis at this model coordinate,
        # the model group the model axis at this data position
        assert data_groups[m.model_rank] == ids[..., pos[-1]].reshape(
            -1).tolist()
        assert model_groups[m.data_rank] == ids[pos[:-1]].tolist()
        assert m.data_size == ids[..., 0].size
        assert data_axes(m) == names[:-1]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_shards_equal_jax_shards(setup, layout):
    """Each rank's fc6 / fc7 shards (`shard_params` of the bridged tree)
    equal the JAX `NamedSharding` shards of its device, leaf by leaf, and
    batch rows follow the JAX batch sharding."""
    _, tree, batch, _ = setup
    names, sizes = LAYOUTS[layout]
    jmesh = _jax_mesh(sizes)
    sp = j_shard_params(jax.tree.map(jnp.asarray, tree), jmesh)
    jb = j_shard_batch(batch, jmesh)
    sd = state_dict_from_jax_params(tree)
    for r, dev in enumerate(jax.devices()[:int(np.prod(sizes))]):
        mine = shard_params(sd, Mesh(names, sizes, r, "cpu"))
        theirs = {mod: {leaf: np.asarray(next(
            s.data for s in arr.addressable_shards if s.device == dev))
            for leaf, arr in leaves.items()} for mod, leaves in sp.items()}
        theirs = state_dict_from_jax_params(theirs)
        for k in sd:
            assert torch.equal(mine[k], theirs[k]), (r, k)
            assert tuple(mine[k].shape) == shard_shape(k, sd[k].shape,
                                                       sizes[-1])
        rows = shard_batch(batch, Mesh(names, sizes, r, "cpu"))
        want = next(s.data for s in jb["image"].addressable_shards
                    if s.device == dev)
        np.testing.assert_array_equal(rows["image"], np.asarray(want))
        assert rows["num_real"] == batch["num_real"]


def test_tp_rules_split_fc6_out_fc7_in():
    assert TP_RULES == {"fc6.weight": 0, "fc6.bias": 0, "fc7.weight": 1}
    assert shard_shape("fc6.weight", (4096, 512, 7, 7), 4) == (1024, 512, 7,
                                                                7)
    assert shard_shape("fc7.weight", (4096, 4096, 1, 1), 4) == (4096, 1024,
                                                                 1, 1)
    assert shard_shape("fc7.bias", (4096,), 4) == (4096,)


# ---- the stage-1 step -------------------------------------------------------

@pytest.mark.parametrize("tail", ["plain", "fused"])
def test_dp_tp_step_matches_jax(jax42, mesh42, tail):
    """Two Adam steps on the 4x2 mesh vs the JAX package's on
    `make_mesh(4, 2)` (test_dp_tp_matches_single_device's bars); the
    fused tail (its plain version here) with the near-tie allowance of
    test_fused_tail_mesh_step_matches_single."""
    want, jaux = jax42
    for got in mesh42:
        res = got[tail]
        np.testing.assert_allclose(res["aux"][-1]["loss"], jaux["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(res["aux"][-1]["score_sum"],
                                   jaux["score_sum"], rtol=1e-4)
        _hold_hist(res["aux"][-1]["hist"], jaux["hist"],
                   exact=tail == "plain")
    _hold_params(mesh42[0][tail]["params"], want)


def test_multislice_step_matches_jax(setup, multislice):
    """Two Adam steps on the 2x1x2 multislice mesh (4 processes) vs the
    JAX package's `make_multislice_mesh(2, 1, 2)` on 4 devices."""
    jm, tree, batch, embed = setup
    want, jaux = _jax_steps(jm, tree, batch, embed,
                            _jax_mesh((2, 1, 2), jax.devices()[:4]))
    res = multislice[0]["plain"]
    np.testing.assert_allclose(res["aux"][-1]["loss"], jaux["loss"],
                               rtol=1e-5)
    _hold_hist(res["aux"][-1]["hist"], jaux["hist"], exact=True)
    _hold_params(res["params"], want)
    assert multislice[3]["coords"] == {"slice": 1, "data": 0, "model": 1}


def test_mesh_gradients_are_sums_not_means(setup, mesh42, multislice):
    """The gradients themselves (not only the parameters after Adam, which
    hides a scale): one step on the 4x2 mesh, on the multislice mesh with
    two microbatches a rank, and on one device with two microbatches, each
    vs the one-device step, dropout off."""
    _, tree, batch, embed = setup
    sd = state_dict_from_jax_params(tree)
    ref = ranks.train_job(None, sd, batch, embed, fused_tail=False, steps=1)
    accum = ranks.train_job(None, sd, batch, embed, fused_tail=False,
                            steps=1, grad_accum=2)
    for res in (mesh42[0]["one_step"], multislice[0]["accum"], accum):
        assert set(res["grads"]) == set(ref["grads"])
        for k, g in ref["grads"].items():
            assert _rel(res["grads"][k], g) < 1e-4, k


@pytest.mark.parametrize("job", ["reduce_in_place", "reduce_flat"])
def test_all_reduce_grads_sums_over_data(multislice, job):
    """`all_reduce_grads` sums over the data group (ranks 0, 2 and 1, 3
    of the 2x1x2 mesh), whether a gradient is reduced where it lies or
    through the flat buffer, a non-contiguous one too."""
    for r in multislice:
        for i, g in enumerate(r[job]):
            base = torch.arange(g.numel(), dtype=torch.float32).reshape(
                g.shape) + 0.5
            assert torch.equal(g, 3 * base), (r["coords"], i)


def test_replicated_gradients_equal_on_model_ranks(mesh42):
    """Parameters outside TP_RULES need no reduction over 'model': their
    gradients are equal on every model rank of a data position."""
    by_data = {}
    for r in mesh42:
        by_data.setdefault(r["data_rank"], []).append(r["plain"])
    for group in by_data.values():
        assert len(group) == 2
        a, b = group[0]["local_grads"], group[1]["local_grads"]
        for k in a:
            if k in TP_RULES:
                assert not torch.equal(a[k], b[k]), k  # different shards
            else:
                assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("run,job,accum", [
    ("mesh42", "dropout", 1), ("multislice", "accum_dropout", 2)])
def test_dropout_mesh_step_matches_one_device(setup, request, run, job,
                                              accum):
    """Dropout on: every rank draws the global mask and keeps its rows and
    channels, so the mesh step's gradients equal the one-device step's
    under the same generator (the port's gradient bar): on the 4x2 mesh,
    and on the multislice mesh with two microbatches, where each rank's
    i-th microbatch must be its rows of the global i-th."""
    _, tree, batch, embed = setup
    sd = state_dict_from_jax_params(tree)
    ref = ranks.train_job(None, sd, batch, embed, fused_tail=True,
                          dropout=0.5, steps=1, grad_accum=accum)
    off = ranks.train_job(None, sd, batch, embed, fused_tail=True, steps=1,
                          grad_accum=accum)
    got = request.getfixturevalue(run)[0][job]
    np.testing.assert_allclose(got["aux"][0]["loss"], ref["aux"][0]["loss"],
                               rtol=1e-5)
    for k, g in ref["grads"].items():
        assert _rel(got["grads"][k], g) < 1e-4, k
    # the masks did act: the dropout step differs from the one without
    assert _rel(off["grads"]["fc6.weight"], ref["grads"]["fc6.weight"]) > 0.1


# ---- eval and serving -------------------------------------------------------

@pytest.mark.parametrize("route", ["eval", "eval_fused"])
def test_sharded_szn_eval_matches_jax(setup, mesh42, route):
    """The SZN eval step on the 4x2 mesh vs the JAX package's on
    `make_mesh(4, 2)` (test_sharded_szn_eval_matches_single_device); the
    fused route (K1's plain version here) too."""
    jm, tree, batch, embed = setup
    jmesh = _jax_mesh((4, 2))
    step = j_szn_eval(jm, loss_name="cos", num_classes=N, embeddings=embed,
                      all_unseen_vec=_uv(), val_unseen_vec=_uv())
    ref = jax.tree.map(np.asarray, step(
        j_shard_params(jax.tree.map(jnp.asarray, tree), jmesh),
        j_shard_batch(batch, jmesh)))
    for r in mesh42:
        out = r[route]
        np.testing.assert_allclose(out["loss_sum"], ref["loss_sum"],
                                   rtol=1e-5)
        np.testing.assert_array_equal(out["hists"], ref["hists"])
        rows = slice(r["data_rank"], r["data_rank"] + 1)  # B/4 = 1 a rank
        np.testing.assert_array_equal(out["pred"], ref["pred"][rows])


@pytest.mark.parametrize("route", ["pristine", "trained", "fcn8s"])
def test_mesh_serving_matches_one_device(setup, mesh42, route):
    """Labels of the predictor on the 4x2 mesh (global, on every rank) vs
    the one-device predictor's, flips < 1e-4: FCN-32s with the pristine
    gate (K1 once) and a trained one (K1 twice and the ConvTranspose),
    and FCN-8s's unfused route."""
    _, tree, batch, embed = setup
    sd = state_dict_from_jax_params(tree)
    want = ranks.serve_job(None, sd, batch, embed, unseen_classes=UNSEEN,
                           route=route)
    key = "serve_" + route
    for r in mesh42:
        assert r[key].shape == (B, 64, 64)
        assert (r[key] != want).mean() < 1e-4
        np.testing.assert_array_equal(r[key], mesh42[0][key])


def _jax_labels(setup, spatial_setup, route, **kw):
    """The JAX package's predictor on `make_mesh(4, 2)` (spatial: the
    (1, 64, 96) image; else the batch), on the weights of the port's
    job."""
    jm, tree, batch, embed = setup
    image, jm8, tree8 = spatial_setup
    if route == "fcn8s":
        jm, tree = jm8, tree8
    if route == "trained":
        up = ranks.trained_gate(state_dict_from_jax_params(tree))[
            "seenmask_upscore.weight"].numpy()
        tree = {**tree, "seenmask_upscore": {
            "kernel": np.ascontiguousarray(up.transpose(2, 3, 0, 1))}}
    predict = j_predictor(jm, jax.tree.map(jnp.asarray, tree), embed,
                          UNSEEN, mesh=_jax_mesh((4, 2)), **kw)
    return np.asarray(predict(image if kw.get("spatial")
                              else batch["image"]))


def _one_device(setup, spatial_setup, route, **kw):
    _, tree, batch, embed = setup
    image, _, tree8 = spatial_setup
    return ranks.serve_job(None, state_dict_from_jax_params(tree), batch,
                           embed, unseen_classes=UNSEEN, route=route,
                           sd8=state_dict_from_jax_params(tree8), **kw)


@pytest.mark.parametrize("route", ["pristine", "trained", "fcn8s"])
def test_spatial_serving_matches_one_device_and_jax(setup, spatial_setup,
                                                    mesh42, route):
    """Height-sharded serving on the 4x2 mesh (height over 4 ranks, fc6 /
    fc7 over 2) of tests/test_serving.py's (1, 64, 96) image: the global
    labels on every rank vs the one-device port's and vs the JAX
    package's spatial predictor on `make_mesh(4, 2)`, flips < 1e-4 (that
    test's bar): FCN-32s with the pristine and a trained gate, and
    FCN-8s."""
    image, _, _ = spatial_setup
    want = _one_device(setup, spatial_setup, route, images=image)
    theirs = _jax_labels(setup, spatial_setup, route, spatial=True)
    key = "spatial_" + route
    for r in mesh42:
        assert r[key].shape == (1, *SPATIAL_HW)
        assert (r[key] != want).mean() < 1e-4
        assert (r[key] != theirs).mean() < 1e-4
        np.testing.assert_array_equal(r[key], mesh42[0][key])


@pytest.mark.parametrize("job", ["int8", "int8_spatial"])
def test_int8_mesh_serving_matches_one_device_and_jax(setup, spatial_setup,
                                                      mesh42, job):
    """int8 serving on the 4x2 mesh, batch-sharded (B=4) and
    height-sharded ((1, 64, 96)): each scale is the one-device one (MAX
    all-reduces; fc7's int32 products summed over 'model'), so the labels
    equal the one-device port's int8 labels, and match the JAX int8
    predictor on `make_mesh(4, 2)` (flips < 1e-4 each); against the
    one-device bf16 labels under the JAX int8 bar (< 0.08)."""
    image, _, _ = spatial_setup
    spatial = job == "int8_spatial"
    kw = {"images": image} if spatial else {}
    want = _one_device(setup, spatial_setup, "pristine", int8=True, **kw)
    bf16 = _one_device(setup, spatial_setup, "pristine",
                       dtype=torch.bfloat16, **kw)
    theirs = _jax_labels(setup, spatial_setup, "pristine", int8=True,
                         spatial=spatial)
    for r in mesh42:
        assert r[job].shape == want.shape
        np.testing.assert_array_equal(r[job], want)
        assert (r[job] != theirs).mean() < 1e-4
        assert (r[job] != bf16).mean() < 0.08


def test_spatial_without_mesh_and_int8_fcn8s_raise(setup):
    """`spatial=True` without a mesh raises ValueError (the JAX package
    ignores the flag there), as int8 with FCN-8s does, on a mesh too."""
    _, _, _, embed = setup
    model = FCN32s(C, channel_scale=1 / 16, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        make_szn_predictor(model, None, embed, UNSEEN, device="cpu",
                           spatial=True)
    layout = Mesh(("data", "model"), (1, 1), 0, "cpu")
    fcn8s = FCN8s(C, channel_scale=1 / 16, device="cpu")
    for mesh in (None, layout):
        with pytest.raises(ValueError, match="int8"):
            make_szn_predictor(fcn8s, None, embed, UNSEEN, device="cpu",
                               mesh=mesh, int8=True)


# ---- the experiment, the dry run --------------------------------------------

@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_run"))
    out = dryrun.spawn(ranks.experiment_job, 4, (tmp, (2, 2)),
                       timeout_s=300)
    return tmp, out


def test_run_experiment_on_mesh(experiment):
    """`run_experiment` on a 2x2 gloo mesh (the flow of the JAX package's
    test_run_experiment_end_to_end_on_mesh): two epochs, the seenmask
    stage, one set of files from rank 0, and a resume that continues the
    counters."""
    import pandas as pd
    tmp, out = experiment
    first = out[0]["first"]
    assert np.isfinite(first["best_mean_iu"])
    assert "seenmask_best_mean_iu" in first
    assert all(r["first"]["best_mean_iu"] == first["best_mean_iu"]
               for r in out)
    run_dir = osp.join(tmp, "mesh")
    assert ckpt.checkpoint_exists(osp.join(run_dir, "best"))
    assert [f for f in os.listdir(run_dir) if f.endswith(".tmp")] == []
    tr = pd.read_csv(osp.join(run_dir, "train_log.csv"))
    assert len(tr) == len(set(zip(tr["epoch"], tr["iteration"])))  # once
    assert osp.isfile(osp.join(run_dir, "fcn_viz", "epoch0.jpg"))
    saved = ckpt.restore_checkpoint(osp.join(run_dir, "checkpoint"))
    start = int(saved["epoch"]) + 1
    tr2 = pd.read_csv(osp.join(tmp, "mesh2", "train_log.csv"))
    assert set(tr2["epoch"]) == set(range(start, 3))
    assert np.isfinite(out[0]["second"]["best_mean_iu"])


def test_mesh_checkpoint_loads_on_one_device_and_in_jax(experiment):
    """The mesh run's file is the one-device format: full fc6 / fc7 and
    Adam moments, readable by the one-device port and the JAX import."""
    tmp, _ = experiment
    path = osp.join(tmp, "mesh2", "checkpoint")
    model = FCN32s(20, channel_scale=1 / 32, device="cpu")
    saved = ckpt.restore_checkpoint(path, model.state_dict())
    model.load_state_dict(saved["params"])
    sd = model.state_dict()
    moments = saved["opt_state"]["state"]
    shapes = sorted(tuple(v["exp_avg"].shape) for v in moments.values())
    assert shapes == sorted(tuple(v.shape) for k, v in sd.items()
                            if not k.startswith("seenmask"))
    target = {name: {"kernel": np.zeros(v.shape[2:] + v.shape[1::-1],
                                        np.float32),
                     "bias": np.zeros(v.shape[0], np.float32)}
              for name, v in ((k[:-len(".weight")], v) for k, v in
                              sd.items()
                              if k.endswith(".weight")
                              and not k.startswith("seenmask_upscore"))}
    target["seenmask_upscore"] = {"kernel": np.zeros(
        sd["seenmask_upscore.weight"].shape[2:] + (2, 2), np.float32)}
    got = j_import.load_reference_checkpoint(path, target)
    back = state_dict_from_jax_params(got["params"])
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_dryrun_runs_on_four_processes():
    """The dry run at `channel_scale` 0.5: one DP x TP Adam step and one
    SZN eval step over 4 gloo processes (2x2)."""
    result = dryrun.run(4)
    assert result["mesh"] == {"data": 2, "model": 2}
    assert np.isfinite(result["train_loss"])
    assert result["fc6_shard"] == (1024, 256, 7, 7)
    assert result["fc7_shard"] == (2048, 1024, 1, 1)


@pytest.mark.parametrize("n", [2, 8])
def test_full_width_shards_on_meta(n):
    out = dryrun.check_full_width(n)
    m = 2 if n == 8 else 1
    assert out["mesh"]["model"] == m
    # fc6 (4096x512x7x7 + 4096) and fc7 (4096x4096) split over m ranks
    full = 4096 * 512 * 49 + 4096 + 4096 * 4096
    assert out["per_model_rank"][0]["param_bytes"] == (
        134_367_062 - full + full // m) * 4
