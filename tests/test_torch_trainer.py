"""The port's FCNTrainer and SeenmaskTrainer vs the JAX package's, on the CPU.

Both trainers take the model as an argument, so both sides run FCN-32s at
channel_scale 1/32 with dropout off, from the same JAX init weights (carried
over by `load_jax_params`), fed by their own `BatchLoader`s over the same
`SyntheticDataset`s (their batches are equal byte for byte,
tests/test_torch_pipeline.py), with ragged tails in training and
validation. Bars: the stage-1 step's (tests/test_costail_fused.py:141-155):
losses rtol 1e-5, histogram rows exact and flips <= max(16, 0.5%).
"""

import csv
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotsemanticsegmentation_tpu import configs as jconfigs
from zeroshotsemanticsegmentation_tpu import data as jdata
from zeroshotsemanticsegmentation_tpu.models import FCN32s as JFCN32s
from zeroshotsemanticsegmentation_tpu.train import (
    FCNTrainer as JFCNTrainer, SeenmaskTrainer as JSeenmaskTrainer,
    make_fcn_optimizer as j_fcn_opt, make_seenmask_optimizer as j_sm_opt)
from zeroshotsemanticsegmentation_tpu.utils import RunLogger as JRunLogger
from zeroshotsemanticsegmentation_tpu_torch import configs, data
from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
from zeroshotsemanticsegmentation_tpu_torch.models.jax_weights import (
    load_jax_params, state_dict_from_jax_params)
from zeroshotsemanticsegmentation_tpu_torch.train import (
    FCNTrainer, SeenmaskTrainer, make_fcn_optimizer, make_seenmask_optimizer)
from zeroshotsemanticsegmentation_tpu_torch.train import checkpoint as ckpt
from zeroshotsemanticsegmentation_tpu_torch.utils import RunLogger

torch.set_num_threads(1)

C, HW, SCALE = 20, 64, 1 / 32
CFG = dict(mode="train", dataset="pascal", embed_dim=C, fcn_epochs=2,
           fcn_lr=1e-5, fcn_loss="cos", fcn_optim="adam", seenmask_epochs=2,
           seenmask_lr=1e-3, train_unseen=(1, 13), val_unseen=(6, 7, 10),
           batch_size=2, eval_batch_size=2, bucket=(HW, HW),
           compute_dtype="float32", channel_scale=SCALE, num_viz=2,
           log_flush_steps=2)


@pytest.fixture(scope="module")
def init():
    jm = JFCN32s(num_classes=C, dtype=jnp.float32, channel_scale=SCALE,
                 dropout_rate=0.0)
    params = jax.jit(lambda k, x: jm.init(k, x, mode="both"))(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))["params"]
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.RandomState(3)
    for leaves in tree.values():  # non-zero biases: every bias add counts
        if "bias" in leaves:
            leaves["bias"] = rng.randn(*leaves["bias"].shape).astype(
                np.float32) * 0.05
    r = np.random.RandomState(0).randn(21, C).astype(np.float32)
    embed = r / np.linalg.norm(r, axis=1, keepdims=True)
    return jm, tree, embed


def _loaders(pkg, train_seed):
    """(train, val) loaders of `pkg` (the JAX `data` or the port's):
    5 training images (a tail of one), 3 validation images (a tail of
    one), the compact feed, shuffled training."""
    mk = lambda n, seed: pkg.SyntheticDataset(  # noqa: E731
        num_images=n, num_classes=21, size_range=(40, HW), seed=seed)
    kw = dict(bucket_hw=(HW, HW), compact=True, num_threads=2)
    if pkg is jdata:
        kw["use_native"] = False
    return (pkg.BatchLoader(mk(5, train_seed), 2, shuffle=True, seed=7, **kw),
            pkg.BatchLoader(mk(3, 9), 2, **kw))


def _port_model(tree):
    return load_jax_params(
        FCN32s(C, channel_scale=SCALE, dropout_rate=0.0, device="cpu"), tree)


def _capture(trainer, attr="_eval_step"):
    """Wrap the trainer's eval step; returns the list its outputs'
    histograms go to (host numpy)."""
    seen, step = [], getattr(trainer, attr)

    def wrapped(*a):
        out = step(*a)
        seen.append(np.asarray(out["hists"]))
        return out

    setattr(trainer, attr, wrapped)
    return seen


def _losses(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return [(int(r["epoch"]), int(r["iteration"]), float(r["train/loss"]))
            for r in rows]


def _hold_hist(got, want):
    np.testing.assert_array_equal(got.sum(axis=-1), want.sum(axis=-1))
    assert np.abs(got - want).sum() <= max(16, 0.005 * want.sum())


def _hold_losses(got, want):
    assert [r[:2] for r in got] == [r[:2] for r in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=1e-5)


def test_fcn_trainer_matches_jax(tmp_path, init):
    jm, tree, embed = init
    jcfg, pcfg = jconfigs.Config(**CFG), configs.Config(**CFG)
    jlog = JRunLogger(str(tmp_path / "jax"), tensorboard=False, verbose=False)
    plog = RunLogger(str(tmp_path / "port"), tensorboard=False, verbose=False)

    params = jax.tree.map(jnp.asarray, tree)
    jt = JFCNTrainer(cfg=jcfg, model=jm,
                     tx=j_fcn_opt(params, optim="adam", lr=CFG["fcn_lr"]),
                     params=params, train_loader=_loaders(jdata, 1)[0],
                     val_loader=_loaders(jdata, 1)[1], logger=jlog,
                     embeddings=embed, target_embeddings=embed,
                     upscore_trained=False)
    model = _port_model(tree)
    pt = FCNTrainer(cfg=pcfg, model=model,
                    optimizer=make_fcn_optimizer(model, optim="adam",
                                                 lr=CFG["fcn_lr"]),
                    train_loader=_loaders(data, 1)[0],
                    val_loader=_loaders(data, 1)[1], logger=plog,
                    embeddings=embed, target_embeddings=embed,
                    upscore_trained=False)
    jh, ph = _capture(jt), _capture(pt)
    jt.train()
    pt.train()
    jlog.close()
    plog.close()

    want = _losses(osp.join(jlog.log_dir, "train_log.csv"))
    assert len(want) == 2 * 3   # 2 epochs x ceil(5 / 2) steps
    _hold_losses(_losses(osp.join(plog.log_dir, "train_log.csv")), want)
    assert len(ph) == len(jh) == 2 * 2  # 2 validations x 2 batches
    for g, w in zip(ph, jh):
        _hold_hist(g, w)
    assert pt.best_mean_iu == jt.best_mean_iu
    assert pt.iteration == jt.iteration == 6
    # the trained weights, live and as saved, vs the JAX trainer's; every
    # trained tensor moved by more than the bar (a dropped or misapplied
    # update fails it), the frozen seenmask head did not move
    first = state_dict_from_jax_params(tree)
    final = state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                    jt.state.params))
    saved = ckpt.restore_checkpoint(osp.join(plog.log_dir, "checkpoint"))
    live = model.state_dict()
    for k, want in final.items():
        for got in (live[k], saved["params"][k]):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        moved = not np.allclose(want.numpy(), first[k].numpy(),
                                rtol=1e-5, atol=1e-7)
        assert moved != k.startswith("seenmask"), k
    for name in ("checkpoint", "best"):
        assert osp.isfile(osp.join(plog.log_dir, name))
    assert osp.isfile(osp.join(plog.log_dir, "fcn_viz", "epoch1.jpg"))
    with open(osp.join(plog.log_dir, "val_log.csv")) as f, \
            open(osp.join(jlog.log_dir, "val_log.csv")) as g:
        assert f.readline() == g.readline()  # the same headers


def test_szn_validation_matches_jax(tmp_path, init):
    """test_all's full-SZN validation (the seenmask-gated stitched NNE)."""
    jm, tree, embed = init
    kw = dict(CFG, mode="test_all", load_fcn_path="x")
    jcfg, pcfg = jconfigs.Config(**kw), configs.Config(**kw)
    jlog = JRunLogger(str(tmp_path / "jax"), tensorboard=False, verbose=False)
    plog = RunLogger(str(tmp_path / "port"), tensorboard=False, verbose=False)
    params = jax.tree.map(jnp.asarray, tree)
    jt = JFCNTrainer(cfg=jcfg, model=jm,
                     tx=j_fcn_opt(params, optim="adam", lr=1e-5),
                     params=params, train_loader=_loaders(jdata, 1)[0],
                     val_loader=_loaders(jdata, 1)[1], logger=jlog,
                     embeddings=embed, upscore_trained=False)
    model = _port_model(tree)
    pt = FCNTrainer(cfg=pcfg, model=model,
                    optimizer=make_fcn_optimizer(model, optim="adam",
                                                 lr=1e-5),
                    train_loader=_loaders(data, 1)[0],
                    val_loader=_loaders(data, 1)[1], logger=plog,
                    embeddings=embed, upscore_trained=False)
    jh = _capture(jt, "_szn_eval_step")
    ph = _capture(pt, "_szn_eval_step")
    want = jt.validate(both_fcn_and_seenmask=True)
    got = pt.validate(both_fcn_and_seenmask=True)
    for g, w in zip(ph, jh):
        _hold_hist(g, w)
    assert got == want


def test_seenmask_trainer_matches_jax(tmp_path, init):
    jm, tree, embed = init
    jcfg, pcfg = jconfigs.Config(**CFG), configs.Config(**CFG)
    jlog = JRunLogger(str(tmp_path / "jax"), tensorboard=False, verbose=False)
    plog = RunLogger(str(tmp_path / "port"), tensorboard=False, verbose=False)
    params = jax.tree.map(jnp.asarray, tree)
    jt = JSeenmaskTrainer(cfg=jcfg, model=jm,
                          tx=j_sm_opt(params, lr=CFG["seenmask_lr"]),
                          params=params, train_loader=_loaders(jdata, 2)[0],
                          val_loader=_loaders(jdata, 2)[1], logger=jlog)
    model = _port_model(tree)
    pt = SeenmaskTrainer(cfg=pcfg, model=model,
                         optimizer=make_seenmask_optimizer(
                             model, lr=CFG["seenmask_lr"]),
                         train_loader=_loaders(data, 2)[0],
                         val_loader=_loaders(data, 2)[1], logger=plog)
    jh, ph = _capture(jt), _capture(pt)
    jt.train()
    pt.train()
    jlog.close()
    plog.close()
    want = _losses(osp.join(jlog.log_dir, "seenmask_train_log.csv"))
    assert len(want) == 2 * 3
    _hold_losses(_losses(osp.join(plog.log_dir, "seenmask_train_log.csv")),
                 want)
    assert len(ph) == len(jh) == 4
    for g, w in zip(ph, jh):
        _hold_hist(g, w)
    assert pt.best_mean_iu == jt.best_mean_iu
    assert pt.upscore_trained and jt.upscore_trained
    assert osp.isfile(osp.join(plog.log_dir, "seenmask_viz", "epoch0.jpg"))


def test_echo_feed_and_profiler_window_on_the_cpu(tmp_path, init):
    """On the CPU every copy is done at once, so `data_echo="auto"` serves
    only fresh batches and trains exactly as "off"; `profile_steps` writes
    a torch.profiler trace of its window."""
    from zeroshotsemanticsegmentation_tpu_torch.train import trainer_fcn
    _, tree, embed = init
    rows = {}
    for echo in ("off", "auto"):
        cfg = configs.Config(**dict(CFG, data_echo=echo, fcn_epochs=1,
                                    profile_steps=1 if echo == "auto" else 0))
        log = RunLogger(str(tmp_path / echo), tensorboard=False,
                        verbose=False)
        model = _port_model(tree)
        trainer = FCNTrainer(
            cfg=cfg, model=model,
            optimizer=make_fcn_optimizer(model, optim="adam", lr=1e-5),
            train_loader=_loaders(data, 1)[0],
            val_loader=_loaders(data, 1)[1], logger=log, embeddings=embed,
            upscore_trained=False)
        trainer.train_epoch()
        log.close()
        rows[echo] = _losses(osp.join(log.log_dir, "train_log.csv"))
    assert rows["auto"] == rows["off"] and len(rows["off"]) == 3
    assert trainer_fcn.echo_feed.last_stats == {
        "served": 3, "echoes": 0, "echo_factor": 1.0}
    assert osp.getsize(tmp_path / "auto" / "profile" / "trace.json") > 0
