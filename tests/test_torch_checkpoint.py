"""The port's checkpoints (reference `torch.save` files) and their interop
with the JAX package's reference import / export, VGG16 import, and resume:
a resumed run takes the same next step as an uninterrupted one. Overlapped
saves: a routine save returns before its file is written, a best save
blocks, reads wait for a save in flight, a writer error is raised at the
next call, and a run's checkpoint equals one written by blocking saves."""

import copy
import os
import os.path as osp
import threading

import numpy as np
import pytest
import torch

from zeroshotsemanticsegmentation_tpu.models import ref_export as j_export
from zeroshotsemanticsegmentation_tpu.models import ref_import as j_import
from zeroshotsemanticsegmentation_tpu.models import vgg_import as j_vgg
from zeroshotsemanticsegmentation_tpu_torch.cli.train import run_experiment
from zeroshotsemanticsegmentation_tpu_torch.configs import Config
from zeroshotsemanticsegmentation_tpu_torch.models import ref_export
from zeroshotsemanticsegmentation_tpu_torch.models import ref_import
from zeroshotsemanticsegmentation_tpu_torch.models import vgg_import
from zeroshotsemanticsegmentation_tpu_torch.models import FCN8s, FCN32s
from zeroshotsemanticsegmentation_tpu_torch.models.jax_weights import (
    state_dict_from_jax_params)
from zeroshotsemanticsegmentation_tpu_torch.train import (
    make_fcn_optimizer, make_seenmask_optimizer)
from zeroshotsemanticsegmentation_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

C, SCALE = 20, 1 / 32


@pytest.fixture(scope="module")
def jax_params():
    """A JAX-layout FCN32s param tree (HWIO kernels) with seeded values:
    the inverse of `state_dict_from_jax_params` on a port model."""
    rng = np.random.RandomState(5)
    tree = {}
    for k, v in _model(3).state_dict().items():
        name, leaf = k.split(".")
        v = v.numpy()
        if leaf == "bias":
            tree[name]["bias"] = rng.randn(*v.shape).astype(np.float32)
        else:
            tree[name] = {"kernel": np.ascontiguousarray(v.transpose(
                (2, 3, 0, 1) if name == "seenmask_upscore" else (2, 3, 1, 0)))}
    return tree


def _model(seed=0):
    return FCN32s(C, channel_scale=SCALE, device="cpu",
                  generator=torch.Generator().manual_seed(seed))


def _trained(model, optim="adam", steps=2):
    """`model` and an optimizer with non-zero moments."""
    opt = make_fcn_optimizer(model, optim=optim, lr=1e-3)
    for _ in range(steps):
        opt.zero_grad()
        sum(p.square().sum() for p in model.parameters()).backward()
        opt.step()
    return opt


def _assert_sd_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k].float(), want[k].float()), k


def _assert_nested_equal(got, want):
    if torch.is_tensor(want):
        assert torch.is_tensor(got) and torch.equal(got, want)
    elif isinstance(want, dict):
        assert sorted(got, key=str) == sorted(want, key=str)
        for k in want:
            _assert_nested_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_nested_equal(g, w)
    else:
        assert got == want


def test_save_restore_round_trip_and_best_link(tmp_path):
    model = _model()
    opt = _trained(model)
    ckpt.save_checkpoint(str(tmp_path), model_state=model.state_dict(),
                         optim_state=opt.state_dict(), epoch=2, iteration=17,
                         best_mean_iu=0.5, is_best=True)
    path, best = tmp_path / "checkpoint", tmp_path / "best"
    assert ckpt.checkpoint_exists(str(path)) and ckpt.checkpoint_exists(
        str(best))
    assert os.stat(path).st_ino == os.stat(best).st_ino  # a hard link
    got = ckpt.restore_checkpoint(str(best))
    assert (got["arch"], got["epoch"], got["iteration"],
            got["best_mean_iu"], got["upscore_trained"],
            got["skipped_keys"]) == ("FCN32s", 2, 17, 0.5, False, [])
    _assert_sd_equal(got["params"], model.state_dict())
    _assert_nested_equal(got["opt_state"], opt.state_dict())
    # the file is the reference's: its keys in its order, 16 + 16 groups
    blob = torch.load(path, weights_only=True)
    assert list(blob)[:6] == ["epoch", "iteration", "arch",
                              "optim_state_dict", "model_state_dict",
                              "best_mean_iu"]
    assert list(blob["model_state_dict"])[29:] == [
        "fc7.bias", "score_fr.weight", "score_fr.bias", "upscore.weight",
        "seenmask_score.weight", "seenmask_score.bias",
        "seenmask_upscore.weight"]
    groups = blob["optim_state_dict"]["param_groups"]
    assert [len(g["params"]) for g in groups] == [16, 16]
    assert groups[1]["lr"] == 2 * groups[0]["lr"]

    # a later, not-best save writes a new file: best keeps epoch 2
    with torch.no_grad():
        model.fc7.weight.mul_(2)
    _trained(model, steps=1)
    ckpt.save_checkpoint(str(tmp_path), model_state=model.state_dict(),
                         optim_state=opt.state_dict(), epoch=3, iteration=20,
                         best_mean_iu=0.5, is_best=False,
                         upscore_trained=True)
    ckpt.finish_pending()  # a routine save writes in the background
    assert os.stat(path).st_ino != os.stat(best).st_ino
    latest, kept = ckpt.restore_checkpoint(str(path)), \
        ckpt.restore_checkpoint(str(best))
    assert latest["epoch"] == 3 and latest["upscore_trained"] is True
    assert kept["epoch"] == 2 and kept["upscore_trained"] is False
    assert not torch.equal(latest["params"]["fc7.weight"],
                           kept["params"]["fc7.weight"])


def test_optim_state_loads_into_the_reference_construction(tmp_path):
    """The reference builds Adam over its 16 weights then 16 biases
    (train.py:125-133) and loads the file's state unconditionally
    (train.py:136): the moments land on the same tensors."""
    model = _model()
    opt = _trained(model, steps=3)
    ckpt.save_checkpoint(str(tmp_path), model_state=model.state_dict(),
                         optim_state=opt.state_dict(), epoch=0, iteration=3,
                         best_mean_iu=0.1, is_best=False)
    ckpt.finish_pending()  # a routine save writes in the background
    blob = torch.load(tmp_path / "checkpoint", weights_only=True)
    ref = FCN32s(C, channel_scale=SCALE, device="cpu")
    mods = [m for m in ref_import.CONV_MODULES if m != "seenmask_score"]
    weights = [getattr(ref, m).weight for m in mods]
    biases = [getattr(ref, m).bias for m in mods]
    ref_opt = torch.optim.Adam([{"params": weights},
                                {"params": biases, "lr": 2e-5}], lr=1e-5)
    ref_opt.load_state_dict(blob["optim_state_dict"])
    for m, w in zip(mods, weights):
        src = getattr(model, m).weight
        assert torch.equal(ref_opt.state[w]["exp_avg"],
                           opt.state[src]["exp_avg"])
    assert ref_opt.param_groups[0]["lr"] == 1e-3  # the file's, as torch does


def test_port_checkpoint_loads_through_jax_import(tmp_path, jax_params):
    model = _model(1)
    with torch.no_grad():  # a stage-2-trained upscore carries through
        model.seenmask_upscore.weight.add_(0.01)
    ckpt.save_checkpoint(str(tmp_path), model_state=model.state_dict(),
                         optim_state=_trained(model, steps=0).state_dict(),
                         epoch=4, iteration=9, best_mean_iu=0.25,
                         is_best=True, upscore_trained=True)
    path = str(tmp_path / "best")
    assert j_import.is_reference_checkpoint(path)
    got = j_import.load_reference_checkpoint(path, jax_params)
    assert (got["epoch"], got["iteration"], got["best_mean_iu"],
            got["upscore_trained"]) == (4, 9, 0.25, True)
    assert got["skipped_keys"] == []
    _assert_sd_equal(state_dict_from_jax_params(got["params"]),
                     model.state_dict())


def test_jax_reference_file_loads_into_the_port(tmp_path, jax_params):
    path = str(tmp_path / "ref")
    j_export.save_reference_checkpoint(path, jax_params, epoch=6,
                                       iteration=40, best_mean_iu=0.3,
                                       fcn_optim="adam", fcn_lr=1e-5)
    want = state_dict_from_jax_params(jax_params)
    model = _model(2)
    got = ref_import.load_reference_checkpoint(path, model.state_dict())
    assert (got["epoch"], got["iteration"], got["best_mean_iu"],
            got["upscore_trained"], got["skipped_keys"]) == \
        (6, 40, 0.3, False, [])
    _assert_sd_equal(got["params"], want)
    # its (empty) optimizer state loads into the port's optimizer
    opt = make_fcn_optimizer(model, optim="adam", lr=1e-5)
    opt.load_state_dict(got["opt_state"])
    assert not opt.state
    # and the port writes the same model_state_dict the JAX export does
    ours = ref_export.reference_state_dict_from_params(want)
    theirs = j_export.reference_state_dict_from_params(jax_params)
    assert list(ours) == list(theirs)
    _assert_sd_equal(ours, theirs)
    for optim, lr in (("adam", 1e-5), ("sgd", 1e-10)):
        _assert_nested_equal(ref_export.reference_optim_state_dict(optim, lr),
                             j_export.reference_optim_state_dict(optim, lr))


def test_import_refusals(tmp_path, jax_params):
    sd = ref_export.reference_state_dict_from_params(
        state_dict_from_jax_params(jax_params))
    sd["upscore.weight"] = sd["upscore.weight"] + 0.1
    torch.save({"model_state_dict": sd}, tmp_path / "tampered")
    with pytest.raises(ValueError, match="upscore"):
        ref_import.load_reference_checkpoint(str(tmp_path / "tampered"))
    wide = FCN32s(C, channel_scale=2 * SCALE, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ref_import.load_reference_checkpoint(
            str(tmp_path / "tampered"), wide.state_dict())
    with pytest.raises(ValueError, match="FCN32s"):
        ref_export.reference_state_dict_from_params({"conv1_1.weight":
                                                     torch.zeros(1)})
    # a bare, partial state dict: strict=False merge, unknown keys reported
    model = _model()
    part = {"fc7.bias": torch.ones_like(model.fc7.bias),
            "extra.weight": torch.zeros(2)}
    torch.save(part, tmp_path / "bare")
    got = ref_import.load_reference_checkpoint(str(tmp_path / "bare"),
                                               model.state_dict())
    assert got["skipped_keys"] == ["extra.weight"] and got["opt_state"] is None
    assert torch.equal(got["params"]["fc7.bias"], part["fc7.bias"])
    assert torch.equal(got["params"]["fc6.weight"], model.fc6.weight)


def test_vgg16_import_equals_jax():
    """A seeded random torchvision-layout VGG16 state dict at its real
    shapes (the fc6/fc7 views fix them)."""
    g = np.random.default_rng(0)
    convs = ((3, 64), (64, 64), (64, 128), (128, 128), (128, 256),
             (256, 256), (256, 256), (256, 512), (512, 512), (512, 512),
             (512, 512), (512, 512), (512, 512))
    sd = {}
    for idx, (i, o) in zip(vgg_import._FEATURE_CONV_INDICES, convs):
        sd[f"features.{idx}.weight"] = g.standard_normal(
            (o, i, 3, 3), dtype=np.float32)
        sd[f"features.{idx}.bias"] = g.standard_normal(o, dtype=np.float32)
    sd["classifier.0.weight"] = g.standard_normal((4096, 25088),
                                                  dtype=np.float32)
    sd["classifier.0.bias"] = g.standard_normal(4096, dtype=np.float32)
    sd["classifier.3.weight"] = g.standard_normal((4096, 4096),
                                                  dtype=np.float32)
    sd["classifier.3.bias"] = g.standard_normal(4096, dtype=np.float32)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    got = vgg_import.vgg16_params_from_torch_state_dict(tsd)
    want = j_vgg.vgg16_params_from_torch_state_dict(sd)
    for name, leaves in want.items():
        np.testing.assert_array_equal(
            got[f"{name}.weight"].numpy(),
            leaves["kernel"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(got[f"{name}.bias"].numpy(),
                                      leaves["bias"])
        del leaves
    del want, sd
    # load_vgg16_into_params: a full-width target keeps its heads
    target = {k: torch.zeros_like(v) for k, v in got.items()}
    target["score_fr.weight"] = torch.zeros(C, 4096, 1, 1)
    out = vgg_import.load_vgg16_into_params(target, tsd)
    assert torch.equal(out["fc6.weight"], got["fc6.weight"])
    assert torch.equal(out["score_fr.weight"], target["score_fr.weight"])
    small = {k: v[..., :1] if v.dim() == 4 else v for k, v in target.items()}
    with pytest.raises(ValueError, match="shape"):
        vgg_import.load_vgg16_into_params(small, tsd)


def _cfg(**kw):
    base = dict(mode="train", dataset="pascal", embed_dim=20, fcn_lr=1e-3,
                fcn_loss="cos", fcn_optim="adam", seenmask_epochs=0,
                train_unseen=(1, 13), val_unseen=(6, 7), batch_size=2,
                eval_batch_size=2, bucket=(64, 64), compute_dtype="float32",
                channel_scale=SCALE, num_viz=0, log_flush_steps=2)
    base.update(kw)
    return Config(**base)


def _run(tmp_path, name, cfg, **kw):
    return run_experiment(cfg, data_dir=str(tmp_path),
                          log_dir=str(tmp_path / name), synthetic=True,
                          verbose=False, device="cpu", **kw)


def _rows(path):
    with open(path) as f:
        return [line.split(",")[:7] for line in f.read().splitlines()[1:]]


def test_resume_takes_the_uninterrupted_next_step(tmp_path):
    """Dropout on (the model's 0.5): the masks come from (seed, step)."""
    _run(tmp_path, "a", _cfg(fcn_epochs=2))
    _run(tmp_path, "b", _cfg(fcn_epochs=1))
    first = ckpt.restore_checkpoint(str(tmp_path / "b" / "checkpoint"))
    assert first["epoch"] == 0 and first["iteration"] == 3
    assert first["opt_state"]["state"]  # Adam's moments were saved
    _run(tmp_path, "c", _cfg(fcn_epochs=2),
         resume=str(tmp_path / "b" / "checkpoint"))
    a, c = _rows(tmp_path / "a" / "train_log.csv"), \
        _rows(tmp_path / "c" / "train_log.csv")
    assert len(a) == 6 and c == a[3:]   # same epoch-1 steps, bit for bit
    assert _rows(tmp_path / "a" / "val_log.csv")[1] == \
        _rows(tmp_path / "c" / "val_log.csv")[0]
    end_a = ckpt.restore_checkpoint(str(tmp_path / "a" / "checkpoint"))
    end_c = ckpt.restore_checkpoint(str(tmp_path / "c" / "checkpoint"))
    assert (end_c["epoch"], end_c["iteration"]) == (1, 6)
    _assert_sd_equal(end_c["params"], end_a["params"])
    _assert_nested_equal(end_c["opt_state"], end_a["opt_state"])


def test_stage2_saves_keep_the_stage1_optimizer(tmp_path):
    out = _run(tmp_path, "s", _cfg(fcn_epochs=1, seenmask_epochs=1))
    base = ckpt.restore_checkpoint(str(tmp_path / "s" / "best"))
    last = ckpt.restore_checkpoint(str(tmp_path / "s" / "checkpoint"))
    assert last["upscore_trained"] is True and last["epoch"] == 0
    assert last["iteration"] == 3  # stage 1's steps, not stage 2's
    assert [len(g["params"]) for g in last["opt_state"]["param_groups"]] \
        == [16, 16]
    assert np.isfinite(out["seenmask_best_mean_iu"])
    # its model weights load into a fresh model and a stage-2 optimizer
    # builds over them
    model = _model()
    model.load_state_dict(last["params"])
    assert make_seenmask_optimizer(model, lr=1e-3).param_groups
    assert osp.exists(tmp_path / "s" / "seenmask_val_log.csv")
    assert base["epoch"] == 0


def test_resume_from_a_stage2_checkpoint_takes_stage1s_next_step(tmp_path):
    """The run's final `checkpoint` (a stage-2 save) resumes stage 1 at its
    own step count with its moments: the same steps as an uninterrupted
    stage-1 run (stage 2 trains only the seenmask head)."""
    _run(tmp_path, "a", _cfg(fcn_epochs=2))
    _run(tmp_path, "s", _cfg(fcn_epochs=1, seenmask_epochs=1))
    last = ckpt.restore_checkpoint(str(tmp_path / "s" / "checkpoint"))
    assert (last["epoch"], last["iteration"]) == (0, 3)
    _run(tmp_path, "c", _cfg(fcn_epochs=2),
         resume=str(tmp_path / "s" / "checkpoint"))
    a, c = _rows(tmp_path / "a" / "train_log.csv"), \
        _rows(tmp_path / "c" / "train_log.csv")
    assert len(a) == 6 and c == a[3:]
    end_a = ckpt.restore_checkpoint(str(tmp_path / "a" / "checkpoint"))
    end_c = ckpt.restore_checkpoint(str(tmp_path / "c" / "checkpoint"))
    assert (end_c["epoch"], end_c["iteration"]) == (1, 6)
    _assert_sd_equal(*({k: v for k, v in sd["params"].items()
                        if not k.startswith("seenmask")}
                       for sd in (end_c, end_a)))
    _assert_nested_equal(end_c["opt_state"], end_a["opt_state"])


def _fcn8s(seed=0):
    return FCN8s(C, channel_scale=SCALE, device="cpu",
                 generator=torch.Generator().manual_seed(seed))


def test_fcn8s_checkpoint_round_trip(tmp_path):
    """An FCN-8s save: arch "FCN8s", the reference's key names plus the skip
    heads and no upscore weights; every tensor and Adam's moments read back
    bit-equal."""
    model = _fcn8s(2)
    with torch.no_grad():  # non-zero skip heads
        for name in ("score_pool3", "score_pool4"):
            getattr(model, name).weight.normal_()
    opt = _trained(model)
    ckpt.save_checkpoint(str(tmp_path), model_state=model.state_dict(),
                         optim_state=opt.state_dict(), epoch=1,
                         iteration=7, best_mean_iu=0.5, is_best=True)
    blob = torch.load(tmp_path / "checkpoint", weights_only=True)
    assert blob["arch"] == "FCN8s" and blob["upscore_trained"] is False
    keys = set(blob["model_state_dict"])
    assert keys == set(model.state_dict())
    assert {"score_pool3.weight", "score_pool4.bias"} <= keys
    assert not {"upscore.weight", "seenmask_upscore.weight"} & keys
    for path in ("checkpoint", "best"):
        got = ckpt.restore_checkpoint(str(tmp_path / path),
                                      _fcn8s().state_dict())
        assert got["arch"] == "FCN8s" and got["skipped_keys"] == []
        assert (got["epoch"], got["iteration"]) == (1, 7)
        _assert_sd_equal(got["params"], model.state_dict())
        fresh = make_fcn_optimizer(_fcn8s(), optim="adam", lr=1e-3)
        fresh.load_state_dict(got["opt_state"])
        _assert_nested_equal(fresh.state_dict(), opt.state_dict())
    assert [len(g["params"]) for g in opt.state_dict()["param_groups"]] \
        == [18, 18]


def test_fcn8s_resume_takes_the_uninterrupted_next_step(tmp_path):
    _run(tmp_path, "a", _cfg(fcn_epochs=2, arch="fcn8s"))
    _run(tmp_path, "b", _cfg(fcn_epochs=1, arch="fcn8s"))
    first = ckpt.restore_checkpoint(str(tmp_path / "b" / "checkpoint"))
    assert first["arch"] == "FCN8s" and first["opt_state"]["state"]
    assert first["params"]["score_pool3.weight"].any()  # trained off zero
    _run(tmp_path, "c", _cfg(fcn_epochs=2, arch="fcn8s"),
         resume=str(tmp_path / "b" / "checkpoint"))
    a, c = _rows(tmp_path / "a" / "train_log.csv"), \
        _rows(tmp_path / "c" / "train_log.csv")
    assert len(a) == 6 and c == a[3:]
    end_a = ckpt.restore_checkpoint(str(tmp_path / "a" / "checkpoint"))
    end_c = ckpt.restore_checkpoint(str(tmp_path / "c" / "checkpoint"))
    assert (end_c["epoch"], end_c["iteration"]) == (1, 6)
    _assert_sd_equal(end_c["params"], end_a["params"])
    _assert_nested_equal(end_c["opt_state"], end_a["opt_state"])


def test_jax_import_reads_a_port_fcn8s_checkpoint(tmp_path):
    """The JAX package reads a port FCN-8s file as a reference file: the
    modules it shares with FCN-32s equal, the skip heads in `skipped_keys`
    (the JAX import knows only the reference's modules)."""
    model = _fcn8s(4)
    ckpt.save_checkpoint(str(tmp_path), model_state=model.state_dict(),
                         optim_state={}, epoch=0, iteration=0,
                         best_mean_iu=0.0, is_best=False)
    ckpt.finish_pending()  # a routine save writes in the background
    target = {name: {"kernel": np.zeros(v.shape[2:] + v.shape[1::-1],
                                        np.float32),
                     "bias": np.zeros(v.shape[0], np.float32)}
              for name, v in ((k[:-len(".weight")], v) for k, v in
                              model.state_dict().items()
                              if k.endswith(".weight"))}
    got = j_import.load_reference_checkpoint(str(tmp_path / "checkpoint"),
                                             target)
    assert got["arch"] == "FCN8s"
    assert got["skipped_keys"] == ["score_pool3.bias", "score_pool3.weight",
                                   "score_pool4.bias", "score_pool4.weight"]
    assert got["upscore_trained"] is False
    sd = state_dict_from_jax_params(got["params"])
    for k, v in model.state_dict().items():
        if k.startswith("score_pool"):
            assert not sd[k].any(), k  # the JAX side keeps its own
        else:
            assert torch.equal(sd[k], v), k


def test_reference_fcn32s_file_into_fcn8s(tmp_path, jax_params):
    """A reference FCN-32s file merged into FCN-8s: the shared modules
    load, the skip heads keep their zero init, nothing is reported lost; a
    stage-2-trained seenmask_upscore is refused (JAX
    ref_import.py:130-152)."""
    src = state_dict_from_jax_params(jax_params)
    save = ref_export.save_reference_checkpoint
    save(str(tmp_path / "ref"), src)
    target = _fcn8s().state_dict()
    got = ref_import.load_reference_checkpoint(str(tmp_path / "ref"), target)
    assert got["skipped_keys"] == [] and got["upscore_trained"] is False
    model = _fcn8s()
    model.load_state_dict(got["params"], strict=True)
    for k, v in model.state_dict().items():
        if k.startswith("score_pool"):
            assert not v.any(), k
        else:
            assert torch.equal(v, src[k]), k
    trained = dict(src)
    trained["seenmask_upscore.weight"] = trained[
        "seenmask_upscore.weight"] + 0.5
    save(str(tmp_path / "trained"), trained)
    with pytest.raises(ValueError, match="stage-2-trained"):
        ref_import.load_reference_checkpoint(str(tmp_path / "trained"),
                                             target)


# ---- overlapped saves ------------------------------------------------------

def _save(tmp_path, model, opt, epoch, is_best):
    ckpt.save_checkpoint(str(tmp_path), model_state=model.state_dict(),
                         optim_state=opt.state_dict(), epoch=epoch,
                         iteration=10 * epoch, best_mean_iu=0.5,
                         is_best=is_best)


def _gated_torch_save(monkeypatch):
    """torch.save that waits for the returned event before it writes."""
    gate, real = threading.Event(), torch.save

    def save(obj, f):
        assert gate.wait(60), "the gate never opened"
        real(obj, f)

    monkeypatch.setattr(torch, "save", save)
    return gate


def test_routine_save_returns_before_its_file_is_written(tmp_path,
                                                         monkeypatch):
    """A routine save returns while its torch.save still waits; the file
    holds the state at the call, although the weights and Adam's moments
    change in place before it is written; `finish_pending` writes it."""
    model = _model()
    opt = _trained(model)
    want_sd = {k: v.clone() for k, v in model.state_dict().items()}
    want_opt = copy.deepcopy(opt.state_dict())
    gate = _gated_torch_save(monkeypatch)
    _save(tmp_path, model, opt, 1, is_best=False)
    path = tmp_path / "checkpoint"
    assert not path.exists() and ckpt._pending is not None
    _trained(model, steps=1)  # the next steps update everything in place
    gate.set()
    ckpt.finish_pending()
    assert path.exists() and ckpt._pending is None
    assert not (tmp_path / "checkpoint.tmp").exists()
    got = ckpt.restore_checkpoint(str(path))
    assert got["epoch"] == 1
    _assert_sd_equal(got["params"], want_sd)
    _assert_nested_equal(got["opt_state"], want_opt)


def test_best_save_blocks_and_waits_for_the_save_in_flight(tmp_path,
                                                           monkeypatch):
    model = _model()
    opt = _trained(model)
    gate = _gated_torch_save(monkeypatch)
    _save(tmp_path, model, opt, 1, is_best=False)
    threading.Timer(0.3, gate.set).start()
    _save(tmp_path, model, opt, 2, is_best=True)  # waits for epoch 1 first
    assert ckpt._pending is None
    best = ckpt.restore_checkpoint(str(tmp_path / "best"))
    assert best["epoch"] == 2
    assert os.stat(tmp_path / "best").st_ino == \
        os.stat(tmp_path / "checkpoint").st_ino


def test_reads_wait_for_a_save_in_flight_to_their_directory(tmp_path,
                                                            monkeypatch):
    """checkpoint_exists and restore_checkpoint of a path inside the log
    directory being written wait for its save; other paths do not."""
    model = _model()
    opt = _trained(model)
    gate = _gated_torch_save(monkeypatch)
    _save(tmp_path / "run", model, opt, 3, is_best=False)
    assert not ckpt.checkpoint_exists(str(tmp_path / "other" / "checkpoint"))
    assert ckpt._pending is not None  # another directory: no wait
    threading.Timer(0.3, gate.set).start()
    assert ckpt.checkpoint_exists(str(tmp_path / "run" / "checkpoint"))
    assert ckpt._pending is None


@pytest.mark.parametrize("surfaces_at", ["finish_pending", "next_save"])
def test_a_writer_error_is_raised_at_the_next_call(tmp_path, monkeypatch,
                                                   surfaces_at):
    model = _model()
    opt = _trained(model, steps=0)
    real = torch.save

    def full_disk(obj, f):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(torch, "save", full_disk)
    _save(tmp_path, model, opt, 1, is_best=False)  # returns: the writer fails
    monkeypatch.setattr(torch, "save", real)
    with pytest.raises(OSError, match="No space left"):
        if surfaces_at == "finish_pending":
            ckpt.finish_pending()
        else:
            _save(tmp_path, model, opt, 2, is_best=False)
    ckpt.finish_pending()  # raised once; the next save writes
    _save(tmp_path, model, opt, 3, is_best=False)
    ckpt.finish_pending()
    assert ckpt.restore_checkpoint(str(tmp_path / "checkpoint"))["epoch"] == 3


def test_resume_after_overlapped_saves_equals_blocking_saves(tmp_path,
                                                             monkeypatch):
    """run_experiment returns with every file on disk; its checkpoint and a
    resume from it equal a run whose saves all block."""
    cfg1, cfg2 = _cfg(fcn_epochs=1), _cfg(fcn_epochs=2)
    _run(tmp_path, "overlap", cfg1)
    assert ckpt._pending is None
    assert not [f for f in os.listdir(tmp_path / "overlap")
                if f.endswith(".tmp")]
    _run(tmp_path, "overlap2", cfg2,
         resume=str(tmp_path / "overlap" / "checkpoint"))
    with monkeypatch.context() as m:  # every save writes in the caller
        m.setattr(ckpt, "_start_writer", ckpt._write)
        _run(tmp_path, "block", cfg1)
        _run(tmp_path, "block2", cfg2,
             resume=str(tmp_path / "block" / "checkpoint"))
    for a, b in (("overlap", "block"), ("overlap2", "block2")):
        got = ckpt.restore_checkpoint(str(tmp_path / a / "checkpoint"))
        want = ckpt.restore_checkpoint(str(tmp_path / b / "checkpoint"))
        assert (got["epoch"], got["iteration"]) == \
            (want["epoch"], want["iteration"])
        _assert_sd_equal(got["params"], want["params"])
        _assert_nested_equal(got["opt_state"], want["opt_state"])
    assert _rows(tmp_path / "overlap2" / "train_log.csv") == \
        _rows(tmp_path / "block2" / "train_log.csv")
