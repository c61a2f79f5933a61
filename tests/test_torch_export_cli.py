"""The port's export CLI (cli/export.py): a port checkpoint -> a reference
file the JAX package's `load_reference_checkpoint` reads back to the same
weights; `--fcn_optim/--fcn_lr` default from the run's config.yaml; an
FCN-8s checkpoint is refused with the JAX export's message."""

import os.path as osp

import numpy as np
import pytest
import torch

from zeroshotsemanticsegmentation_tpu.models import ref_export as j_export
from zeroshotsemanticsegmentation_tpu.models import ref_import as j_import
from zeroshotsemanticsegmentation_tpu_torch.cli import export as tx
from zeroshotsemanticsegmentation_tpu_torch.models import FCN8s, FCN32s
from zeroshotsemanticsegmentation_tpu_torch.models.jax_weights import (
    state_dict_from_jax_params)
from zeroshotsemanticsegmentation_tpu_torch.train import (
    make_fcn_optimizer, make_seenmask_optimizer)
from zeroshotsemanticsegmentation_tpu_torch.train import checkpoint as ckpt
from zeroshotsemanticsegmentation_tpu_torch.utils.logging import dump_yaml

torch.set_num_threads(1)

C, SCALE = 20, 1 / 32


def _run_dir(tmp_path, model, *, optim="adam", lr=1e-5, upscore=False):
    """A log directory as a run leaves it: config.yaml and a checkpoint
    with Adam's moments (and a stage-2-trained upscore when asked)."""
    if upscore:
        with torch.no_grad():
            model.seenmask_upscore.weight.add_(0.01)
    opt = make_fcn_optimizer(model, optim=optim, lr=1e-3)
    opt.zero_grad()
    sum(p.square().sum() for p in model.parameters()).backward()
    opt.step()
    (tmp_path / "config.yaml").write_text(dump_yaml(
        {"fcn_optim": optim, "fcn_lr": lr, "arch": "fcn32s", "seed": 1}))
    ckpt.save_checkpoint(str(tmp_path), model_state=model.state_dict(),
                         optim_state=opt.state_dict(), epoch=2, iteration=9,
                         best_mean_iu=0.25, is_best=True,
                         upscore_trained=upscore)
    return osp.join(str(tmp_path), "best")


def _fcn32s(seed=0):
    return FCN32s(C, channel_scale=SCALE, device="cpu",
                  generator=torch.Generator().manual_seed(seed))


def test_export_round_trip_read_by_the_jax_import(tmp_path, capsys):
    model = _fcn32s(1)
    (tmp_path / "run").mkdir()
    path = _run_dir(tmp_path / "run", model, upscore=True)
    out = str(tmp_path / "exported")
    tx.main([path, "-o", out, "--fcn_optim", "sgd", "--fcn_lr", "1e-10"])
    line = capsys.readouterr().out.strip()
    assert line == (f"exported {path} -> {out} (epoch 2, iteration 9, "
                    "best_mean_iu 0.2500, 36 tensors; round-trip verified)")
    blob = torch.load(out, weights_only=True)
    assert blob["arch"] == "FCN32s" and "upscore_trained" not in blob
    assert blob["optim_state_dict"] == j_export.reference_optim_state_dict(
        "sgd", 1e-10)
    # the JAX package reads it back to the port's weights
    target = {}
    for k, v in model.state_dict().items():
        name, leaf = k.split(".")
        shape = (v.shape[2:] + v.shape[:2] if name == "seenmask_upscore"
                 else v.shape[2:] + v.shape[1::-1]) if leaf == "weight" \
            else v.shape
        target.setdefault(name, {})["kernel" if leaf == "weight"
                                    else "bias"] = np.zeros(shape,
                                                            np.float32)
    got = j_import.load_reference_checkpoint(out, target)
    assert (got["epoch"], got["iteration"]) == (2, 9)
    assert got["upscore_trained"] is True and got["skipped_keys"] == []
    sd = state_dict_from_jax_params(got["params"])
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    # and the port reloads it bit-equal
    again = ckpt.restore_checkpoint(out)
    for k, v in model.state_dict().items():
        assert torch.equal(again["params"][k], v), k


def test_export_defaults_from_config_yaml(tmp_path):
    (tmp_path / "run").mkdir()
    path = _run_dir(tmp_path / "run", _fcn32s(), optim="adam", lr=1e-5)
    blob = tx.export_checkpoint(path, str(tmp_path / "e1"))
    assert blob["optim_state_dict"] == j_export.reference_optim_state_dict(
        "adam", 1e-5)
    assert tx.read_run_config(str(tmp_path / "run" / "config.yaml")) == {
        "arch": "fcn32s", "fcn_lr": "1.0e-05", "fcn_optim": "adam",
        "seed": "1"}
    # an explicit flag wins over the file; no file means sgd at 1e-10
    blob = tx.export_checkpoint(path, str(tmp_path / "e2"), fcn_lr=3e-4)
    assert blob["optim_state_dict"] == j_export.reference_optim_state_dict(
        "adam", 3e-4)
    (tmp_path / "run" / "config.yaml").unlink()
    blob = tx.export_checkpoint(path, str(tmp_path / "e3"))
    assert blob["optim_state_dict"] == j_export.reference_optim_state_dict(
        "sgd", 1e-10)
    with pytest.raises(FileNotFoundError):
        tx.export_checkpoint(str(tmp_path / "none"), str(tmp_path / "e4"))


def test_export_refuses_fcn8s(tmp_path):
    """The port refuses an FCN-8s checkpoint with the JAX export's message
    for an FCN8s tree."""
    model = FCN8s(C, channel_scale=SCALE, device="cpu")
    ckpt.save_checkpoint(str(tmp_path), model_state=model.state_dict(),
                         optim_state=make_seenmask_optimizer(
                             model, lr=1e-3).state_dict(),
                         epoch=0, iteration=0, best_mean_iu=0.0,
                         is_best=False)
    with pytest.raises(ValueError) as port:
        tx.main([str(tmp_path / "checkpoint"), "-o", str(tmp_path / "e")])
    tree = {"score_pool3": {}, "score_pool4": {}, "conv1_1": {}}
    with pytest.raises(ValueError) as jax_side:
        j_export.reference_state_dict_from_params(tree)
    assert str(port.value) == str(jax_side.value)
    assert "FCN8s trees are not exportable" in str(port.value)
    assert not osp.exists(tmp_path / "e")
