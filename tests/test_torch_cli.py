"""The port's train CLI: the flag -> Config mapping, a synthetic two-stage
run on the CPU against the JAX CLI's run of the same command, and the
refusal to run without a card unless asked for the CPU."""

import csv
import math
import os
import os.path as osp

import pytest
import torch
import yaml

import zeroshotsemanticsegmentation_tpu.cli.train as jcli
import zeroshotsemanticsegmentation_tpu_torch.cli.train as cli
from zeroshotsemanticsegmentation_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

ARGV = ["-c", "14", "-ve", "1", "-se", "1", "--synthetic", "--bucket", "64",
        "--channel_scale", "0.03125"]


def _capture_run(monkeypatch, module):
    captured = {}

    def fake_run(cfg, **kw):
        captured["cfg"] = cfg
        captured.update(kw)
        return {"log_dir": "x"}

    monkeypatch.setattr(module, "run_experiment", fake_run)
    return captured


def test_cli_overrides_map_to_config(monkeypatch):
    argv = ["-c", "14", "-ve", "3", "-lr", "0.01", "-loss", "mse",
            "-o", "sgd", "-se", "2", "-slr", "0.5", "-tu", "2,3",
            "-vu", "4", "-oh", "-fu", "--batch_size", "4",
            "--eval_batch_size", "4", "--dtype", "float32",
            "--arch", "fcn8s", "--synthetic", "-e", "21",
            "--bucket", "96", "--channel_scale", "0.5", "--no_prune_pad",
            "--chunked_loss", "--grad_accum", "2", "--data_echo", "auto",
            "-n", "run", "-tb", "/tb", "--vgg16", "/v.pth"]
    got = _capture_run(monkeypatch, cli)
    want = _capture_run(monkeypatch, jcli)
    cli.main(argv + ["--device", "cpu"])
    jcli.main(argv)
    assert got["cfg"].__dict__ == want["cfg"].__dict__
    for k in ("preset", "name", "data_dir", "tb_dir", "synthetic",
              "vgg16_path", "resume"):
        assert got[k] == want[k], k
    assert got["device"] == "cpu" and got.get("mesh") is None
    cfg = got["cfg"]
    assert cfg.fcn_epochs == 3 and cfg.fcn_lr == 0.01
    assert cfg.train_unseen == (2, 3) and cfg.bucket == (96, 96)
    assert cfg.prune_pad is False and cfg.grad_accum == 2


def test_cli_resume_and_device_flags(monkeypatch):
    got = _capture_run(monkeypatch, cli)
    cli.main(["-c", "4", "-r", "/some/ckpt"])
    assert got["resume"] == "/some/ckpt"
    assert got["cfg"].load_fcn_path == "/some/ckpt"
    assert got["device"] == "cuda"  # the card unless asked otherwise


@pytest.mark.parametrize("argv,exc", [
    (["-c", "99"], SystemExit),
    # a mesh run is one process per rank: without torchrun's RANK /
    # WORLD_SIZE it refuses to start
    (ARGV + ["--data_parallel", "2", "--batch_size", "2",
             "--eval_batch_size", "2"], RuntimeError),
])
def test_cli_refusals(argv, exc):
    with pytest.raises(exc):
        cli.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("kw,match", [
    (dict(data_parallel=2, batch_size=2, eval_batch_size=2), "2 processes")])
def test_run_experiment_refuses_unported_options(tmp_path, kw, match):
    """A 2-rank config without its mesh (one process) is refused."""
    from zeroshotsemanticsegmentation_tpu_torch.configs import get_config
    with pytest.raises(ValueError, match=match):
        cli.run_experiment(get_config(14, **kw), data_dir=str(tmp_path),
                           synthetic=True, device="cpu")


def test_remat_trains_and_resumes(tmp_path):
    """`--remat` (rematerialized conv blocks) trains both stages and
    resumes. On the CPU its gradients are bit-equal to the plain run's, so
    the two runs log the same losses and metrics; the resume continues
    from the remat run's checkpoint."""
    logs = {}
    for tag, extra in (("plain", []), ("remat", ["--remat"])):
        out = cli.main(ARGV + extra + ["--device", "cpu",
                                       "-dir", str(tmp_path / tag)])
        logs[tag] = out["log_dir"]
    with open(osp.join(logs["remat"], "config.yaml")) as f:
        assert yaml.safe_load(f)["remat"] is True
    for name in ("train_log.csv", "val_log.csv", "seenmask_train_log.csv"):
        got = [r[:-1] for r in _rows(osp.join(logs["remat"], name))]
        want = [r[:-1] for r in _rows(osp.join(logs["plain"], name))]
        assert len(got) > 1 and got == want, name  # all but the time
    first = ckpt.restore_checkpoint(osp.join(logs["remat"], "checkpoint"))
    out = cli.main(ARGV + ["--remat", "--device", "cpu", "-ve", "2",
                           "-se", "0", "-dir", str(tmp_path / "resume"),
                           "-r", osp.join(logs["remat"], "checkpoint")])
    rows = _rows(osp.join(out["log_dir"], "train_log.csv"))
    assert len(rows) > 1 and {r[0] for r in rows[1:]} == {"1"}
    end = ckpt.restore_checkpoint(osp.join(out["log_dir"], "checkpoint"))
    assert end["epoch"] == 1 and end["iteration"] > first["iteration"]


def test_viz_without_pillow_raises_before_training(tmp_path, monkeypatch):
    import importlib.util
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "PIL"
                        else real(name, *a))
    with pytest.raises(RuntimeError, match="Pillow"):
        cli.main(ARGV + ["--device", "cpu", "-dir", str(tmp_path)])
    assert not osp.exists(tmp_path / "logs")


def test_cli_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(ARGV + ["-dir", str(tmp_path)])
    assert not osp.exists(tmp_path / "logs")  # raised before any file


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("arch", ["fcn32s", "fcn8s"])
def test_cli_synthetic_run_writes_what_the_jax_cli_writes(tmp_path, arch):
    argv = ARGV + ["--arch", arch]
    out = cli.main(argv + ["--device", "cpu", "-dir", str(tmp_path / "p")])
    want = jcli.main(argv + ["-dir", str(tmp_path / "j")])
    pdir, jdir = out["log_dir"], want["log_dir"]
    assert osp.basename(pdir)[:-len("TIME_20260102-030405_")] == \
        osp.basename(jdir)[:-len("TIME_20260102-030405_")]
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    for name in ("config.yaml", "counts.csv", "train_log.csv",
                 "val_log.csv", "checkpoint", "best"):
        assert osp.exists(osp.join(pdir, name)), name
    for name in ("counts.csv", "train_log.csv", "val_log.csv",
                 "seenmask_train_log.csv", "seenmask_val_log.csv"):
        got, exp = _rows(osp.join(pdir, name)), _rows(osp.join(jdir, name))
        assert len(got) == len(exp) and got[0] == exp[0], name
    assert _rows(osp.join(pdir, "counts.csv")) == \
        _rows(osp.join(jdir, "counts.csv"))
    with open(osp.join(pdir, "config.yaml")) as f, \
            open(osp.join(jdir, "config.yaml")) as g:
        assert yaml.safe_load(f) == yaml.safe_load(g)
    assert ckpt.checkpoint_exists(osp.join(pdir, "best"))
    saved = ckpt.restore_checkpoint(osp.join(pdir, "checkpoint"))
    # stage 2 trains FCN-32s's seenmask upscore; FCN-8s has none
    assert saved["upscore_trained"] is (arch == "fcn32s")
    assert saved["arch"] == {"fcn32s": "FCN32s", "fcn8s": "FCN8s"}[arch]
    assert ("score_pool3.weight" in saved["params"]) is (arch == "fcn8s")
    for summary in (out, want):
        assert sorted(summary) == ["best_mean_iu", "log_dir",
                                   "seenmask_best_mean_iu"]
    assert all(math.isfinite(float(r[2]))
               for r in _rows(osp.join(pdir, "train_log.csv"))[1:])
