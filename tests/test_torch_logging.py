"""The port's run logger, log buffer and viz vs the JAX package's."""

import dataclasses
import os.path as osp

import numpy as np
import pytest
import torch
import yaml

from zeroshotsemanticsegmentation_tpu import viz as jviz
from zeroshotsemanticsegmentation_tpu.configs import PRESETS as JPRESETS
from zeroshotsemanticsegmentation_tpu.utils import RunLogger as JRunLogger
from zeroshotsemanticsegmentation_tpu_torch import viz as pviz
from zeroshotsemanticsegmentation_tpu_torch.configs import PRESETS
from zeroshotsemanticsegmentation_tpu_torch.train.trainer_fcn import (
    StepLogBuffer)
from zeroshotsemanticsegmentation_tpu_torch.utils import (
    RunLogger, profile_trace)
from zeroshotsemanticsegmentation_tpu_torch.utils.logging import dump_yaml

torch.set_num_threads(1)


def _loggers(tmp_path):
    kw = dict(tensorboard=False, verbose=False)
    return (JRunLogger(str(tmp_path / "jax"), **kw),
            RunLogger(str(tmp_path / "port"), **kw))


@pytest.mark.parametrize("preset,kw", [
    (14, {}),
    (15, dict(load_fcn_path="/runs/x/best")),
    (18, dict(context_classes=59, fcn_lr=1e-10, seenmask_lr=1e16,
              data_echo_max_factor=float("inf"))),
    (1, dict(bucket=(96, 64), channel_scale=0.03125, name_like="a: 'b' \"c\"")),
])
def test_config_yaml_reads_back_as_jax(tmp_path, preset, kw):
    kw = dict(kw)
    extra = kw.pop("name_like", None)
    jcfg = dataclasses.asdict(JPRESETS[preset].replace(**kw))
    pcfg = dataclasses.asdict(PRESETS[preset].replace(**kw))
    if extra is not None:  # a string that needs quoting
        jcfg["load_fcn_path"] = pcfg["load_fcn_path"] = extra
    jlog, plog = _loggers(tmp_path)
    jlog.dump_config(jcfg)
    plog.dump_config(pcfg)
    with open(osp.join(jlog.log_dir, "config.yaml")) as f:
        want = yaml.safe_load(f)
    with open(osp.join(plog.log_dir, "config.yaml")) as f:
        got = yaml.safe_load(f)
    assert got == want
    assert list(got) == list(want)


def test_dump_yaml_refuses_nested_values():
    with pytest.raises(TypeError):
        dump_yaml({"a": {"b": 1}})


def test_csv_rows_equal_jax(tmp_path, rng):
    jlog, plog = _loggers(tmp_path)
    headers = ["epoch", "iteration", "train/loss", "train/mean_iu"]
    for i in range(5):
        row = ([0, i, float(rng.rand()), float(np.float32(rng.rand()))]
               if i != 3 else [0, i, float("nan"), np.float64(0.25)])
        jlog.csv_append("train_log.csv", headers, row)
        plog.csv_append("train_log.csv", headers, row)
    jlog.csv_append("counts.csv", ["a", "b"], ["6", "2"])
    plog.csv_append("counts.csv", ["a", "b"], ["6", "2"])
    jlog.close()
    plog.close()
    for name in ("train_log.csv", "counts.csv"):
        with open(osp.join(jlog.log_dir, name)) as f:
            want = f.read()
        with open(osp.join(plog.log_dir, name)) as f:
            assert f.read() == want
    # a reopened logger appends without a second header
    plog2 = RunLogger(plog.log_dir, tensorboard=False, verbose=False)
    plog2.csv_append("counts.csv", ["a", "b"], ["1", "1"])
    plog2.close()
    with open(osp.join(plog.log_dir, "counts.csv")) as f:
        assert f.read().splitlines() == ["a,b", "6,2", "1,1"]


def test_logger_channels_without_tensorboard(tmp_path, capsys):
    log = RunLogger(str(tmp_path), tensorboard=False, verbose=True)
    assert log.elapsed_seconds >= 0.0
    log.scalar("a/b", 1.0, 0)
    log.scalars("a", ["x", "y"], [1, 2], 0)
    log.image("img", None, 0)
    log.text("t", "v")
    log.stdout("hello")
    log.close()
    assert capsys.readouterr().out == "hello\n"


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    assert osp.getsize(tmp_path / "prof" / "trace.json") > 0


def test_step_log_buffer_reads_back_once_per_flush(monkeypatch):
    emitted = []
    buf = StepLogBuffer(3, lambda meta, aux: emitted.append((meta, aux)))
    reads = []
    real_stack = torch.stack

    def counting_stack(ts, *a, **kw):
        reads.append(len(ts))
        return real_stack(ts, *a, **kw)

    monkeypatch.setattr(torch, "stack", counting_stack)
    auxes = []
    for i in range(7):
        aux = {"loss": torch.tensor(0.1 * i, dtype=torch.float32),
               "hist": torch.arange(9, dtype=torch.int32).reshape(3, 3) + i,
               "score_sum": torch.tensor(-3.5 * i)}
        auxes.append(aux)
        buf.push((0, i), aux)
    assert [m for m, _ in emitted] == [(0, i) for i in range(6)]
    buf.flush()
    assert reads == [3, 3, 1]
    for (meta, got), want in zip(emitted, auxes):
        assert float(got["loss"]) == float(want["loss"])  # fp32 exact
        np.testing.assert_array_equal(got["hist"], want["hist"].numpy())
        assert got["hist"].shape == (3, 3)
        assert float(got["score_sum"]) == float(want["score_sum"])


def test_step_log_buffer_zero_defers_to_flush():
    emitted = []
    buf = StepLogBuffer(0, lambda meta, aux: emitted.append(meta))
    for i in range(40):
        buf.push(i, {"loss": torch.tensor(1.0)})
    assert emitted == []
    buf.flush()
    assert emitted == list(range(40))


def test_viz_equals_jax(rng):
    np.testing.assert_array_equal(pviz.voc_colormap(33),
                                  jviz.segmentation.voc_colormap(33))
    img = rng.randint(0, 255, (23, 31, 3)).astype(np.uint8)
    lt = rng.randint(-1, 21, (23, 31)).astype(np.int32)
    lp = rng.randint(0, 21, (23, 31)).astype(np.int32)
    for over in (None, img):
        np.testing.assert_array_equal(pviz.label2rgb(lt, over, n_labels=21),
                                      jviz.label2rgb(lt, over, n_labels=21))
    for unseen in (None, [1, 13]):
        np.testing.assert_array_equal(
            pviz.visualize_segmentation(lbl_pred=lp, lbl_true=lt, img=img,
                                        n_class=21, unseen=unseen),
            jviz.visualize_segmentation(lbl_pred=lp, lbl_true=lt, img=img,
                                        n_class=21, unseen=unseen))
    st = np.where(lt < 0, -1, (lt % 2)).astype(np.int32)
    np.testing.assert_array_equal(
        pviz.visualize_seenmask(lbl_pred=lp % 2, lbl_true=st, img=img,
                                n_class=2),
        jviz.visualize_seenmask(lbl_pred=lp % 2, lbl_true=st, img=img,
                                n_class=2))
    tiles = [img, img[:10], img[:, :5]]
    np.testing.assert_array_equal(pviz.get_tile_image(tiles),
                                  jviz.get_tile_image(tiles))


def test_save_image_round_trip(tmp_path, rng):
    import PIL.Image
    img = rng.randint(0, 255, (12, 9, 3)).astype(np.uint8)
    pviz.save_image(str(tmp_path / "t.png"), img)
    np.testing.assert_array_equal(
        np.asarray(PIL.Image.open(tmp_path / "t.png")), img)
