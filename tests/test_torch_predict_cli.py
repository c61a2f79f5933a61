"""The port's predict CLI (cli/predict.py) vs the JAX package's, on the CPU.

`run_predict` on PNG fixtures (sizes below the bucket, a tail batch) from a
port checkpoint (stage 2 trained the seenmask upscore: the exact-gate route)
and from a reference file written by the JAX package, against the JAX
`run_predict` on the same file: the label PNGs byte-equal in fp32. Then
`--arch fcn8s` (the unfused route), `--int8` (flip rate <= 1e-2 against the
JAX int8 CLI, see its test), the oversized-image refusal, the flags and the
array batching on its own.
"""

import os.path as osp

import numpy as np
import PIL.Image
import pytest
import torch

from zeroshotsemanticsegmentation_tpu import configs as jconfigs
from zeroshotsemanticsegmentation_tpu.cli.predict import (
    run_predict as j_run_predict)
from zeroshotsemanticsegmentation_tpu_torch.cli import predict as tp
from zeroshotsemanticsegmentation_tpu_torch.cli.train import run_experiment
from zeroshotsemanticsegmentation_tpu_torch.configs import Config

torch.set_num_threads(1)

CFG = dict(mode="train", dataset="pascal", embed_dim=20, fcn_epochs=1,
           fcn_lr=1e-3, fcn_loss="cos", fcn_optim="adam", seenmask_epochs=1,
           seenmask_lr=1e-2, train_unseen=(1, 13), val_unseen=(6, 7),
           batch_size=2, eval_batch_size=2, bucket=(64, 64),
           compute_dtype="float32", channel_scale=1 / 32, num_viz=0)
SIZES = [(40, 64), (64, 48), (64, 64)]


def _write_images(d, sizes):
    d.mkdir(exist_ok=True)
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate(sizes):
        PIL.Image.fromarray(rng.randint(0, 255, (h, w, 3)).astype(
            np.uint8)).save(d / f"img{i}.png")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A port FCN-32s and FCN-8s run (one stage-1 and one stage-2 epoch
    each) and PNG fixtures."""
    tmp = tmp_path_factory.mktemp("predict")
    out = {}
    for arch in ("fcn32s", "fcn8s"):
        r = run_experiment(Config(**CFG, arch=arch), data_dir=str(tmp),
                           log_dir=str(tmp / arch), synthetic=True,
                           verbose=False, device="cpu")
        out[arch] = osp.join(r["log_dir"], "checkpoint")
    _write_images(tmp / "imgs", SIZES)
    return tmp, out


def _labels(paths):
    return [np.asarray(PIL.Image.open(p)) for p in paths]


def _both(tmp, checkpoint, name, **kw):
    """(port written paths, JAX written paths) of one predict command."""
    got = tp.run_predict(Config(**CFG, **kw.pop("cfg", {})),
                         checkpoint=checkpoint, images=str(tmp / "imgs"),
                         out_dir=str(tmp / f"p_{name}"), batch_size=2,
                         verbose=False, device="cpu", **kw)
    want = j_run_predict(jconfigs.Config(**CFG), checkpoint=checkpoint,
                         images=str(tmp / "imgs"),
                         out_dir=str(tmp / f"j_{name}"), batch_size=2,
                         verbose=False, **kw)
    assert [osp.basename(p) for p in got] == [osp.basename(p) for p in want]
    return got, want


def test_run_predict_from_a_port_checkpoint_matches_jax(runs):
    tmp, ckpts = runs
    got, want = _both(tmp, ckpts["fcn32s"], "port", viz=True)
    assert len(got) == 6  # 3 label PNGs + 3 overlays
    for g, w in zip(got, want):
        with open(g, "rb") as f, open(w, "rb") as h:
            assert f.read() == h.read(), osp.basename(g)
    for lb, (h, w) in zip(_labels(got[::2]), SIZES):
        assert lb.shape == (h, w) and lb.max() < 21


def test_run_predict_from_a_reference_file_matches_jax(runs, tmp_path):
    """A reference file written by the JAX package (drifted seenmask
    upscore), read by both CLIs."""
    from test_ref_import import init_params, save_reference_checkpoint
    tmp, _ = runs
    _, params = init_params(0, drift_upscore=True, scale=1 / 32, n=20)
    ref = str(tmp_path / "ref_best")
    save_reference_checkpoint(ref, params)
    got, want = _both(tmp, ref, "ref")
    assert _labels(got) and all(
        np.array_equal(g, w) for g, w in zip(_labels(got), _labels(want)))
    _, _, trained = tp.build_predictor(Config(**CFG), ref, device="cpu")
    assert trained is True


def test_run_predict_int8_matches_jax(runs):
    """--int8 against the JAX CLI's --int8. The port's int8 forward equals
    the JAX one run op by op (tests/test_torch_quantized.py); the JAX CLI
    runs it under jit, where XLA keeps the bf16 quantise arithmetic in fp32
    inside its fusions, so a few activations round to other int8 values.
    Bar: 1e-2 of the labels, well inside the JAX int8-vs-fp bar of 0.08;
    and the port's int8 labels are its int8 predictor's, padded and
    cropped."""
    tmp, ckpts = runs
    got, want = _both(tmp, ckpts["fcn32s"], "int8", int8=True)
    g, w = np.concatenate([x.ravel() for x in _labels(got)]), \
        np.concatenate([x.ravel() for x in _labels(want)])
    assert (g != w).mean() <= 1e-2
    predict, _, _ = tp.build_predictor(Config(**CFG), ckpts["fcn32s"],
                                       int8=True, device="cpu")
    imgs = [np.asarray(PIL.Image.open(f)) for f in sorted(
        (tmp / "imgs").iterdir())]
    direct = tp.predict_arrays(predict, imgs, bucket=(64, 64), batch_size=2)
    for lb, d in zip(_labels(got), direct):
        np.testing.assert_array_equal(lb, d)


def test_run_predict_fcn8s(runs):
    """--arch fcn8s: the unfused route from an FCN-8s checkpoint; its labels
    equal the predictor's on each image padded to the bucket and cropped."""
    tmp, ckpts = runs
    cfg = Config(**CFG, arch="fcn8s")
    written = tp.run_predict(cfg, checkpoint=ckpts["fcn8s"],
                             images=str(tmp / "imgs"),
                             out_dir=str(tmp / "p8"), batch_size=2,
                             verbose=False, device="cpu")
    predict, names, trained = tp.build_predictor(cfg, ckpts["fcn8s"],
                                                 device="cpu")
    assert trained is False and len(names) == 21
    for (h, w), lb, f in zip(SIZES, _labels(written), sorted(
            (tmp / "imgs").iterdir())):
        img = np.zeros((1, 64, 64, 3), np.uint8)
        img[0, :h, :w] = np.asarray(PIL.Image.open(f))
        want = predict(torch.from_numpy(img))[0, :h, :w].numpy()
        assert lb.shape == (h, w)
        np.testing.assert_array_equal(lb, want)


def test_main_flags_match_the_jax_cli(monkeypatch):
    """The flags map to the same config and call as the JAX CLI's;
    --device (default cuda) is the port's own."""
    import zeroshotsemanticsegmentation_tpu.cli.predict as jp
    calls = {}
    for name, mod in (("port", tp), ("jax", jp)):
        monkeypatch.setattr(mod, "run_predict", lambda cfg, name=name, **kw:
                            calls.__setitem__(name, (cfg, kw)) or [])
    argv = ["-c", "14", "--checkpoint", "ck", "--images", "im", "--out",
            "o", "--batch_size", "3", "--bucket", "96", "--arch", "fcn8s",
            "--viz", "--int8"]
    tp.main(argv)
    jp.main(argv)
    (cfg, kw), (jcfg, jkw) = calls["port"], calls["jax"]
    assert cfg.__dict__ == jcfg.__dict__
    assert kw.pop("device") == "cuda" and kw == jkw
    tp.main(argv + ["--device", "cpu"])
    assert calls["port"][1]["device"] == "cpu"


def test_run_predict_refuses_an_oversized_image(runs, tmp_path):
    _, ckpts = runs
    _write_images(tmp_path / "big", [(100, 64)])
    with pytest.raises(ValueError, match="bucket"):
        tp.run_predict(Config(**CFG), checkpoint=ckpts["fcn32s"],
                       images=str(tmp_path / "big"),
                       out_dir=str(tmp_path / "o"), verbose=False,
                       device="cpu")


def test_orbax_directories_are_not_read(tmp_path):
    with pytest.raises(FileNotFoundError, match="orbax"):
        tp.build_predictor(Config(**CFG), str(tmp_path), device="cpu")


def test_predict_arrays_pads_batches_and_crops(runs):
    """The batching on arrays: every batch at the static (batch, bucket)
    shape, images bottom/right zero-padded, the tail filled with zero
    images, labels cropped back; equal to the predictor's own labels."""
    _, ckpts = runs
    predict, _, _ = tp.build_predictor(Config(**CFG), ckpts["fcn32s"],
                                       device="cpu")
    rng = np.random.RandomState(2)
    sizes = [(40, 64), (64, 48), (17, 23), (64, 64), (33, 50)]
    imgs = [rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
            for h, w in sizes]
    batches = []

    def spy(x):
        batches.append(x.clone())
        return predict(x)

    got = tp.predict_arrays(spy, imgs, bucket=(64, 64), batch_size=2)
    assert [tuple(b.shape) for b in batches] == [(2, 64, 64, 3)] * 3
    assert not batches[-1][1].any()  # the tail's filler image
    for i, (img, lb) in enumerate(zip(imgs, got)):
        h, w = img.shape[:2]
        b = batches[i // 2][i % 2].numpy()
        np.testing.assert_array_equal(b[:h, :w], img)
        assert not b[h:].any() and not b[:, w:].any()
        assert lb.shape == (h, w) and lb.dtype == np.int32
        want = predict(torch.from_numpy(b[None]))[0, :h, :w].numpy()
        np.testing.assert_array_equal(lb, want)
    with pytest.raises(ValueError, match="bucket"):
        tp.predict_arrays(spy, [np.zeros((65, 10, 3), np.uint8)],
                          bucket=(64, 64), batch_size=2, names=["big.png"])
