"""The port's measurement programs on the CPU: the chains of
`zeroshotsemanticsegmentation_tpu_torch.bench`,
scripts/torch_bench_trained_gate.py and scripts/torch_bench_seenmask_step.py
against the same chains written with the JAX package's pieces, the report
arithmetic and the refusals without a card.

1/16 width, 64x64, B=2, chains of 2, fp32, dropout off, the same weights on
both sides through the bridge (`models/jax_weights`). The JAX side runs as
its own CPU tests run it (its Pallas kernels in interpret mode). Bars: label
flips < 1e-4 (tests/test_szn_fused.py:36), checksums equal up to those
flips; the train chains' accumulators at rtol 1e-4 and their end
parameters at relative norm < 1e-4; stage 2's gradient sum with its atol
scaled to the gradient's absolute sum (tests/test_torch_stage2.py). The
timings themselves are taken on the card only.
"""

import importlib.util
import json
import os.path as osp
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotsemanticsegmentation_tpu.data.assets import (
    load_class_embeddings as j_embeddings)
from zeroshotsemanticsegmentation_tpu.models import FCN32s as JFCN32s
from zeroshotsemanticsegmentation_tpu.ops.bilinear import (
    upscore_conv_transpose_cropped as j_upscore)
from zeroshotsemanticsegmentation_tpu.ops.metrics import (
    unseen_mask_vector as j_unseen_vec)
from zeroshotsemanticsegmentation_tpu.ops.szn_fused import (
    infer_labels_szn_fused as j_labels)
from zeroshotsemanticsegmentation_tpu.train import (
    make_fcn_optimizer as j_fcn_optimizer)
from zeroshotsemanticsegmentation_tpu.train import (
    make_seenmask_optimizer as j_seenmask_optimizer)
from zeroshotsemanticsegmentation_tpu.train.state import (
    TrainState as JTrainState)
from zeroshotsemanticsegmentation_tpu.train.steps import (
    make_fcn_train_step as j_fcn_step)
from zeroshotsemanticsegmentation_tpu.train.steps import (
    make_seenmask_train_step as j_seenmask_step)
from zeroshotsemanticsegmentation_tpu_torch import bench
from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
from zeroshotsemanticsegmentation_tpu_torch.models.jax_weights import (
    load_jax_params, state_dict_from_jax_params)

torch.set_num_threads(1)

_ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
B, HW, STEPS, SCALE = 2, 64, 2, 1 / 16
FLIP_BAR = 1e-4


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_bench_{name}", osp.join(_ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


trained_gate = _script("torch_bench_trained_gate")
seenmask_step = _script("torch_bench_seenmask_step")


@pytest.fixture(scope="module")
def jax_model():
    """The JAX FCN-32s (20-dim heads, 1/16 width, fp32, dropout off) and
    its parameter tree as numpy, biases non-zero."""
    rng = np.random.RandomState(11)
    jm = JFCN32s(num_classes=bench.EMBED_DIM, channel_scale=SCALE,
                 dropout_rate=0.0)
    params = jax.jit(lambda k, x: jm.init(k, x, mode="both"))(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))["params"]
    tree = jax.tree.map(np.asarray, params)
    for leaves in tree.values():  # non-zero biases: every bias add counts
        if "bias" in leaves:
            leaves["bias"] = (rng.randn(*leaves["bias"].shape)
                              .astype(np.float32) * 0.05)
    return jm, tree


def _port_model(tree):
    """The bench's model (block 1 fused, pruned) in fp32 with dropout off,
    the JAX weights loaded."""
    model = FCN32s(bench.EMBED_DIM, channel_scale=SCALE, dropout_rate=0.0,
                   fused_block1=True, device="cpu")
    return load_jax_params(model, tree)


def _record_labels(monkeypatch):
    """Every label map `bench.label_pristine` returns, in order."""
    seen = []
    real = bench.infer_labels_szn_fused

    def recording(*a, **kw):
        out = real(*a, **kw)
        seen.append(out.numpy().copy())
        return out
    monkeypatch.setattr(bench, "infer_labels_szn_fused", recording)
    return seen


def _jax_serving_chain(jm, tree, label_fn):
    """bench.py's serving chain written with the JAX pieces, unrolled:
    (checksum, each step's labels)."""
    x = jnp.asarray(np.random.RandomState(0).randn(B, HW, HW, 3)
                    .astype(np.float32) * 40)
    acc, labels = 0, []
    for _ in range(STEPS):
        f_raw, s_raw = jm.apply({"params": tree}, x, mode="raw")
        lbl = label_fn(f_raw, s_raw)
        x = x + jnp.mean(lbl.astype(jnp.float32)) * 1e-6
        acc = acc + int(jnp.sum(lbl))
        labels.append(np.asarray(lbl))
    return acc, labels


def _j_embed_unseen():
    return (jnp.asarray(j_embeddings("pascal", bench.EMBED_DIM)),
            jnp.asarray(j_unseen_vec(bench.NUM_CLASSES, list(bench.UNSEEN))))


def _hold_chain(got_acc, got_labels, want_acc, want_labels):
    assert len(got_labels) == len(want_labels) == STEPS
    flipped = 0
    for g, w in zip(got_labels, want_labels):
        assert g.shape == w.shape == (B, HW, HW) and g.dtype == np.int32
        assert (g != w).mean() < FLIP_BAR
        flipped += int(np.abs(g.astype(np.int64) - w).sum())
    # each flipped pixel moves the label sum by at most its label change
    assert abs(int(got_acc) - want_acc) <= flipped
    assert want_acc != 0


def test_serving_chain_matches_jax(jax_model, monkeypatch):
    jm, tree = jax_model
    embed, uv = _j_embed_unseen()
    want_acc, want = _jax_serving_chain(
        jm, tree, lambda f, s: j_labels(f, s, embed, uv, (HW, HW)))
    labels = _record_labels(monkeypatch)
    chain = bench.serving_chain("cpu", B, HW, STEPS,
                                model=_port_model(tree))
    acc = chain.run()
    assert acc.dtype == torch.int64 and acc.device.type == "cpu"
    _hold_chain(acc, labels, want_acc, want)


def test_trained_gate_chain_matches_jax(jax_model):
    """The trained route's labels (the JAX script's `label_trained`,
    bench_trained_gate.py:62-77) on the same perturbed upscore kernel,
    through the same chain; the perturbation drawn in the JAX layout."""
    jm, tree = jax_model
    embed, uv = _j_embed_unseen()
    up = tree["seenmask_upscore"]["kernel"]
    up_trained = jnp.asarray(
        up + 0.01 * np.random.RandomState(1).randn(*up.shape)
        .astype(np.float32))

    def label_trained(f_raw, s_raw):  # bench_trained_gate.py:62-77
        g = j_upscore(s_raw.astype(jnp.float32),
                      up_trained.astype(jnp.float32), stride=32,
                      crop_offset=19, out_h=HW, out_w=HW)
        pixel_unseen = jnp.argmax(g, axis=-1) == 0
        seen_lbl = j_labels(f_raw, jnp.zeros_like(s_raw).at[..., 1].set(1.0),
                            embed, uv, (HW, HW))
        unseen_lbl = j_labels(f_raw,
                              jnp.zeros_like(s_raw).at[..., 0].set(1.0),
                              embed, uv, (HW, HW))
        return jnp.where(pixel_unseen, unseen_lbl, seen_lbl)

    want_acc, want = _jax_serving_chain(jm, tree, label_trained)
    model = _port_model(tree)
    w = trained_gate.perturbed_upscore(model.seenmask_upscore.weight)
    np.testing.assert_array_equal(
        w.permute(2, 3, 0, 1).numpy(), np.asarray(up_trained))
    real = trained_gate.trained_labels(w)
    labels = []

    def recording(*a):
        out = real(*a)
        labels.append(out.numpy().copy())
        return out

    acc = bench.serving_chain("cpu", B, HW, STEPS, model=model,
                              label_fn=recording).run()
    _hold_chain(acc, labels, want_acc, want)


def _jax_train_chain(jm, tree, tx_fn, step_fn, grad_key):
    """bench.py's train chain (bench.py:175-182) unrolled with the JAX
    step: (accumulator, auxes, end parameters as a state dict)."""
    params = jax.tree.map(jnp.asarray, tree)
    tx = tx_fn(params)
    state = JTrainState(params=params, opt_state=tx.init(params),
                        step=jnp.zeros((), jnp.int32))
    step = step_fn(tx)
    data = {k: jnp.asarray(v.numpy())
            for k, v in bench.train_batch(B, HW, "cpu").items()}
    key = jax.random.PRNGKey(0)
    acc, auxes = jnp.zeros((), jnp.float32), []
    for _ in range(STEPS):
        state, aux = step(state, data, key)
        acc = (acc + aux["loss"] + jnp.sum(aux["hist"]).astype(jnp.float32)
               + aux[grad_key] + aux["score_sum"] * 1e-9)
        auxes.append(jax.tree.map(np.asarray, aux))
    return float(acc), auxes, state_dict_from_jax_params(
        jax.tree.map(np.asarray, state.params))


def _recording_step(module, name, auxes):
    real = getattr(module, name)

    def factory(**kw):
        step = real(**kw)

        def recorded(state, batch, generator=None):
            state, aux = step(state, batch, generator)
            auxes.append({k: v.detach().numpy().copy()
                          for k, v in aux.items()})
            return state, aux
        return recorded
    return factory


def _hold_train(model, got, want, want_sd):
    """Each step's loss, histogram and score sum, and the end parameters,
    against the JAX chain's."""
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_array_equal(g["hist"].sum(1), w["hist"].sum(1))
        assert np.abs(g["hist"] - w["hist"]).sum() <= max(
            16, 0.005 * w["hist"].sum())
        np.testing.assert_allclose(g["score_sum"], w["score_sum"],
                                   rtol=1e-4)
    sd = model.state_dict()
    for name, want_p in want_sd.items():
        d = (sd[name].double() - want_p.double()).norm()
        assert d <= 1e-4 * want_p.double().norm(), name


def test_train_chain_matches_jax(jax_model, monkeypatch):
    jm, tree = jax_model
    embed = j_embeddings("pascal", bench.EMBED_DIM)
    want_acc, want, want_sd = _jax_train_chain(
        jm, tree, lambda p: j_fcn_optimizer(p, optim="adam", lr=bench.LR),
        lambda tx: j_fcn_step(jm, tx, loss_name="cos",
                              num_classes=bench.NUM_CLASSES,
                              embeddings=embed),
        "score_fr_grad_sum")
    from zeroshotsemanticsegmentation_tpu_torch import train
    got = []
    monkeypatch.setattr(train, "make_fcn_train_step", _recording_step(
        train, "make_fcn_train_step", got))
    model = _port_model(tree)
    chain = bench.train_chain("cpu", B, HW, STEPS, model=model)
    acc = chain.run()
    assert acc.dtype == torch.float32
    np.testing.assert_allclose(acc.item(), want_acc, rtol=1e-4)
    _hold_train(model, got, want, want_sd)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["score_fr_grad_sum"],
                                   w["score_fr_grad_sum"], rtol=1e-3,
                                   atol=1e-6)


def test_seenmask_chain_matches_jax(jax_model, monkeypatch):
    """The stage-2 chain against the JAX step chain, and its gradient sums
    against the port's own chain in fp64.

    The gradient sum cancels: while the upscore is the bilinear one (the
    first step) the two rows of the head's weight gradient are opposite, so
    their sum is rounding on both sides; after it, the sum (5.3e-4 here) is
    what is left of rows of +-4.6. Each element within the gradient bar
    (relative 1e-4) bounds the sum's error by 1e-4 of the gradient's
    absolute sum, the atol against the JAX chain (whose fp32 sum lay 1.3e-5
    of that scale from the fp64 run's when this test was written); against
    the fp64 run the atol is tests/test_torch_stage2.py's, 1e-6 of it."""
    jm, tree = jax_model
    seen = ~j_unseen_vec(bench.NUM_CLASSES, list(bench.UNSEEN))
    want_acc, want, want_sd = _jax_train_chain(
        jm, tree, lambda p: j_seenmask_optimizer(p, lr=bench.LR),
        lambda tx: j_seenmask_step(jm, tx, seen_vec=seen),
        "seenmask_grad_sum")
    from zeroshotsemanticsegmentation_tpu_torch import train
    got, got64 = [], []
    real = train.make_seenmask_train_step
    monkeypatch.setattr(train, "make_seenmask_train_step", _recording_step(
        train, "make_seenmask_train_step", got))
    model = _port_model(tree)
    chain = seenmask_step.seenmask_chain("cpu", B, HW, STEPS, model=model)
    acc = chain.run()
    scale = model.seenmask_score.weight.grad.abs().sum().item()
    np.testing.assert_allclose(acc.item(), want_acc, rtol=1e-4)
    _hold_train(model, got, want, want_sd)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["seenmask_grad_sum"],
                                   w["seenmask_grad_sum"], rtol=1e-3,
                                   atol=1e-4 * scale)

    monkeypatch.setattr(train, "make_seenmask_train_step", real)
    monkeypatch.setattr(train, "make_seenmask_train_step", _recording_step(
        train, "make_seenmask_train_step", got64))
    m64 = load_jax_params(FCN32s(bench.EMBED_DIM, channel_scale=SCALE,
                                 dropout_rate=0.0, dtype=torch.float64,
                                 device="cpu"), tree).double()
    seenmask_step.seenmask_chain("cpu", B, HW, STEPS, model=m64).run()
    for g, w in zip(got, got64):
        np.testing.assert_allclose(g["seenmask_grad_sum"],
                                   w["seenmask_grad_sum"], rtol=1e-3,
                                   atol=1e-6 * scale)


def test_loop_chain_counts_its_images(tmp_path):
    """One epoch of the loop: every replayed batch a step (the line counts
    steps x B images), the echo factor reported, a finite non-zero
    checksum."""
    batches = 3
    chain = bench.loop_chain("cpu", B, HW, batches, SCALE,
                             log_dir=str(tmp_path))
    try:
        acc = chain.run()
        assert chain.stats["steps"] == batches
        assert chain.stats["echo_factor"] >= 1.0
        assert np.isfinite(acc.item()) and acc.item() != 0
        before = acc.item()
        assert chain.run().item() != before  # the state moved on
        assert chain.stats["steps"] == batches
    finally:
        chain.close()
    rows = (tmp_path / "train_log.csv").read_text().splitlines()
    assert len(rows) == 1 + 2 * batches  # the header, a row a step


def test_report_arithmetic():
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    s = bench.serving_report(2.0, 64, 512, 8, 5.5, card, 123)
    assert s["value"] == pytest.approx(64 * 512 * 512 / 0.25 / 1e6)
    assert s["metric"] == "szn_inference_throughput"
    assert (s["batch"], s["chain"], s["peak_gb"], s["card"]) == (
        64, 8, 5.5, card)
    t = bench.train_report(0.5, 24, 4, 10.3, card, 1.5)
    assert t["value"] == pytest.approx(24 / 0.125)
    assert t["step_ms"] == pytest.approx(125.0)
    assert t["metric"] == "fcn_train_throughput"
    lp = bench.loop_report(3.2, 24, 16, 1.25, 10.4, card, 2.0)
    assert lp["value"] == pytest.approx(16 * 24 / 3.2)
    assert lp["step_ms"] == pytest.approx(200.0)
    assert lp["echo_factor"] == 1.25
    for line in (s, t, lp):
        assert "vs_baseline" not in line and line["card"] == card
        json.dumps(line)


@pytest.mark.parametrize("fn", [
    bench.bench_inference, bench.bench_train, bench.bench_train_loop,
    trained_gate.run, seenmask_step.run],
    ids=["inference", "train", "loop", "trained_gate", "seenmask"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_timed_wrappers_refuse_without_a_card(fn, device, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with mock.patch.object(bench, "time_chain") as timed:
        with pytest.raises(RuntimeError, match="NVIDIA GPU"):
            fn(device)
    timed.assert_not_called()


def test_timed_wrapper_refuses_the_cpu_with_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        bench.bench_train("cpu")


def test_main_refuses_without_a_card(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "OUT_DIR", str(tmp_path / "out"))
    for argv in ([], ["--train"], ["--loop"], ["--all"]):
        with pytest.raises(SystemExit) as e:
            bench.main(argv)
        assert e.value.code not in (0, None)
        assert "needs an NVIDIA GPU" in str(e.value.code)
    assert capsys.readouterr().out == ""
    assert not (tmp_path / "out").exists()
    for mod in (trained_gate, seenmask_step):
        assert mod.main() != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cmd", [
    ["-m", "zeroshotsemanticsegmentation_tpu_torch.bench", "--all"],
    [osp.join("scripts", "torch_bench_trained_gate.py")],
    [osp.join("scripts", "torch_bench_seenmask_step.py")]],
    ids=["bench", "trained_gate", "seenmask"])
def test_programs_exit_nonzero_without_a_card(cmd):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the program would run")
    r = subprocess.run([sys.executable, *cmd], capture_output=True,
                       text=True, timeout=120, cwd=_ROOT)
    assert r.returncode != 0
    assert "needs an NVIDIA GPU" in r.stderr
    assert r.stdout == ""
