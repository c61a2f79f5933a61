"""The port's parity evidence at a small size, on the CPU.

`tests/torch_parity_lockstep.py` at channel_scale 1/16, 64², 2 steps per
stage: the port's own steps beside the JAX package's, held stage by stage
(Adam, SGD, stage 2, eval) to the bars of scripts/parity_evidence.py:55-370,
unchanged. `scripts/torch_parity_evidence.py`: its bf16 study at a tiny
width on the CPU (the kernels' plain versions: the "kernels" and "plain"
runs agree, and the bar reports the launches that did not happen), `bf16`
exiting non-zero without a card, and `render` on fixture JSONs with the
card's line beside every number from the card.
"""

import importlib.util
import json
import os.path as osp
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

_ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, osp.join(_ROOT, "tests"))

import torch_parity_lockstep as lockstep  # noqa: E402

torch.set_num_threads(1)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, osp.join(_ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


evidence = _script("torch_parity_evidence")


@pytest.fixture(scope="module")
def report():
    return lockstep.run_lockstep(scale=1 / 16, size=64, steps=2)


@pytest.mark.parametrize("stage", lockstep.STAGES)
def test_lockstep_stage_holds_the_bars(report, stage):
    r = report[stage]
    lockstep.check(stage, r)
    if stage in ("adam", "sgd"):
        # every trained leaf is recorded, the frozen head's delta is zero
        assert r["delta_rel_l2_per_leaf"]["seenmask_score/kernel"] == 0.0
        assert r["delta_rel_l2_per_leaf"]["fc6/kernel"] < 5e-3
        assert r["worst_rel_l2_param"] and not r[
            "worst_rel_l2_param"].startswith("seenmask")
    if stage == "eval":
        assert r["images"] == 6
        assert set(r["metrics"]) == {"overall", "seen", "unseen"}


def test_lockstep_stage_closure_and_save(tmp_path):
    assert lockstep._closure(["eval"]) == ["adam", "stage2", "eval"]
    assert lockstep._closure(["sgd", "adam"]) == ["adam", "sgd"]
    with pytest.raises(ValueError, match="unknown stage"):
        lockstep._closure(["adamw"])
    path = str(tmp_path / "lockstep.json")
    geo = {"scale": 1.0, "size": 128, "steps": 25}
    lockstep.save({**geo, "sgd": {"x": 1}}, path)
    out = lockstep.save({**geo, "adam": {"y": 2}}, path)
    assert out["sgd"] == {"x": 1} and out["adam"] == {"y": 2}
    # another geometry replaces the file
    out = lockstep.save({**geo, "steps": 2, "eval": {"z": 3}}, path)
    assert "sgd" not in out and out["eval"] == {"z": 3}
    with open(path) as f:
        assert json.load(f) == out


@pytest.mark.parametrize("labels", evidence.LABELS)
def test_bf16_study_on_the_cpu(labels):
    r = evidence.run_bf16(batches=1, batch_size=1, size=64, train_steps=1,
                          log=lambda m: None, labels=labels, device="cpu",
                          channel_scale=1 / 16)
    assert r["pixels"] == 64 * 64 and r["card"] is None
    assert r["labels"] == labels
    assert r["classes_predicted"]["kernels"] == r["classes_predicted"][
        "plain"] >= 1
    # the bf16 heads drift from fp32's, by about bf16's precision
    assert 0 < r["head_rel_l2"]["fcn"] < 0.1
    # on the CPU both bf16 runs take the plain versions
    assert r["flip_rate_kernels"] == r["flip_rate_plain"]
    assert r["flip_rate_kernels_vs_plain"] == 0.0
    for g in ("overall", "seen", "unseen"):
        np.testing.assert_array_equal(r["metrics"][g]["kernels"],
                                      r["metrics"][g]["plain"])
        assert len(r["metrics"][g]["fp32"]) == 4
    assert sum(r["launches"]["train"].values()) == 0
    assert sorted(m.split()[0] for m in r["bar_failures"]) == [
        "K1", "K2", "K3", "K4", "K5", "K6", "fc6", "fc6"]


def test_bf16_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run")
    r = subprocess.run([sys.executable, osp.join(_ROOT, "scripts",
                                                 "torch_parity_evidence.py"),
                        "bf16"], capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "needs an NVIDIA GPU" in r.stderr


CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _bf16_fixture(labels="random"):
    quad = [0.05, 0.048, 0.004, 0.0041]
    metrics = {g: {"kernels": quad, "plain": quad, "fp32": quad,
                   "abs_delta_kernels": [0.0] * 4,
                   "abs_delta_plain": [0.0] * 4}
               for g in ("overall", "seen", "unseen")}
    return {"flip_rate_kernels": 0.0012, "flip_rate_plain": 0.0011,
            "flip_rate_kernels_vs_plain": 0.0004, "flip_ratio": 1.09,
            "pixels": 8388608, "batches": 4, "batch_size": 8, "size": 512,
            "train_steps": 12, "seed": 0, "lr": 1e-4,
            "train_losses": [0.99, 0.8], "metric_order":
            evidence.METRIC_ORDER, "metrics": metrics,
            "launches": {"train": dict.fromkeys(evidence.TRAIN_KEYS, 12),
                         "serve_kernels": dict.fromkeys(evidence.SERVE_KEYS,
                                                        4),
                         "serve_plain": dict.fromkeys(evidence.SERVE_KEYS, 0),
                         "serve_fp32": dict.fromkeys(evidence.SERVE_KEYS, 0)},
            "channel_scale": 1.0, "card": CARD,
            "device": "NVIDIA H100 80GB HBM3", "torch": "2.x", "cuda": "12.x",
            "seconds": 30.0, "bar_failures": [], "labels": labels,
            "classes_predicted": {"kernels": 1, "plain": 1, "fp32": 1},
            "head_rel_l2": {"fcn": 0.004, "seenmask": 0.003}}


def test_render_puts_the_card_beside_card_numbers(tmp_path, report):
    lp = tmp_path / "lockstep.json"
    lp.write_text(json.dumps(report))
    for labels in evidence.LABELS:
        (tmp_path / evidence.json_name(labels)).write_text(
            json.dumps(_bf16_fixture(labels)))
    doc = tmp_path / "doc.md"
    text = evidence.render(str(tmp_path), str(doc))
    assert doc.read_text() == text
    lock, *cards = text.split("## bf16 drift")
    assert "## Full-width fp32 lockstep" in lock and CARD not in lock
    for stage in ("Adam", "SGD", "stage 2", "test_all eval"):
        assert stage in lock
    assert len(cards) == 2 and "coherent labels" in cards[1]
    for card in cards:
        numbered = [ln for ln in card.splitlines()[1:]
                    if re.search(r"\b\d+(\.\d+)?\b", ln)]
        assert len(numbered) >= 10
        for ln in numbered:
            assert CARD in ln, ln
        assert "bar: held" in card
    assert "PARITY_EVIDENCE.md" in text
    # the bar misses are rendered as such
    bad = _bf16_fixture()
    bad["flip_rate_kernels"] = 0.01
    bad["bar_failures"] = evidence.bar_failures(bad)
    assert len(bad["bar_failures"]) == 1
    (tmp_path / "bf16.json").write_text(json.dumps(bad))
    assert "bar: FAILED" in evidence.render(str(tmp_path), str(doc))
