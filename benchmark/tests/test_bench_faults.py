"""The check catches a broken timed path: each fault a cell can have is
planted in the port underneath an otherwise whole run (the harness's look
for a card skipped, the CPU at a tiny size), and `correct` comes out
false. One chip: no exchange between chips to leave out."""

from __future__ import annotations

import pytest
import torch

from benchmark.tests.helpers import run_tiny

SERVE = ["fcn32s-voc.serve-b16", "fcn8s-voc.serve-b16"]
TRAIN = ["fcn32s-voc.train-s1-b24", "fcn32s-voc.train-s2-b24"]


def _label_fn(cell):
    from zeroshotsemanticsegmentation_tpu_torch import serving
    name = ("infer_labels_szn_fused" if cell.startswith("fcn32s")
            else "infer_labels_szn")
    return serving, name, getattr(serving, name)


@pytest.mark.parametrize("cell", SERVE)
def test_an_altered_answer_fails(cell, monkeypatch):
    mod, name, fn = _label_fn(cell)

    def altered(*a, **k):
        lbl = fn(*a, **k)
        out = lbl.clone()
        out[:, :8, :8] = (lbl[:, :8, :8] + 1) % 21
        return out

    monkeypatch.setattr(mod, name, altered)
    assert run_tiny(cell)["correct"] is False


@pytest.mark.parametrize("cell", SERVE)
def test_half_of_the_batch_left_out_fails(cell, monkeypatch):
    mod, name, fn = _label_fn(cell)

    def half(*a, **k):
        half_args = [x[: x.shape[0] // 2] if torch.is_tensor(x)
                     and x.dim() == 4 else x for x in a]
        lbl = fn(*half_args, **k)
        return torch.cat([lbl, lbl])  # the rest copied, not computed

    monkeypatch.setattr(mod, name, half)
    assert run_tiny(cell)["correct"] is False


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_fails(cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    out = run_tiny(cell)
    assert out["correct"] is False
    assert out["checks"]["delta_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_the_batch_left_out_of_a_step_fails(cell, monkeypatch):
    from zeroshotsemanticsegmentation_tpu_torch.train import steps
    rows = steps._local_rows

    def half(model, batch, mesh, chunks=1):
        b = rows(model, batch, mesh, chunks)
        n = b["image"].shape[0] // 2
        return {**{k: b[k][:n] for k in ("image", "label", "sizes")},
                "num_real": n}

    monkeypatch.setattr(steps, "_local_rows", half)
    assert run_tiny(cell)["correct"] is False
