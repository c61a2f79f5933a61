"""The DeepLab-v2 cell and the resident-input cell at a tiny size on the CPU:
both run by name through `run_tiny` and agree with their references, the
DeepLab check catches a planted altered label and each structural fault
planted in the reference (`serve_closed_r101.FAULTS`: on the card too, at
the cell's own size), and the readers of the
DeepLab spans give numbers from a traced run (each span's host time standing
in for its device time, which the CPU has not) and nothing from a program
or driver without what they read."""

from __future__ import annotations

import pytest

import json
import time

import torch

from benchmark import harness, timeline
from benchmark.tests import helpers
from benchmark.tests.helpers import run_tiny
from benchmark.tests.sizes import TINY_R101
from benchmark.traffic.serve_closed_r101 import FAULTS

DEEPLAB = "deeplabv2-r101-voc.serve-b16"
RESIDENT = "fcn32s-voc.serve-b64-resident"
READERS = ("serve.dilated_roofline", "serve.aspp_roofline")


@pytest.fixture
def tiny_r101(monkeypatch):
    monkeypatch.setattr(helpers, "TINY", TINY_R101)


@pytest.mark.parametrize("trace", [False, True])
def test_the_deeplab_cell_runs_and_agrees(tiny_r101, trace):
    out = run_tiny(DEEPLAB, trace=trace)
    assert out["correct"] is True and out["attempted"] > 0
    want = {m["name"] for m in harness.cell_spec(DEEPLAB)[
        "per_layer" if trace else "end_to_end"]}
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want
    for name, c in out["checks"].items():
        assert c["value"] < 1e-4 * c["limit"] or c["value"] < 1e-5, name


@pytest.mark.parametrize("trace", [False, True])
def test_the_resident_cell_runs_and_agrees(trace):
    out = run_tiny(RESIDENT, trace=trace)
    assert out["correct"] is True and out["attempted"] > 0
    if not trace:
        assert set(out["metrics"]) == {"setup_s", "serve_mpix_s",
                                       "serve_p95_ms", "peak_gb"}
    for name, c in out["checks"].items():
        assert c["value"] < 1e-4 * c["limit"] or c["value"] < 1e-5, name


@pytest.mark.parametrize("cell", [DEEPLAB, RESIDENT])
def test_an_altered_answer_fails(cell, monkeypatch):
    from zeroshotsemanticsegmentation_tpu_torch import serving
    fn = serving.infer_labels_szn_fused

    def altered(*a, **k):
        lbl = fn(*a, **k)
        out = lbl.clone()
        out[:, :8, :8] = (lbl[:, :8, :8] + 1) % 21
        return out

    monkeypatch.setattr(serving, "infer_labels_szn_fused", altered)
    assert run_tiny(cell)["correct"] is False


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_structural_fault_fails(tiny_r101, fault):
    out = run_tiny(DEEPLAB, control=fault)
    assert out["correct"] is False, out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_structural_fault_fails_at_the_cells_size(fault):
    """Each planted fault at the published widths on the card, on three
    seeds; the readings are printed (`-rA` shows them)."""
    if not torch.cuda.is_available():
        pytest.skip("the cell's size runs on an NVIDIA GPU")
    for seed in (2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23):
        ctx = harness.Context.load(DEEPLAB, seed, "cuda:0", control=fault)
        out = harness.run_cell(ctx, 2.0, False, time.perf_counter(),
                               harness.cell_spec(DEEPLAB), log=lambda s: None)
        print(json.dumps({"fault": fault, "seed": seed,
                          "checks": out["checks"]}))
        assert out["correct"] is False, (seed, out["checks"])
        torch.cuda.empty_cache()


def test_the_span_readers_give_numbers(tiny_r101, monkeypatch):
    from zeroshotsemanticsegmentation_tpu_torch.utils import profiling
    spans = profiling.spans

    def host_timed(start, end):
        out = spans(start, end)
        for r in out:
            if r.device_ms is None:
                r.device_ms = r.host_ms
        return out

    monkeypatch.setattr(profiling, "spans", host_timed)
    out = run_tiny(DEEPLAB, trace=True)
    for name in READERS:
        value = out["metrics"][name]["value"]
        assert isinstance(value, float) and value > 0, name


def test_the_span_readers_give_nothing_without_their_inputs():
    t = timeline.Trace(0, 10, [("k", 0, 5)], [], {"requests": 1})
    for name in READERS:
        assert harness.load_module("metrics", name).read(t) is None
