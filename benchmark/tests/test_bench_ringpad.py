"""The reader of the ring pads' kernel share, at a tiny size on the CPU: a
traced run of each cell that lists it reads 0 (the CPU runs the pads' plain
version), and a program whose `model.ringpad` spans carry no `kernel` work
gives nothing rather than raising."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.tests.helpers import run_tiny
from zeroshotsemanticsegmentation_tpu_torch.utils import profiling

METRIC = "serve.ringpad_kernel_share"


def _cells() -> list[str]:
    entry = next(m for m in harness.benchmark_spec()["per_layer"]
                 if m["name"] == METRIC)
    return sorted(entry["workloads"])


@pytest.mark.parametrize("cell", _cells())
def test_the_share_reads_0_on_the_cpu(cell):
    out = run_tiny(cell, trace=True)
    assert out["correct"] is True
    assert out["metrics"][METRIC] == {"value": 0.0, "unit": "%"}


def _span(name, sid, parent, trace, work):
    s = profiling.Span(name, sid, parent, trace, work, None)
    s.start_ns, s.end_ns = 10, 20
    return s


@pytest.mark.parametrize("work, expected", [
    ({}, None), ({"kernel": 1}, 100.0), ({"kernel": 0}, 0.0)])
def test_the_reader_needs_the_kernel_work(monkeypatch, work, expected):
    recs = [_span("serve.request", 1, None, 1, {}),
            _span("model.ringpad", 2, 1, 1, dict(work)),
            _span("model.ringpad", 3, 1, 1, dict(work))]
    monkeypatch.setattr(profiling, "spans", lambda start, end: recs)
    reader = harness.load_module("metrics", METRIC)
    assert reader.read(SimpleNamespace(start=0, end=100)) == expected
