"""The readers of the trunk's conv + bias + ReLU spans (`model.conv`), at a
tiny size on the CPU: a traced run of each cell that lists them reads the
fused share at 0 (the CPU runs the three ops) and leaves the device-timed
ms out of its line (no CUDA events off the card); the readers count the
spans inside each `model.forward`, whether or not a `serve.request` holds
it, and a program whose spans do not say gives nothing rather than
raising."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.tests.helpers import run_tiny
from zeroshotsemanticsegmentation_tpu_torch.utils import profiling

SHARE, MS = "serve.conv_fused_share", "serve.conv_ms"


def _cells(metric) -> list[str]:
    entry = next(m for m in harness.benchmark_spec()["per_layer"]
                 if m["name"] == metric)
    return sorted(entry["workloads"])


def test_both_readers_list_the_three_fcn_serving_cells():
    assert _cells(SHARE) == _cells(MS) == [
        "fcn32s-voc.serve-b16", "fcn32s-voc.serve-b64-resident",
        "fcn8s-voc.serve-b16"]


@pytest.mark.parametrize("cell", _cells(SHARE))
def test_the_share_reads_0_on_the_cpu_and_the_ms_is_left_out(cell):
    out = run_tiny(cell, trace=True)
    assert out["correct"] is True
    assert out["metrics"][SHARE] == {"value": 0.0, "unit": "%"}
    assert MS not in out["metrics"]


def _span(name, sid, parent, trace, work, device_ms=None):
    s = profiling.Span(name, sid, parent, trace, work, None)
    s.start_ns, s.end_ns = 10, 20
    s.device_ms = device_ms
    return s


def _records(request: bool, fused=(1, 1, 0), device_ms=(1.0, 2.0, 3.0)):
    """Two forwards, the first with three convs and the second with one
    (under a `serve.request` each, or as roots), and a conv outside any
    forward, which the readers leave out."""
    recs, sid = [], 0
    for convs in (3, 1):
        sid += 1
        root = sid
        if request:
            recs.append(_span("serve.request", root, None, root, {}))
            sid += 1
        fwd = sid
        recs.append(_span("model.forward", fwd, root if request else None,
                          root, {}, 10.0))
        for k in range(convs):
            sid += 1
            work = {} if fused is None else {"flops": 8,
                                             "fused": fused[k % 3]}
            recs.append(_span("model.conv", sid, fwd, root, work,
                              device_ms and device_ms[k % 3]))
    recs.append(_span("model.conv", sid + 1, None, sid + 1,
                      {"flops": 8, "fused": 0}, 100.0))
    return recs


def _read(monkeypatch, metric, recs):
    monkeypatch.setattr(profiling, "spans", lambda start, end: recs)
    return harness.load_module("metrics", metric).read(
        SimpleNamespace(start=0, end=100))


@pytest.mark.parametrize("request_span", [True, False])
def test_the_readers_count_the_convs_of_each_forward(monkeypatch,
                                                     request_span):
    recs = _records(request_span)
    # convs 1 + 2 + 3 and 1 ms over two forwards; 3 of the 4 fused
    assert _read(monkeypatch, MS, recs) == pytest.approx(3.5)
    assert _read(monkeypatch, SHARE, recs) == pytest.approx(75.0)


@pytest.mark.parametrize("metric", [MS, SHARE])
def test_a_program_without_the_work_or_the_events_gives_nothing(
        monkeypatch, metric):
    assert _read(monkeypatch, metric, []) is None
    bare = [r for r in _records(True) if r.name != "model.conv"]
    assert _read(monkeypatch, metric, bare) is None
    if metric == SHARE:
        assert _read(monkeypatch, metric, _records(True, fused=None)) is None
    else:
        assert _read(monkeypatch, metric,
                     _records(True, device_ms=None)) is None
