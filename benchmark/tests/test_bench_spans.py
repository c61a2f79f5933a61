"""The readers of the program's spans, at a tiny size on the CPU: the
host-timed metrics come out as numbers in a traced run, the device-timed
ones (no CUDA events off the card) are left out of its line."""

from __future__ import annotations

import pytest

from benchmark.tests.helpers import run_tiny

HOST_TIMED = {"fcn32s-voc.serve-b16": ("serve.host_ms", "serve.pixel_yield"),
              "fcn32s-voc.train-s1-b24": ("train.feed_wait_ms",)}
DEVICE_TIMED = ("serve.fc6_roofline", "serve.ringpad_ms")


@pytest.mark.parametrize("cell", sorted(HOST_TIMED))
def test_span_metrics_come_out_of_a_traced_run(cell):
    out = run_tiny(cell, trace=True)
    assert out["correct"] is True
    for name in HOST_TIMED[cell]:
        value = out["metrics"][name]["value"]
        assert isinstance(value, float) and value >= 0, name
    if "serve.pixel_yield" in HOST_TIMED[cell]:
        assert 0 < out["metrics"]["serve.pixel_yield"]["value"] <= 100
    for name in DEVICE_TIMED:
        assert name not in out["metrics"]
