"""A later cell, mix and metric come as new files and new entries of
`BENCHMARK.json`, with no file of the harness edited: a throwaway cell
added to a copy of the benchmark's data is found and run by name."""

from __future__ import annotations

import json
import shutil

from benchmark import harness
from benchmark.tests.helpers import run_tiny

READER = '''"""serve.tiny_requests: requests in the traced window."""


def read(t):
    return float(t.work["requests"])
'''


def test_a_throwaway_cell_is_loaded_by_name(tmp_path, monkeypatch):
    copy = tmp_path / "benchmark"
    for kind in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(f"{harness.BENCH_DIR}/{kind}", copy / kind)
    (copy / "traffic" / "tiny_b2.json").write_text(json.dumps(
        {**harness.load_json("traffic", "voc_b16"), "batch_size": 2,
         "distinct_requests": 2, "check_requests": 1}))
    (copy / "workloads" / "fcn32s-voc.tiny.json").write_text(json.dumps(
        {"control": "fp8", "limits": {"label_gap": 0.25, "class_gap": 0.03}}))
    (copy / "metrics" / "serve.tiny_requests.py").write_text(READER)
    spec = harness.benchmark_spec()
    spec["workloads"].append({"name": "fcn32s-voc.tiny",
                              "config": "fcn32s-voc", "traffic": "tiny_b2",
                              "chips": 1, "why": "a test's cell"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "fcn32s-voc.serve-b16" in m["workloads"]:
            m["workloads"].append("fcn32s-voc.tiny")
    spec["per_layer"].append({"name": "serve.tiny_requests", "unit": "req",
                              "better": "higher", "source": "program_counter",
                              "layer": "entries", "moves": "serve_mpix_s",
                              "workloads": ["fcn32s-voc.tiny"]})
    monkeypatch.setattr(harness, "BENCH_DIR", str(copy))
    out = run_tiny("fcn32s-voc.tiny", trace=True, spec=spec)
    assert out["correct"] is True
    assert out["metrics"]["serve.tiny_requests"]["value"] == out["attempted"]
    out = run_tiny("fcn32s-voc.tiny", spec=spec)
    assert {"serve_mpix_s", "serve_p95_ms", "setup_s", "peak_gb"} == set(
        out["metrics"])
