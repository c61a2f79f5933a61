"""The harness on the CPU: its files, its names, its arithmetic, and each
cell driven end to end at a tiny size against the plain reference."""

from __future__ import annotations

import json
import os.path as osp
import re

import pytest

from benchmark import flops, harness, timeline
from benchmark.tests.helpers import run_tiny

SPEC = harness.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_files():
    for w in SPEC["workloads"]:
        cfg = harness.load_json("configs", w["config"])
        mix = harness.load_json("traffic", w["traffic"])
        cell = harness.load_json("workloads", w["name"])
        assert cfg["name"] == w["config"]
        assert osp.isfile(osp.join(harness.BENCH_DIR, "traffic",
                                   mix["driver"] + ".py"))
        assert cell["limits"]
        metrics = harness.cell_spec(w["name"], SPEC)
        assert any(m["name"] == "setup_s" for m in metrics["end_to_end"])
        assert len(metrics["end_to_end"]) >= 2 and metrics["per_layer"]
        for m in metrics["per_layer"]:
            assert callable(harness.load_module("metrics", m["name"]).read)
    for c in SPEC["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"


def test_names_units_and_keys_keep_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
        assert set(m.get("workloads", [])) <= set(CELLS)
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_flops_count_vgg16_as_published():
    # 15.35 GMAC for the 13 convolutions at 224^2 (arXiv:1409.1556);
    # with fc6-fc8 (25088 x 4096 + 4096 x 4096 + 4096 x 1000) 15.47
    convs = flops.vgg16_plain_flops(224, 224) / 2
    assert abs(convs - 15.35e9) / 15.35e9 < 0.005
    fc = 25088 * 4096 + 4096 * 4096 + 4096 * 1000
    assert abs(convs + fc - 15.47e9) / 15.47e9 < 0.005


def test_flops_follow_the_pruned_geometry():
    cfg = harness.load_json("configs", "fcn32s-voc")
    assert flops.head_side(cfg, 512) == 17
    pruned = flops.forward_flops(cfg, 512, 512)
    plain = flops.forward_flops({**cfg, "prune_pad": False}, 512, 512)
    assert pruned < plain
    convs = flops.trunk_convs(cfg, 512, 512)
    assert convs[0][4:] == (514, 514) and convs[1][4:] == (516, 516)


def test_idle_share_takes_the_union_of_overlapping_intervals():
    dev = [("k1", 0, 40), ("copy", 10, 50), ("k2", 45, 60), ("k3", 80, 90)]
    t = timeline.Trace(0, 100, dev, [("aten::mm", 60, 80)])
    assert t.busy_s == pytest.approx(70e-9)  # [0, 60] and [80, 90]
    assert t.kernel_seconds("k")[1] == 3
    assert t.idle_gaps()[0][0] == "aten::mm"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_each_cell_runs_on_the_cpu_and_agrees_with_the_reference(cell,
                                                                 trace):
    out = run_tiny(cell, trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["attempted"] > 0
    metrics = harness.cell_spec(cell, SPEC)
    want = {m["name"] for m in metrics["per_layer" if trace
                                        else "end_to_end"]}
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want
    # fp32 at a tiny width: the program equals the reference to rounding
    for name, c in out["checks"].items():
        assert c["value"] < 1e-4 * c["limit"] or c["value"] < 1e-5, name
    json.dumps(out)
