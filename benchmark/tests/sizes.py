"""Tiny sizes of the CPU tests by configuration.

`helpers.TINY` thins a cell through the harness's `channel_scale`
override, which rescales FCN's `vgg` widths. A configuration without them
(DeepLab-v2 ResNet-101) is thinned through its own keys instead:
`TINY_R101`, 1/16 of the widths and blocks (1, 1, 2, 1)."""

from __future__ import annotations

from benchmark import harness

TINY_R101 = {"bucket": [64, 64], "image_scale": 0.1,
             "cfg": {"compute_dtype": "float32", "channel_scale": 1 / 16,
                     "blocks": [1, 1, 2, 1]}}


def thinned_by_its_config(cell: str) -> bool:
    """Whether `cell` (a cell of BENCHMARK.json) is thinned through its
    configuration's keys, not the harness's `channel_scale`."""
    cells = {w["name"]: w for w in harness.benchmark_spec()["workloads"]}
    if cell not in cells:
        return False
    return "vgg" not in harness.load_json("configs", cells[cell]["config"])
