"""The correctness control at each cell's own size, on the card: the
reference in fp8 (each workload file's `control`) in the program's place
must come out not correct on three seeds.

    python -m pytest benchmark/tests/test_bench_control.py -q

Skips without an NVIDIA GPU."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness

CELLS = [w["name"] for w in harness.benchmark_spec()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_comes_out_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's size on an NVIDIA GPU")
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        ctx = harness.Context.load(cell, seed, "cuda:0", control="control")
        out = harness.run_cell(ctx, 4.0, False, time.perf_counter(),
                               harness.cell_spec(cell), log=lambda s: None)
        assert out["correct"] is False, (seed, out["checks"])
        torch.cuda.empty_cache()
