"""Tiny cells for the CPU tests: 1/32 of the widths (the port's
`channel_scale`), a 64 x 64 bucket, a tenth of the images' sides, fp32."""

from __future__ import annotations

import time

import torch

from benchmark import harness

TINY = {"channel_scale": 1 / 32, "bucket": [64, 64], "image_scale": 0.1,
        "cfg": {"compute_dtype": "float32"}, "batch_size": 4,
        "batches_per_epoch": 4, "side_range": [40, 64]}
SEED = 2 ** 31 + 4242


def run_tiny(name: str, *, trace: bool = False, seconds: float = 0.5,
             control: str = "", spec: dict | None = None,
             seed: int = SEED) -> dict:
    torch.set_num_threads(2)
    ctx = harness.Context.load(name, seed, "cpu", control=control,
                               overrides=dict(TINY), spec=spec)
    return harness.run_cell(ctx, seconds, trace, time.perf_counter(),
                            harness.cell_spec(name, spec), log=lambda s: None)
