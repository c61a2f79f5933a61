#!/usr/bin/env python3
"""The stage-2 (seenmask) train step's time on one NVIDIA GPU.

    python3 scripts/torch_bench_seenmask_step.py

The port's counterpart of scripts/experiments/bench_seenmask_step.py:
`make_seenmask_train_step` (the seenmask head and its full-resolution
ConvTranspose trained on the frozen bf16 trunk, block 1 through K2) with
`make_seenmask_optimizer` at lr 1e-5, B=24, 512x512, a chain of 8 steps
on bench.py's batch, resident on the card, every step's outputs folded
into an on-device checksum; one warm run, then one timed run under
`torch.cuda.set_sync_debug_mode("error")` ending in one scalar fetch
(`bench.time_chain`). Prints one JSON line with the card's name and power
limit. Needs a card: exits non-zero without one.
"""

from __future__ import annotations

import json
import os.path as osp
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BATCH = 24
H = W = 512
CHAIN = 8


def seenmask_chain(device="cuda", batch: int = BATCH, hw: int = H,
                   chain: int = CHAIN, channel_scale: float = 1.0, *,
                   model=None):
    """`bench.Chain` of the stage-2 step: seen classes all but [1, 13] of
    pascal's 21, Adam at lr 1e-5; `model` replaces the seeded one
    (`bench.seeded_model(device, channel_scale)`)."""
    from zeroshotsemanticsegmentation_tpu_torch import bench, resolve_device
    from zeroshotsemanticsegmentation_tpu_torch.ops.metrics import (
        unseen_mask_vector)
    from zeroshotsemanticsegmentation_tpu_torch.train import (
        TrainState, make_seenmask_optimizer, make_seenmask_train_step)
    dev = resolve_device(device)
    if model is None:
        model = bench.seeded_model(dev, channel_scale)
    state = TrainState.create(model, make_seenmask_optimizer(model,
                                                             lr=bench.LR))
    step = make_seenmask_train_step(
        seen_vec=~unseen_mask_vector(bench.NUM_CLASSES, bench.UNSEEN))
    run = bench.step_chain(step, state, bench.train_batch(batch, hw, dev),
                           chain, "seenmask_grad_sum")
    return bench.Chain(run, {})


def run(device="cuda", batch: int = BATCH, hw: int = H,
        chain: int = CHAIN) -> dict:
    """The timed stage-2 chain on the card: the line this script prints."""
    from zeroshotsemanticsegmentation_tpu_torch import bench
    dev = bench.require_card(device)
    card = bench.card_line(dev)
    t = bench.time_chain(seenmask_chain(dev, batch, hw, chain))
    dt = t["seconds"] / chain
    return {"metric": "seenmask_train_step", "step_ms": dt * 1e3,
            "img_per_s": batch / dt, "batch": batch, "chain": chain,
            "peak_gb": t["peak_gb"], "checksum": t["checksum"],
            "card": card}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_bench_seenmask_step.py needs an NVIDIA GPU "
              "(torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
