#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's stage-1 train step, on one GPU.

    python3 scripts/torch_train_profile.py [--batch 24] [--iters 3]
                                           [--table PATH]

Builds the full-width bf16 FCN-32s with the fused block-1 kernels (seeded
random weights, dropout 0.5 from a seeded CUDA generator) and trains it with
make_fcn_train_step (cos loss, fused tail, Adam lr 1e-5, the bundled pascal
embeddings) on 512x512 images: one warm-up step, then --iters steps under
torch.profiler. Prints the card's name and power limit, the wall time per
step, the summed device-kernel time per step, the device's idle share
(1 - kernel time / wall time), and the kernels by total device time
(user annotations, whose device ranges overlap the kernels, left out).
`--table` writes the profiler's full table to PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import sys
import time

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

H = W = 512


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--table", default=None,
                    help="write the profiler's full table to this file")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zeroshotsemanticsegmentation_tpu_torch.data.assets import (
        load_class_embeddings)
    from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
    from zeroshotsemanticsegmentation_tpu_torch.train import (
        TrainState, make_fcn_optimizer, make_fcn_train_step)

    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _kernels.build()

    dev = torch.device("cuda")
    embed = load_class_embeddings("pascal", 20)
    model = FCN32s(20, dtype=torch.bfloat16, fused_block1=True,
                   generator=torch.Generator().manual_seed(0))
    state = TrainState.create(model, make_fcn_optimizer(model, optim="adam",
                                                        lr=1e-5))
    step = make_fcn_train_step(loss_name="cos", num_classes=embed.shape[0],
                               embeddings=embed)
    rng = np.random.RandomState(0)
    b = args.batch
    batch = {"image": torch.from_numpy(
                 rng.randn(b, H, W, 3).astype(np.float32) * 40).to(dev),
             "label": torch.from_numpy(rng.randint(
                 -1, embed.shape[0], (b, H, W)).astype(np.int32)).to(dev),
             "sizes": torch.full((b, 2), H, dtype=torch.int32, device=dev),
             "num_real": torch.tensor(b, device=dev)}
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = step(state, batch, gen)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            state, aux = step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters

    # device kernels only: a user annotation such as the optimizer's
    # "Optimizer.step#Adam.step" also has a device range, which overlaps the
    # kernels it encloses
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    dev_us = sum(e.self_device_time_total for e in events)
    kern_ms = dev_us / 1e3 / args.iters
    rows = sorted(events, key=lambda e: -e.self_device_time_total)
    if args.table:
        os.makedirs(osp.dirname(osp.abspath(args.table)), exist_ok=True)
        with open(args.table, "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=80))
    top = [{"name": e.key[:90],
            "ms_per_step": e.self_device_time_total / 1e3 / args.iters,
            "calls_per_step": e.count / args.iters} for e in rows[:20]]
    print(json.dumps({"batch": b, "wall_ms_per_step": wall_ms,
                      "device_kernel_ms_per_step": kern_ms,
                      "idle_share": 1 - kern_ms / wall_ms,
                      "images_per_s": b / (wall_ms / 1e3),
                      "loss": aux["loss"].item()}))
    for row in top:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
