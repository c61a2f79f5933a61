#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's SZN serving, on one GPU.

    python3 scripts/torch_serving_profile.py [--batch 64] [--iters 3]
                                             [--table PATH]

Builds the full-width bf16 FCN-32s with the fused block-1 kernel (seeded
random weights), serves --iters batches of 512x512 float32 images through
make_szn_predictor under torch.profiler after one warm-up batch, and prints:
the card's name and power limit, the wall time per batch, the summed
device-kernel time per batch, the device's idle share
(1 - kernel time / wall time), and the kernels by total device time.
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--table", default=None,
                    help="write the profiler's full table to this file")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from zeroshotsemanticsegmentation_tpu_torch.data.assets import (
        load_class_embeddings)
    from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
    from zeroshotsemanticsegmentation_tpu_torch.serving import (
        make_szn_predictor)

    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _kernels.build()

    model = FCN32s(20, dtype=torch.bfloat16, fused_block1=True,
                   generator=torch.Generator().manual_seed(0))
    serve = make_szn_predictor(model, None,
                               load_class_embeddings("pascal", 20), [1, 13])
    x = torch.randn(args.batch, 512, 512, 3, device="cuda") * 60
    serve(x)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            serve(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters

    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total for e in events)
    kern_ms = dev_us / 1e3 / args.iters
    rows = sorted(events, key=lambda e: -e.self_device_time_total)
    if args.table:
        os.makedirs(osp.dirname(osp.abspath(args.table)), exist_ok=True)
        with open(args.table, "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=60))
    top = [{"name": e.key[:90],
            "ms_per_batch": e.self_device_time_total / 1e3 / args.iters,
            "calls_per_batch": e.count / args.iters} for e in rows[:15]]
    print(json.dumps({"batch": args.batch, "wall_ms_per_batch": wall_ms,
                      "device_kernel_ms_per_batch": kern_ms,
                      "idle_share": 1 - kern_ms / wall_ms,
                      "megapixels_per_s": args.batch * 512 * 512
                      / (wall_ms * 1e3)}))
    for row in top:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
