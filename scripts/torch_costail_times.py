#!/usr/bin/env python3
"""Times the fused cosine tail's kernels (K5 forward, K6 backward) of one
checkout of the PyTorch port, on one GPU.

    python3 scripts/torch_costail_times.py [--root DIR]

Imports `zeroshotsemanticsegmentation_tpu_torch` from DIR (default: this
checkout; another commit unpacked with `git archive` times that commit's
kernels), builds its `costail_fused` library, and times
`cos_tail_forward` and `cos_tail_backward` at B=24, 512x512 on seeded
random scores and tables at C=20 (K=21, the main path) and C=300 (K=33):
CUDA events around 10 calls, and device time (torch.profiler's summed
kernel time) over 10 calls. Prints the card's name and power limit, then
one JSON line. To compare two commits on one card, run it in turns:
parent, change, change, parent. Needs a card: exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import subprocess
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
SHAPES = ((20, 21), (300, 33))   # (C, K)
B = 24
H = W = 512


def _event_ms(fn, iters: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int = 10) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total
               for e in prof.key_averages()) / 1e3 / iters


def run(root: str) -> dict:
    import numpy as np
    import torch
    sys.path.insert(0, root)
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
    from zeroshotsemanticsegmentation_tpu_torch.ops import (
        costail_fused as ct)
    from zeroshotsemanticsegmentation_tpu_torch.ops.losses import (
        l2_normalize)
    if not osp.abspath(ct.__file__).startswith(osp.abspath(root)):
        raise RuntimeError(f"imported {ct.__file__}, not from {root}")
    _kernels.build(("costail_fused",))
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    torch.manual_seed(0)
    out = {"root": root, "batch": B, "hw": [H, W]}
    for c, k in SHAPES:
        temb = l2_normalize(torch.from_numpy(
            rng.randn(k, c).astype(np.float32)).to(dev))
        score = torch.randn(B, H, W, c, device=dev)
        label = torch.randint(-1, k, (B, H, W), device=dev,
                              dtype=torch.int32)
        _, _, _, nv = ct.cos_tail_forward(score, label, temb, temb, k)
        g_losses = torch.randn(B, device=dev)
        g_ssum = torch.tensor(0.37, device=dev)

        def k5():
            return ct.cos_tail_forward(score, label, temb, temb, k)

        def k6():
            return ct.cos_tail_backward(score, label, temb, g_losses, nv,
                                        g_ssum)

        out[f"C{c}_K{k}"] = {"k5_ms": _event_ms(k5),
                             "k5_device_ms": _device_ms(k5),
                             "k6_ms": _event_ms(k6),
                             "k6_device_ms": _device_ms(k6)}
        del score, label
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose package is timed")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_costail_times.py needs an NVIDIA GPU "
              "(torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    print(json.dumps(run(args.root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
