#!/usr/bin/env python3
"""Block-1 variants on one GPU at B=16, 530x530 pre-padded bf16 input (the
512x512 image's support geometry): the PyTorch port's counterpart of the JAX
package's scripts/bench_block1.py, with the same inputs (numpy
RandomState(0), the same draws and scales).

    python3 scripts/torch_bench_block1.py [--iters 20]

Each variant is timed with CUDA events over --iters calls after one warm-up
call, under inference mode, and the kernels each variant launched in its
warm-up call are counted:

  conv1_1_pairs (K8)     conv1_1 + b1 + ReLU, csrc/conv1_1.cu
  plain conv1_1          its plain version in fp32 torch ops
  cuDNN conv1_1          the same through F.conv2d (bf16, bias in bf16)
                         + ReLU: the library yardstick
  K8 -> K3               the two-stage forward: K8, then conv1_2 + ReLU +
                         pool on csrc/block1_train.cu
  cuDNN conv1_1 -> K3    the same with the library conv1_1
  plain block 1          ops.block1_fused.block1_plain (cuDNN convolutions)
  K2 (one kernel)        csrc/block1_fused.cu, conv1_1 never in memory

The JAX bench also times `s2d_input`, the space-to-depth relayout its
conv1_1 kernel reads on a TPU; the port's K8 reads NHWC and has no such
step. Prints the card's name and power limit, one line per variant and a
last JSON line. chip_smoke.py phase 16 calls `run`. Needs a GPU: exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import subprocess
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

B, HP, WP = 16, 530, 530
C11_SHAPE = (B, HP - 2, WP - 2, 64)   # NHWC view of K8's packed pairs
K8, PLAIN_C11, CUDNN_C11 = ("conv1_1_pairs (K8)", "plain conv1_1",
                            "cuDNN conv1_1")
S2D = ("not timed: the TPU kernel's space-to-depth input relayout, which "
       "the port does not have")


def make_inputs() -> dict:
    """The JAX bench's inputs on the card: bf16 xp, fp32 weights (HWIO
    draws handed over in torch's OIHW)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(0)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    xp = dev(rng.randn(B, HP, WP, 3).astype(np.float32) * 0.5)
    k1 = dev(rng.randn(3, 3, 3, 64).astype(np.float32).transpose(3, 2, 0, 1)
             * 0.1)
    bias1 = dev(rng.randn(64).astype(np.float32) * 0.1)
    k2 = dev(rng.randn(3, 3, 64, 64).astype(np.float32).transpose(3, 2, 0, 1)
             * 0.05)
    bias2 = dev(rng.randn(64).astype(np.float32) * 0.1)
    return {"xp": xp.to(torch.bfloat16), "k1": k1, "bias1": bias1, "k2": k2,
            "bias2": bias2}


def variants(inp: dict) -> dict:
    """name -> a call of that block-1 variant on `inp`."""
    import torch
    import torch.nn.functional as F
    from zeroshotsemanticsegmentation_tpu_torch.ops import block1_fused as b1

    bf = torch.bfloat16
    xp, k1, bias1, k2, bias2 = (inp[k] for k in ("xp", "k1", "bias1", "k2",
                                                  "bias2"))
    k1b, b1b, k2b = k1.to(bf), bias1.to(bf), k2.to(bf)
    xl = xp.permute(0, 3, 1, 2)

    def cudnn_c11():
        return torch.relu(F.conv2d(xl, k1b, b1b)).permute(0, 2, 3, 1)

    return {
        K8: lambda: b1.conv1_1_pairs(xp, k1, bias1),
        PLAIN_C11: lambda: b1.conv1_1_pairs_plain(xp, k1, bias1),
        CUDNN_C11: cudnn_c11,
        "K8 -> K3": lambda: b1.conv2_pool(
            b1.conv1_1_pairs(xp, k1, bias1).view(C11_SHAPE), k2b, bias2),
        "cuDNN conv1_1 -> K3": lambda: b1.conv2_pool(cudnn_c11(), k2b,
                                                     bias2),
        "plain block 1": lambda: b1.block1_plain(xp, k1, bias1, k2, bias2,
                                                 bf),
        "K2 (one kernel)": lambda: b1.block1_fused(xp, k1, bias1, k2, bias2,
                                                   bf),
    }


def run(iters: int = 20, log=print) -> dict:
    """Times every variant with CUDA events over `iters` calls after one
    warm-up call, under inference mode. Each warm-up call is driven with the
    kernels' launch counts at 0 just before it and read just after. Returns
    {"ms": {name: ms}, "launches": {name: {kernel: launches}}}."""
    import torch
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels

    _kernels.build()
    times, launches = {}, {}
    with torch.inference_mode():
        for name, fn in variants(make_inputs()).items():
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            fn()
            torch.cuda.synchronize()
            launches[name] = {k: v for k, v in _kernels.launch_counts.items()
                              if v}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times[name] = start.elapsed_time(end) / iters
            log(f"{name:24s} {times[name]:9.4f} ms  launches "
                f"{launches[name]}")
    log(f"{'s2d_input only':24s} {S2D}")
    return {"ms": times, "launches": launches}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_bench_block1.py needs an NVIDIA GPU: "
                 "torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    res = run(args.iters, lambda m: print(m, flush=True))
    print(json.dumps({
        "block1_bench": {"batch": B, "hw": [HP, WP], "dtype": "bfloat16",
                         "iters": args.iters, **res,
                         "not_timed": {"s2d_input only": S2D}},
        "device": {"kind": torch.cuda.get_device_name(0), "card": card}}))


if __name__ == "__main__":
    main()
