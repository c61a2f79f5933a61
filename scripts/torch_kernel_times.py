#!/usr/bin/env python3
"""Times hand-written kernels of one checkout of the PyTorch port, on one
GPU, by CUDA events and by device time.

    python3 scripts/torch_kernel_times.py [--kernels k1,k8,k5k6,k7f32,fc6]
        [--root DIR]

Imports `zeroshotsemanticsegmentation_tpu_torch` from DIR (default: this
checkout; another commit unpacked with `git archive` times that commit's
kernels), builds the libraries it needs, and times, on seeded random
inputs:

  k1    `szn_labels` (K1), 17x17 -> 512x512, at B=64 (serving) and B=16
        (the evals): the SZN route (random gates) at K=21 (pascal, unseen
        [1, 13]) and K=33 (context, unseen [2, 9, 30]), and the NNE route
        of the fused fcn eval (a constant -1 gate, every class seen) at
        K=21; device time of the kernels named `szn_labels`;
  k8    `conv1_1_pairs` (K8) in bf16 at the block-1 bench's
        (16, 530, 530, 3); device time of the kernels named `conv1_1` (the
        weight packing, a few small kernels, is left out);
  k5k6  `cos_tail_forward` (K5) and `cos_tail_backward` (K6) at B=24,
        512x512, C=20 (K=21, the main path) and C=300 (K=33); device time
        of every kernel of the call;
  k7f32 `pdot` (K7) in fp32 at the dot-free model's four products at B=24
        (fc6's input gradient, fc7's, score_fr's and seenmask_score's weight
        gradients) and the H2D probe's 512^3 product (K10a), beside
        torch.matmul (TF32 off); device time of the kernels named `pdot`,
        the kernels one call launches (name: recorded launches a call),
        the plan, and the relative norm vs an fp64 product;
  fc6   `conv7x7_igemm`, fc6's implicit-GEMM forward, in bf16 at B=16
        (serving) and B=24 (training), (B, 512, 23, 23) -> 4096, beside
        cuDNN's bf16 F.conv2d and torch.matmul over the unfolded
        bf16 patch matrix (the product alone), with the bound (operations
        at 989 TFLOP/s); device time of the kernels named `conv7x7_igemm`,
        its relative norm vs the fp32 product (its plain version, TF32
        off) beside cuDNN's bf16 output's, and two calls bit-equal.

CUDA events around 20 calls and torch.profiler's device time over 20
calls, per call, with `chip_smoke.py`'s `time_ms` and `device_ms`. Prints
the card's name and power limit, then one JSON line. To compare two commits
on one card, run it in turns: parent, change, change, parent. Needs a card:
exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
H = W = 512
ITERS = 20
K1_CASES = (("szn", 64, 21, (1, 13)), ("szn", 16, 21, (1, 13)),
            ("szn", 64, 33, (2, 9, 30)), ("szn", 16, 33, (2, 9, 30)),
            ("nne", 64, 21, ()), ("nne", 16, 21, ()))  # route, B, K, unseen
K8_SHAPE = (16, 530, 530, 3)
K5K6_SHAPES = ((20, 21), (300, 33))   # (C, K)
K5K6_BATCH = 24
K7F32_SHAPES = (("fc6_input_grad", 6936, 4096, 25088, False),
                ("fc7_weight_grad", 4096, 6936, 4096, True),
                ("score_fr_weight_grad", 4096, 6936, 20, True),
                ("seenmask_score_weight_grad", 4096, 6936, 2, True),
                ("k10a", 512, 512, 512, False))  # (name, M, K, N, trans_a)
FC6_BATCHES = (16, 24)
FC6_SHAPE = (512, 23, 23, 4096, 7)   # Cin, IH, IW, Cout, kernel
PEAK_BF16_FLOP_S = 989e12
KERNELS = ("k1", "k8", "k5k6", "k7f32", "fc6")


def time_k1(sz, dev, rng, time_ms, device_ms) -> list:
    import numpy as np
    import torch
    out = []
    for route, batch, k, unseen in K1_CASES:
        aug = torch.from_numpy(
            rng.randn(batch, 17, 17, k + 1).astype(np.float32)).to(dev)
        if route == "nne":
            aug[..., k] = -1.0
        uv = np.isin(np.arange(k), unseen)
        if hasattr(sz, "kernel_partition"):  # host partition
            parts = sz._partition(~uv, uv)
        else:  # a partition of device tensors
            uvt = torch.from_numpy(uv).to(dev)
            parts = sz._partition(~uvt, uvt)

        def k1():
            return sz.szn_labels(aug, *parts, H, W)

        out.append({"route": route, "batch": batch, "k": k, "hw": [H, W],
                    "ms": time_ms(k1, ITERS),
                    "device_ms": device_ms(k1, ITERS, "szn_labels")})
        del aug
    return out


def time_k8(b1, dev, rng, time_ms, device_ms) -> dict:
    import numpy as np
    import torch
    xp = torch.from_numpy(rng.randn(*K8_SHAPE).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    k1w = torch.from_numpy(
        rng.randn(64, 3, 3, 3).astype(np.float32) * 0.1).to(dev)
    b1w = torch.from_numpy(rng.randn(64).astype(np.float32) * 0.1).to(dev)

    def k8():
        return b1.conv1_1_pairs(xp, k1w, b1w, torch.bfloat16)

    return {"shape": list(K8_SHAPE), "dtype": "bfloat16",
            "ms": time_ms(k8, ITERS),
            "device_ms": device_ms(k8, ITERS, "conv1_1")}


def time_k5k6(ct, l2_normalize, dev, rng, time_ms, device_ms) -> dict:
    import numpy as np
    import torch
    torch.manual_seed(0)
    out = {"batch": K5K6_BATCH, "hw": [H, W]}
    for c, k in K5K6_SHAPES:
        temb = l2_normalize(torch.from_numpy(
            rng.randn(k, c).astype(np.float32)).to(dev))
        score = torch.randn(K5K6_BATCH, H, W, c, device=dev)
        label = torch.randint(-1, k, (K5K6_BATCH, H, W), device=dev,
                              dtype=torch.int32)
        _, _, _, nv = ct.cos_tail_forward(score, label, temb, temb, k)
        g_losses = torch.randn(K5K6_BATCH, device=dev)
        g_ssum = torch.tensor(0.37, device=dev)

        def k5():
            return ct.cos_tail_forward(score, label, temb, temb, k)

        def k6():
            return ct.cos_tail_backward(score, label, temb, g_losses, nv,
                                        g_ssum)

        out[f"C{c}_K{k}"] = {"k5_ms": time_ms(k5, ITERS),
                             "k5_device_ms": device_ms(k5, ITERS),
                             "k6_ms": time_ms(k6, ITERS),
                             "k6_device_ms": device_ms(k6, ITERS)}
        del score, label
        torch.cuda.empty_cache()
    return out


def time_k7f32(pd, dev, time_ms, device_ms) -> list:
    import torch
    from chip_smoke import kernels_per_call
    out = []
    for name, m, k, n, trans in K7F32_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        a = torch.randn(*((k, m) if trans else (m, k)), device=dev,
                        generator=gen)
        b = torch.randn(k, n, device=dev, generator=gen)
        a_lib = a.t() if trans else a
        iters = 5 if 2.0 * m * k * n > 1e11 else ITERS

        def k7():
            return pd.pdot(a, b, trans_a=trans)

        def lib():
            return torch.matmul(a_lib, b)

        got = k7()
        ref = a_lib.double() @ b.double()
        rel = ((got.double() - ref).norm() / ref.norm()).item()
        del got, ref
        out.append({"name": name, "m": m, "k": k, "n": n, "trans_a": trans,
                    "plan": pd.plan_for(a, b, trans_a=trans),
                    "rel_norm_vs_fp64": rel,
                    "ms": time_ms(k7, iters),
                    "device_ms": device_ms(k7, iters, "pdot"),
                    "kernels_per_call": kernels_per_call(k7),
                    "library_ms": time_ms(lib, iters),
                    "library_device_ms": device_ms(lib, iters)})
        del a, b, a_lib
        torch.cuda.empty_cache()
    return out


def time_fc6(c7, dev, time_ms, device_ms) -> list:
    import torch
    import torch.nn.functional as F
    ci, ih, iw, co, k = FC6_SHAPE
    out = []
    for batch in FC6_BATCHES:
        gen = torch.Generator(device=dev).manual_seed(batch)
        x = torch.randn(batch, ih, iw, ci, device=dev, generator=gen).to(
            torch.bfloat16).permute(0, 3, 1, 2)
        w = (torch.randn(co, ci, k, k, device=dev, generator=gen)
             / (ci * k * k) ** 0.5).to(torch.bfloat16)
        wp = c7.pack_weight(w, torch.bfloat16)
        m = batch * (ih - k + 1) * (iw - k + 1)
        flops = 2.0 * m * co * ci * k * k
        ref = c7.conv7x7_igemm_plain(x.float(), wp.float())

        def rel(y):
            return ((y.float() - ref).norm() / ref.norm()).item()

        def kern():
            return c7.conv7x7_igemm(x, wp)

        row = {"batch": batch, "m": m, "flops": flops,
               "bound_ms": flops / PEAK_BF16_FLOP_S * 1e3}
        y = kern()
        again = kern()
        torch.cuda.synchronize()
        dms = device_ms(kern, 5, "conv7x7_igemm")
        row["kernel"] = {"ms": time_ms(kern, 5), "device_ms": dms,
                         "roofline_pct": 100.0 * row["bound_ms"] / dms,
                         "rel_norm_vs_fp32": rel(y),
                         "bit_equal": bool(torch.equal(y, again))}
        del y, again
        lib = F.conv2d(x, w)
        row["cudnn"] = {"ms": time_ms(lambda: F.conv2d(x, w), 3),
                        "device_ms": device_ms(lambda: F.conv2d(x, w), 3),
                        "rel_norm_vs_fp32": rel(lib)}
        del lib
        cols = c7.patches(x, k, k)  # (M, 49 * 512) bf16, materialised
        km = wp.permute(0, 2, 3, 1).reshape(co, -1).t()   # a view
        row["patch_matmul"] = {
            "patch_matrix_bytes": cols.numel() * 2,
            "ms": time_ms(lambda: torch.matmul(cols, km), 5),
            "device_ms": device_ms(lambda: torch.matmul(cols, km), 5)}
        del cols, km, x, w, wp, ref
        torch.cuda.empty_cache()
        out.append(row)
    return out


def run(root: str, kernels) -> dict:
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    from chip_smoke import device_ms, time_ms  # this checkout's timers
    sys.path.insert(0, root)
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
    from zeroshotsemanticsegmentation_tpu_torch.ops import (
        block1_fused as b1)
    from zeroshotsemanticsegmentation_tpu_torch.ops import (
        costail_fused as ct)
    from zeroshotsemanticsegmentation_tpu_torch.ops import pdot as pd
    from zeroshotsemanticsegmentation_tpu_torch.ops import szn_fused as sz
    from zeroshotsemanticsegmentation_tpu_torch.ops.losses import (
        l2_normalize)
    if not osp.abspath(sz.__file__).startswith(osp.abspath(root)):
        raise RuntimeError(f"imported {sz.__file__}, not from {root}")
    from zeroshotsemanticsegmentation_tpu_torch.ops import conv7x7 as c7
    libs = {"k1": "szn_fused", "k8": "conv1_1", "k5k6": "costail_fused",
            "k7f32": "pdot", "fc6": "conv7x7_igemm"}
    _kernels.build(tuple(libs[k] for k in kernels))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    out = {"root": root}
    timers = (time_ms, device_ms)
    if "k1" in kernels:
        out["k1"] = time_k1(sz, dev, rng, *timers)
    if "k8" in kernels:
        out["k8"] = time_k8(b1, dev, rng, *timers)
    if "k5k6" in kernels:
        out["k5k6"] = time_k5k6(ct, l2_normalize, dev, rng, *timers)
    if "k7f32" in kernels:
        out["k7f32"] = time_k7f32(pd, dev, *timers)
    if "fc6" in kernels:
        out["fc6"] = time_fc6(c7, dev, *timers)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated, of " + ", ".join(KERNELS))
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose package is timed")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        ap.error(f"--kernels takes {', '.join(KERNELS)}")
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_times.py needs an NVIDIA GPU "
              "(torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import card_line
    print(card_line() or "nvidia-smi failed", flush=True)
    print(json.dumps(run(args.root, kernels)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
