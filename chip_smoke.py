#!/usr/bin/env python3
"""Runs the PyTorch port's SZN serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or ends the script with a non-zero exit:

1. device: needs CUDA; prints the card's name and power limit (nvidia-smi);
   TF32 off for the parity phases;
2. build: compiles the CUDA kernels from zeroshotsemanticsegmentation_tpu_torch
   /csrc with nvcc (sm_90a) and prints the build time and ptxas's summary;
3. the SZN-labels kernel vs its plain version at the serving shapes (B=8,
   K=21, C=20, 17x17 heads, 512x512) and at the edge cases of the JAX
   package's tests (zero-norm pixels, a zeroed embedding row, all-negative
   similarities);
4. the fused block-1 kernel vs its plain version at (2, 522, 522, 3) in fp32
   and bf16, and at the odd 375x500 geometry of the pruned path;
5. the slice: a full-width FCN-32s (20-dim embeddings, seeded random
   weights) served through make_szn_predictor with the bundled pascal
   embeddings and unseen classes [1, 13]; a few requests (float32 512x512,
   uint8, 500x375), both kernels' launch counts, labels vs the same predictor
   through the plain versions (fp32), vs the unfused full-resolution NNE
   reference, and the trained-upscore route;
6. times with CUDA events: the predictor at B=64, 512x512, bf16, and each
   kernel at its serving shape beside its plain version and its bound.

The last line of standard output is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os.path as osp
import subprocess
import sys
import time
from unittest import mock

import numpy as np

ROOT = osp.dirname(osp.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
PEAK_FP32_FLOP_S = 67e12

H = W = 512
SERVE_BATCH = 64
UNSEEN = [1, 13]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
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


def main() -> None:
    try:
        import torch
        import torch.nn.functional as F
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    try:
        from zeroshotsemanticsegmentation_tpu_torch.data.assets import (
            load_class_embeddings)
        from zeroshotsemanticsegmentation_tpu_torch.data.transforms import (
            transform_image)
        from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import (
            FCN32s)
        from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
        from zeroshotsemanticsegmentation_tpu_torch.ops import (
            block1_fused as b1)
        from zeroshotsemanticsegmentation_tpu_torch.ops import szn_fused as sz
        from zeroshotsemanticsegmentation_tpu_torch.ops.metrics import (
            unseen_mask_vector)
        from zeroshotsemanticsegmentation_tpu_torch.ops.nne import (
            infer_labels_szn)
        from zeroshotsemanticsegmentation_tpu_torch.serving import (
            make_szn_predictor)
    except ImportError as e:
        fail(f"the port package is not importable next to this script: {e}")

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}, {torch.cuda.device_count()} visible, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    secs = _kernels.build()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall; per source "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for name, text in _kernels.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    @contextlib.contextmanager
    def plain_versions():
        """Routes the predictor through the kernels' plain versions."""
        with mock.patch.object(sz, "szn_labels", sz.szn_labels_plain), \
                mock.patch.object(b1, "block1_op", b1.block1_plain):
            yield

    def flip_rate(a, b) -> float:
        return (a != b).float().mean().item()

    rng = np.random.RandomState(0)
    embed = load_class_embeddings("pascal", 20)
    k_cls = embed.shape[0]

    # ---- 3. SZN-labels kernel vs plain ----------------------------------
    def szn_case(score, sm, emb, unseen, out_hw):
        got = sz.infer_labels_szn_fused(score, sm, emb, unseen, out_hw)
        with mock.patch.object(sz, "szn_labels", sz.szn_labels_plain):
            want = sz.infer_labels_szn_fused(score, sm, emb, unseen, out_hw)
        torch.cuda.synchronize()
        return got, want

    uv = unseen_mask_vector(k_cls, UNSEEN)
    score = torch.randn(8, 17, 17, 20, device=dev)
    sm = torch.randn(8, 17, 17, 2, device=dev)
    got, want = szn_case(score, sm, embed, uv, (H, W))
    k1_flips = flip_rate(got, want)
    k1_maxerr = (got - want).abs().max().item()
    log(f"[K1] B=8 512x512 K=21: flip rate {k1_flips:.3e}, "
        f"max label {got.max().item()}")
    require(got.shape == (8, H, W) and got.dtype == torch.int32,
            f"K1 output {tuple(got.shape)} {got.dtype}")
    require(k1_flips < 1e-4, f"K1 flip rate {k1_flips} >= 1e-4")
    require(got.max().item() < k_cls and got.min().item() >= 0,
            "K1 emitted a label outside [0, K)")

    e9 = rng.randn(9, 8).astype(np.float32)
    e9 /= np.linalg.norm(e9, axis=1, keepdims=True)
    e9[3] = 0.0
    s_edge = torch.randn(1, 4, 5, 8, device=dev)
    s_edge[0, :2] = 0.0
    got, want = szn_case(s_edge, torch.randn(1, 4, 5, 2, device=dev), e9,
                         unseen_mask_vector(9, [3, 7]), (70, 90))
    edge_flips = flip_rate(got, want)
    log(f"[K1] zero norms + zeroed row: flip rate {edge_flips:.3e}")
    require(edge_flips < 1e-3 and got.max().item() < 9,
            f"K1 edge case: flip rate {edge_flips}, max {got.max().item()}")
    neg = -torch.randn(1, 4, 5, 8, device=dev).abs()
    got = sz.infer_labels_nne_fused(neg, e9, (70, 90))
    with mock.patch.object(sz, "szn_labels", sz.szn_labels_plain):
        want = sz.infer_labels_nne_fused(neg, e9, (70, 90))
    neg_flips = flip_rate(got, want)
    log(f"[K1] all-negative sims: flip rate {neg_flips:.3e}")
    require(neg_flips < 1e-4 and got.max().item() < 9,
            f"K1 all-negative: flip rate {neg_flips}")

    # ---- 4. block-1 kernel vs plain -------------------------------------
    def b1_weights(gen_scale=(0.2, 0.1, 0.05, 0.1)):
        return (torch.randn(64, 3, 3, 3, device=dev) * gen_scale[0],
                torch.randn(64, device=dev) * gen_scale[1],
                torch.randn(64, 64, 3, 3, device=dev) * gen_scale[2],
                torch.randn(64, device=dev) * gen_scale[3])

    k2_bf16_err = None
    for shape in ((2, 522, 522, 3), (2, 375 + 11, 500 + 10, 3)):
        xp = torch.randn(*shape, device=dev)
        wts = b1_weights()
        with torch.inference_mode():
            ref = b1.block1_plain(xp, *wts, torch.float32)
            got32 = b1.block1_op(xp, *wts, torch.float32)
            got16 = b1.block1_op(xp, *wts, torch.bfloat16).float()
        torch.cuda.synchronize()
        require(got32.shape == ref.shape, f"K2 shape {tuple(got32.shape)}")
        err32 = (got32 - ref).abs().max().item()
        err16 = (got16 - ref).abs().max().item()
        bar16 = 2 * ref.abs().max().item() * 2.0 ** -8
        log(f"[K2] {shape}: fp32 max|err| {err32:.3e} (bar 1e-4), bf16 "
            f"max|err| {err16:.3e} (bar {bar16:.3e})")
        require(err32 <= 1e-4, f"K2 fp32 error {err32} at {shape}")
        require(err16 <= bar16, f"K2 bf16 error {err16} > {bar16}")
        with torch.inference_mode():  # both fp32 versions vs fp64
            ref64 = b1.block1_plain(xp[:1].double(),
                                    *(w.double() for w in wts), torch.float64)
        e_kern = (got32[:1].double() - ref64).abs().max().item()
        e_plain = (ref[:1].double() - ref64).abs().max().item()
        log(f"[K2] {shape}: vs fp64, kernel fp32 max|err| {e_kern:.3e}, "
            f"plain fp32 max|err| {e_plain:.3e}")
        require(e_kern <= 1e-4, f"K2 fp32 vs fp64 error {e_kern}")
        if k2_bf16_err is None:
            k2_bf16_err = err16

    # ---- 5. the slice ---------------------------------------------------
    def model(dtype, seed=0):
        gen = torch.Generator().manual_seed(seed)
        return FCN32s(20, dtype=dtype, fused_block1=True, generator=gen,
                      device=dev)

    def images(b, h, w, uint8=False):
        raw = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
        if uint8:
            return torch.from_numpy(raw)
        return torch.from_numpy(np.stack([transform_image(r) for r in raw]))

    serve = make_szn_predictor(model(torch.bfloat16), None, embed, UNSEEN)
    requests = [images(4, H, W), images(4, H, W), images(4, H, W, True),
                images(2, 375, 500)]
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    outs = [serve(r) for r in requests]
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    log(f"[slice] launches on the main path: {launches}")
    for r, o in zip(requests, outs):
        require(tuple(o.shape) == tuple(r.shape[:3]) and o.dtype ==
                torch.int32, f"labels {tuple(o.shape)} for {tuple(r.shape)}")
        require(o.min().item() >= 0 and o.max().item() < k_cls,
                "a label outside [0, 21)")
    require(all(n > 0 for n in launches.values()),
            f"a kernel was not launched on the main path: {launches}")
    log(f"[slice] classes present in the bf16 labels: "
        f"{sorted(torch.cat([o.flatten() for o in outs]).unique().tolist())}")

    with plain_versions():
        bf16_plain = serve(requests[0])
    log(f"[slice] bf16 flip rate kernels vs plain versions: "
        f"{flip_rate(outs[0], bf16_plain):.3e}")

    m32 = model(torch.float32)
    for trained in (False, True):
        if trained:
            gen = torch.Generator().manual_seed(1)
            with torch.no_grad():
                m32.seenmask_upscore.weight.add_(
                    torch.randn(m32.seenmask_upscore.weight.shape,
                                generator=gen).to(dev))
        pred = make_szn_predictor(m32, None, embed, UNSEEN,
                                  upscore_trained=trained)
        for req in (requests[0][:2], requests[3][:1]):
            got = pred(req)
            with plain_versions():
                want = pred(req)
            fr = flip_rate(got, want)
            log(f"[slice] fp32 upscore_trained={trained} "
                f"{tuple(req.shape)}: flip rate vs plain {fr:.3e}")
            require(fr < 1e-4, f"fp32 flip rate {fr} >= 1e-4")
            if not trained:
                with torch.inference_mode():
                    xin = req.to(dev)
                    f_full, s_full = m32(xin, mode="both")
                    ref = infer_labels_szn(
                        f_full, s_full, torch.from_numpy(embed).to(dev),
                        torch.from_numpy(uv).to(dev))
                fr = flip_rate(got, ref)
                log(f"[slice] fp32 vs the unfused full-resolution NNE "
                    f"reference: flip rate {fr:.3e}")
                require(fr < 1e-4, f"unfused reference flip rate {fr}")

    # ---- 6. times -------------------------------------------------------
    x64 = requests[0][:1].to(dev).repeat(SERVE_BATCH, 1, 1, 1)
    x64 = x64 + torch.randn_like(x64)
    ms = time_ms(lambda: serve(x64), iters=5)
    mps = SERVE_BATCH * H * W / (ms * 1e3)
    log(json.dumps({"serving": {"batch": SERVE_BATCH, "hw": [H, W],
                                "dtype": "bfloat16", "ms_per_batch": ms,
                                "megapixels_per_s": mps}}))

    # K1 at the serving shape
    score = torch.randn(SERVE_BATCH, 17, 17, 20, device=dev)
    gate = torch.randn(SERVE_BATCH, 17, 17, device=dev)
    aug = sz._aug(score, gate, sz._embed_scaled(embed, dev))
    uvt = torch.from_numpy(uv).to(dev)
    parts = sz._partition(~uvt, uvt)
    k1_ms = time_ms(lambda: sz.szn_labels(aug, *parts, H, W), iters=20)
    k1_plain_ms = time_ms(lambda: sz.szn_labels_plain(aug, *parts, H, W),
                          iters=3)
    kp1 = aug.shape[-1]
    k1_bytes = aug.numel() * 4 + SERVE_BATCH * H * W * 4
    k1_ops = 3 * SERVE_BATCH * H * (W + 17) * kp1
    k1_bound = 1e3 * max(k1_bytes / PEAK_BYTES_S, k1_ops / PEAK_FP32_FLOP_S)
    k1_by = ("bytes" if k1_bytes / PEAK_BYTES_S
             >= k1_ops / PEAK_FP32_FLOP_S else "operations")

    # K2 at the serving shape
    xp = torch.randn(SERVE_BATCH, H + 10, W + 10, 3, device=dev).to(
        torch.bfloat16)
    wts = b1_weights()
    with torch.inference_mode():
        k2_ms = time_ms(lambda: b1.block1_op(xp, *wts, torch.bfloat16),
                        iters=5)
        k2_plain_ms = time_ms(
            lambda: b1.block1_plain(xp, *wts, torch.bfloat16), iters=3)
        xl = xp.permute(0, 3, 1, 2)
        lw = [w.to(torch.bfloat16) for w in wts]
        k2_lib_ms = time_ms(lambda: F.max_pool2d(torch.relu(F.conv2d(
            torch.relu(F.conv2d(xl, lw[0], lw[1])), lw[2], lw[3])), 2, 2),
            iters=3)
    hc1, hc2 = H + 8, H + 6
    k2_ops = 2 * SERVE_BATCH * (hc1 * hc1 * 27 * 64 + hc2 * hc2 * 576 * 64)
    k2_bytes = (xp.numel() * 2 + SERVE_BATCH * (hc2 // 2) ** 2 * 64 * 2
                + (27 + 576) * 64 * 2 + 128 * 4)
    k2_bound = 1e3 * max(k2_bytes / PEAK_BYTES_S, k2_ops / PEAK_BF16_FLOP_S)
    k2_by = ("bytes" if k2_bytes / PEAK_BYTES_S
             >= k2_ops / PEAK_BF16_FLOP_S else "operations")

    kernels = [
        {"name": "szn_fused_labels", "route": "cuda",
         "source": "zeroshotsemanticsegmentation_tpu_torch/csrc/szn_fused.cu",
         "replaces": "zeroshotsemanticsegmentation_tpu/ops/szn_fused.py:44",
         "launches": launches["szn_fused"], "max_abs_err": k1_maxerr,
         "flip_rate": k1_flips, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "shape": [SERVE_BATCH, 17, 17, kp1, H, W]},
        {"name": "block1_fused_forward", "route": "cuda",
         "source":
             "zeroshotsemanticsegmentation_tpu_torch/csrc/block1_fused.cu",
         "replaces":
             "zeroshotsemanticsegmentation_tpu/ops/block1_fused.py:485",
         "launches": launches["block1_fused"], "max_abs_err": k2_bf16_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib_ms,
         "shape": [SERVE_BATCH, H + 10, W + 10, 3], "dtype": "bfloat16"},
    ]
    log(f"[times] K1 {k1_ms:.4f} ms (plain {k1_plain_ms:.3f}, bound "
        f"{k1_bound:.4f}); K2 {k2_ms:.3f} ms (plain {k2_plain_ms:.3f}, "
        f"cuDNN {k2_lib_ms:.3f}, bound {k2_bound:.3f})")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
