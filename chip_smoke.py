#!/usr/bin/env python3
"""Runs the PyTorch port's SZN serving and stage-1 training paths on one
NVIDIA GPU.

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
   kernel at its serving shape beside its plain version and its bound;
7. the block-1 training kernels (K3 forward, K4 backward) vs their plain
   versions on c11 from (2, 522, 522, 3), from the odd 375x500 geometry
   (386x510) and from the train step's (24, 522, 522, 3), fp32 with TF32
   off and bf16; at B=24 in fp32 both K4 and its plain version also vs an
   fp64 autograd reference;
8. the fused cosine tail (K5 forward, K6 backward) vs its plain versions at
   B=4 and at the train step's B=24, 512x512, C=20, K=21 with ignore
   labels, an all-ignore sample, a zeroed embedding row and zero-norm
   pixels;
9. the training slice: a full-width bf16 FCN-32s (fused block 1, support
   pruning, seeded random weights) trained by make_fcn_train_step (cos
   loss, fused tail, Adam lr 1e-5, dropout 0.5 from a seeded CUDA
   generator) for a few steps at B=24, 512x512 with the bundled pascal
   embeddings, the last step with host syncs turned into errors; the
   launch counts of K3-K6 (and none of K2); then one fp32
   step at B=2 through the kernels vs the same step through the plain
   versions;
10. times with CUDA events: the train step at B=24, 512x512, bf16 (the JAX
   package's bench_train configuration), its peak memory, and K3-K6 at the
   step's shapes beside their plain versions, bounds and library calls.

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
TRAIN_BATCH = 24
TRAIN_STEPS = 3        # phase 9, after which the timed steps follow
TIMED_STEPS = 5
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
        from zeroshotsemanticsegmentation_tpu_torch.ops import (
            costail_fused as ct)
        from zeroshotsemanticsegmentation_tpu_torch.train import (
            TrainState, make_fcn_optimizer, make_fcn_train_step)
        from zeroshotsemanticsegmentation_tpu_torch.train import (
            steps as train_steps)
        from zeroshotsemanticsegmentation_tpu_torch.train.optim import (
            FROZEN_MODULES)
        from zeroshotsemanticsegmentation_tpu_torch.ops.losses import (
            l2_normalize)
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
    torch.manual_seed(0)  # the synthetic inputs of every phase

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

    @contextlib.contextmanager
    def plain_training():
        """Routes the train step through K3-K6's plain versions: the
        training form of block 1 with plain conv2_pool, and the fused
        tail's plain version."""
        with mock.patch.object(b1, "conv2_pool", b1.conv2_pool_plain), \
                mock.patch.object(b1, "conv2_pool_backward",
                                  b1.conv2_pool_plain_backward), \
                mock.patch.object(train_steps, "fused_cos_tail",
                                  ct.cos_tail_plain):
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
    require(launches["szn_fused"] > 0 and launches["block1_fused"] > 0,
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

    # ---- 7. block-1 training kernels (K3, K4) vs plain ------------------
    def c11_from(xp, wts, dtype):
        with torch.no_grad():
            x = xp.to(dtype).permute(0, 3, 1, 2)
            c = torch.relu(F.conv2d(x, wts[0].to(dtype))
                           + wts[1].to(dtype)[:, None, None])
        return c.permute(0, 2, 3, 1).contiguous()

    def rel(a, b) -> float:
        a, b = a.double(), b.double()
        return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()

    def conv2_pool_grads64(c11, k2, b2, g):
        """(d c11, d k2, d b2) summed in fp64, routed as the fp32 plain
        version routes (first maximum of each window, ReLU' as pre > 0,
        from fp32 pre-activations): fp64 pre-activations would pick other
        maxima among near-ties, and the flips, not the sums, would set the
        difference."""
        x = c11.permute(0, 3, 1, 2)
        pre = F.conv2d(x.float(), k2.float()) + b2.float()[:, None, None]
        _, idx = F.max_pool2d(torch.relu(pre), 2, 2, return_indices=True)
        dz = F.max_unpool2d(g.double().permute(0, 3, 1, 2), idx, 2, 2,
                            output_size=pre.shape[-2:]) * (pre > 0)
        del pre, idx
        x64 = x.double()
        dk = torch.nn.grad.conv2d_weight(x64, tuple(k2.shape), dz)
        dc = torch.nn.grad.conv2d_input(tuple(x64.shape), k2.double(), dz)
        return dc.permute(0, 2, 3, 1), dk, dz.sum((0, 2, 3))

    # bf16 K4 bar, relative norm per output: kernel and plain version sum
    # in fp32 in different orders and round dK2 and d(c11) to bf16 once,
    # so they differ by at most one bf16 ULP per element, 2^-8 relative;
    # measured on an H100: dk2 2.5e-4 at B=2 and 5.0e-4 at B=24, dc11
    # 1.0e-5 and 3.2e-5, db2 below 4e-7. In fp32 at B=24 the plain
    # version's dk2 is 8.6e-5 from an fp64 sum and the kernel's 3.9e-7, so
    # the fp32 kernel-vs-plain reading there is cuDNN's rounding.
    k4_bf16_bar = 2.0 ** -8
    k3_err = k4_err = None
    for shape in ((2, 522, 522, 3), (2, 375 + 11, 500 + 10, 3),
                  (TRAIN_BATCH, H + 10, W + 10, 3)):
        xp = torch.randn(*shape, device=dev)
        wts = b1_weights()
        for dtype in (torch.float32, torch.bfloat16):
            c11 = c11_from(xp, wts, dtype)
            k2t, b2f = wts[2].to(dtype), wts[3]
            got = b1.conv2_pool(c11, k2t, b2f)
            want = b1.conv2_pool_plain(c11, k2t, b2f)
            g = torch.randn_like(want)
            dgot = b1.conv2_pool_backward(c11, k2t, b2f, g)
            dwant = b1.conv2_pool_plain_backward(c11, k2t, b2f, g)
            torch.cuda.synchronize()
            require(got.shape == want.shape and got.dtype == dtype,
                    f"K3 output {tuple(got.shape)} {got.dtype}")
            err = (got.float() - want.float()).abs().max().item()
            rels = [rel(a, b) for a, b in zip(dgot, dwant)]
            derr = (dgot[0].float() - dwant[0].float()).abs().max().item()
            if dtype == torch.float32:
                bar, gbar = 1e-4, 1e-4
            else:
                bar = 2 * want.float().abs().max().item() * 2.0 ** -8
                gbar = k4_bf16_bar
                if shape[0] == TRAIN_BATCH:  # the main path's shape
                    k3_err, k4_err = err, derr
            log(f"[K3] {tuple(c11.shape)} {dtype}: max|err| {err:.3e} "
                f"(bar {bar:.3e}); [K4] rel-norm dc11/dk2/db2 "
                + "/".join(f"{r:.3e}" for r in rels) + f" (bar {gbar:.0e}),"
                f" dc11 max|err| {derr:.3e}")
            require(err <= bar, f"K3 {dtype} error {err} > {bar}")
            require(all(r < gbar for r in rels),
                    f"K4 {dtype} relative errors {rels} >= {gbar}")
            for a, b in zip(dgot, dwant):
                require(a.shape == b.shape and a.dtype == b.dtype,
                        f"K4 output {tuple(a.shape)} {a.dtype} vs "
                        f"{tuple(b.shape)} {b.dtype}")
            if dtype == torch.float32 and shape[0] == TRAIN_BATCH:
                del got, want
                d64 = conv2_pool_grads64(c11, k2t, b2f, g)
                r_k = [rel(a, b) for a, b in zip(dgot, d64)]
                r_p = [rel(a, b) for a, b in zip(dwant, d64)]
                log("[K4] B=24 fp32 vs fp64, rel-norm dc11/dk2/db2: kernel "
                    + "/".join(f"{r:.3e}" for r in r_k) + ", plain "
                    + "/".join(f"{r:.3e}" for r in r_p))
                require(all(r < 1e-4 for r in r_k),
                        f"K4 fp32 vs fp64 relative errors {r_k}")
                del d64
            del c11, g, dgot, dwant
    del xp

    # ---- 8. fused cosine tail (K5, K6) vs plain --------------------------
    tc, tk = 20, k_cls
    temb = torch.from_numpy(embed).to(dev).clone()
    iemb = temb.clone()
    temb[0] = 0.0                             # a zeroed embedding row
    iemb[3] = 0.0
    temb_n, iemb_n = l2_normalize(temb), l2_normalize(iemb)
    g_ssum = torch.tensor(0.37, device=dev)
    for tb in (4, TRAIN_BATCH):
        score = torch.randn(tb, H, W, tc, device=dev)
        score[:, :2, :3] = 0.0                # zero-norm pixels
        label = torch.randint(-1, tk, (tb, H, W), device=dev,
                              dtype=torch.int32)
        label[-1] = -1                        # an all-ignore sample
        losses, hist, ssum, nv = ct.cos_tail_forward(score, label, temb_n,
                                                     iemb_n, tk)
        w_losses, w_hist, w_ssum = ct.cos_tail_plain(score, label, temb,
                                                     iemb, tk)
        g_losses = torch.randn(tb, device=dev)
        ds = ct.cos_tail_backward(score, label, temb_n, g_losses, nv, g_ssum)
        w_ds = ct.cos_tail_plain_backward(score, label, temb, iemb, tk,
                                          g_losses, g_ssum)
        torch.cuda.synchronize()
        k5_err = (losses - w_losses).abs().max().item()
        k6_err = (ds - w_ds).abs().max().item()
        k5_rel = ((losses - w_losses).abs()
                  / w_losses.abs().clamp(min=1e-30)).max().item()
        hflips = (hist - w_hist).abs().sum().item()
        log(f"[K5] B={tb} {H}x{W}: losses max|err| {k5_err:.3e} (max rel "
            f"{k5_rel:.3e}, bar 1e-5), ssum {ssum.item():.6e} vs "
            f"{w_ssum.item():.6e}, hist flips {hflips} of "
            f"{w_hist.sum().item()}; [K6] d score max|err| {k6_err:.3e}")
        require(torch.allclose(losses, w_losses, rtol=1e-5, atol=0),
                f"K5 losses {losses.tolist()} vs {w_losses.tolist()}")
        require(losses[-1].item() == 0.0, "K5: the all-ignore sample's loss")
        require(abs(ssum.item() - w_ssum.item())
                <= 1e-5 * abs(w_ssum.item()),
                f"K5 score sum {ssum.item()} vs {w_ssum.item()}")
        require(torch.equal(hist.sum(1), w_hist.sum(1)), "K5 hist row sums")
        require(hflips <= max(16, 0.005 * w_hist.sum().item()),
                f"K5 hist flips {hflips}")
        require(torch.allclose(ds, w_ds, rtol=2e-5, atol=2e-6),
                f"K6 d score max|err| {k6_err}")
        del score, label, ds, w_ds

    # ---- 9. the training slice ------------------------------------------
    def train_model(dtype, seed=0, dropout=0.5):
        gen = torch.Generator().manual_seed(seed)
        return FCN32s(20, dtype=dtype, fused_block1=True, generator=gen,
                      dropout_rate=dropout, device=dev)

    def train_batch(b, seed):
        r = np.random.RandomState(seed)
        return {"image": torch.from_numpy(
                    r.randn(b, H, W, 3).astype(np.float32) * 40).to(dev),
                "label": torch.from_numpy(
                    r.randint(-1, k_cls, (b, H, W)).astype(np.int32)).to(dev),
                "sizes": torch.full((b, 2), H, dtype=torch.int32, device=dev),
                "num_real": torch.tensor(b, device=dev)}

    step = make_fcn_train_step(loss_name="cos", num_classes=k_cls,
                               embeddings=embed)
    tmodel = train_model(torch.bfloat16)
    frozen = {n: p.detach().clone() for n, p in tmodel.named_parameters()
              if n.split(".")[0] in FROZEN_MODULES}
    watched = {n: p.detach().clone() for n, p in tmodel.named_parameters()
               if n in ("conv1_1.weight", "conv1_2.weight", "fc6.weight",
                        "score_fr.bias")}
    tstate = TrainState.create(
        tmodel, make_fcn_optimizer(tmodel, optim="adam", lr=1e-5))
    tgen = torch.Generator(device=dev).manual_seed(0)
    tbatch = train_batch(TRAIN_BATCH, 0)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    auxes = []
    for i in range(TRAIN_STEPS):
        # the last step runs with host syncs turned into errors: the step
        # must not wait for the device anywhere inside
        if i == TRAIN_STEPS - 1:
            torch.cuda.set_sync_debug_mode("error")
        try:
            tstate, aux = step(tstate, tbatch, tgen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        auxes.append(aux)
    torch.cuda.synchronize()
    tlaunches = dict(_kernels.launch_counts)
    log(f"[train] launches in {TRAIN_STEPS} steps: {tlaunches}")
    tlosses = [a["loss"].item() for a in auxes]
    log(f"[train] B={TRAIN_BATCH} losses {tlosses}, hist total "
        f"{[a['hist'].sum().item() for a in auxes]}, score_fr_grad_sum "
        f"{[a['score_fr_grad_sum'].item() for a in auxes]}")
    require(all(np.isfinite(x) for x in tlosses), f"losses {tlosses}")
    for key in ("block1_train_fwd", "block1_train_bwd", "costail_fwd",
                "costail_bwd"):
        require(tlaunches[key] > 0, f"{key} was not launched: {tlaunches}")
    require(tlaunches["block1_fused"] == 0,
            f"K2 ran under training: {tlaunches}")
    params_now = dict(tmodel.named_parameters())
    for n, before in watched.items():
        require(not torch.equal(params_now[n].detach(), before),
                f"{n} did not change in {TRAIN_STEPS} steps")
    for n, before in frozen.items():
        require(torch.equal(params_now[n].detach(), before),
                f"frozen {n} changed")

    # one fp32 step at B=2 through the kernels and through the plain
    # versions, same weights and dropout masks
    def fp32_step(plain: bool):
        m = train_model(torch.float32, seed=1)
        st = TrainState.create(m, make_fcn_optimizer(m, optim="adam",
                                                     lr=1e-5))
        gen = torch.Generator(device=dev).manual_seed(1)
        with plain_training() if plain else contextlib.nullcontext():
            _, aux = step(st, train_batch(2, 1), gen)
        grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()
                 if p.grad is not None}
        del m, st
        return aux, grads

    aux_k, grads_k = fp32_step(False)
    aux_p, grads_p = fp32_step(True)
    torch.cuda.synchronize()
    grad_rels = {n: rel(grads_k[n], grads_p[n]) for n in grads_p}
    worst = max(grad_rels, key=grad_rels.get)
    hk, hp = aux_k["hist"], aux_p["hist"]
    log(f"[train] fp32 B=2 kernels vs plain: loss {aux_k['loss'].item():.7f} "
        f"vs {aux_p['loss'].item():.7f}, hist flips "
        f"{(hk - hp).abs().sum().item()}, worst gradient rel-norm "
        f"{grad_rels[worst]:.3e} ({worst}); "
        + ", ".join(f"{n} {r:.1e}" for n, r in grad_rels.items()))
    # measured bar: kernels and cuDNN sum in different orders; on an H100
    # the fp32 gradients agreed to 6.3e-6 in norm at worst (conv1_2.weight,
    # the others below 1.1e-6); 1e-4 leaves room for a first-max window of
    # the pool routing that flips between the two
    grad_bar = 1e-4
    require(set(grads_k) == set(grads_p), "gradient sets differ")
    require(abs(aux_k["loss"].item() - aux_p["loss"].item())
            <= 1e-5 * abs(aux_p["loss"].item()), "fp32 step loss")
    require(torch.equal(hk.sum(1), hp.sum(1)), "fp32 step hist row sums")
    require((hk - hp).abs().sum().item() <= max(16, 0.005 * hp.sum().item()),
            "fp32 step hist flips")
    require(grad_rels[worst] < grad_bar,
            f"fp32 step gradient {worst} rel {grad_rels[worst]}")
    del grads_k, grads_p

    # ---- 10. training times ---------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(tstate, tbatch, tgen), iters=TIMED_STEPS,
                      warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    img_s = TRAIN_BATCH / (step_ms / 1e3)
    log(json.dumps({"train": {"batch": TRAIN_BATCH, "hw": [H, W],
                              "dtype": "bfloat16", "ms_per_step": step_ms,
                              "images_per_s": img_s,
                              "max_memory_allocated_gb": peak_gb,
                              "steps_timed": TIMED_STEPS}}))
    del tstate, tmodel, tbatch

    bf = torch.bfloat16
    wts = b1_weights()
    xp = torch.randn(TRAIN_BATCH, H + 10, W + 10, 3, device=dev)
    c11 = c11_from(xp, wts, bf)
    del xp
    k2t, b2f = wts[2].to(bf), wts[3]
    g = torch.randn(TRAIN_BATCH, H // 2 + 3, W // 2 + 3, 64, device=dev,
                    dtype=bf)
    k3_ms = time_ms(lambda: b1.conv2_pool(c11, k2t, b2f), iters=5)
    k3_plain_ms = time_ms(lambda: b1.conv2_pool_plain(c11, k2t, b2f),
                          iters=3)
    k4_ms = time_ms(lambda: b1.conv2_pool_backward(c11, k2t, b2f, g),
                    iters=3)
    k4_plain_ms = time_ms(
        lambda: b1.conv2_pool_plain_backward(c11, k2t, b2f, g), iters=2)
    # library yardsticks: the bf16 cuDNN conv1_2 + bias + ReLU + max-pool
    # sequence, and autograd's backward of it
    cl = c11.permute(0, 3, 1, 2).detach().requires_grad_()
    k2l = k2t.detach().requires_grad_()
    b2l = b2f.to(bf).detach().requires_grad_()

    def lib_fwd():
        return F.max_pool2d(torch.relu(F.conv2d(cl, k2l, b2l)), 2, 2)

    with torch.no_grad():
        k3_lib_ms = time_ms(lib_fwd, iters=5)
    lib_out = lib_fwd()
    gl = g.permute(0, 3, 1, 2)
    k4_lib_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (cl, k2l, b2l), gl, retain_graph=True), iters=3)
    del lib_out, cl
    hc = H + 8
    ho = hc - 2
    conv_ops = 2 * TRAIN_BATCH * ho * ho * 576 * 64
    c11_bytes, out_bytes = c11.numel() * 2, g.numel() * 2
    k3_bound = 1e3 * max((c11_bytes + out_bytes) / PEAK_BYTES_S,
                         conv_ops / PEAK_BF16_FLOP_S)
    k3_by = ("bytes" if (c11_bytes + out_bytes) / PEAK_BYTES_S
             >= conv_ops / PEAK_BF16_FLOP_S else "operations")
    k4_bytes = 2 * c11_bytes + out_bytes
    k4_bound = 1e3 * max(k4_bytes / PEAK_BYTES_S,
                         3 * conv_ops / PEAK_BF16_FLOP_S)
    k4_by = ("bytes" if k4_bytes / PEAK_BYTES_S
             >= 3 * conv_ops / PEAK_BF16_FLOP_S else "operations")
    del c11, g

    score = torch.randn(TRAIN_BATCH, H, W, tc, device=dev)
    label = torch.randint(-1, tk, (TRAIN_BATCH, H, W), device=dev,
                          dtype=torch.int32)
    temb = torch.from_numpy(embed).to(dev)
    temb_n = l2_normalize(temb)
    _, _, _, nv = ct.cos_tail_forward(score, label, temb_n, temb_n, tk)
    g_losses = torch.randn(TRAIN_BATCH, device=dev)
    k5_ms = time_ms(lambda: ct.cos_tail_forward(score, label, temb_n,
                                                temb_n, tk), iters=10)
    k5_plain_ms = time_ms(lambda: ct.cos_tail_plain(score, label, temb,
                                                    temb, tk), iters=2)
    k6_ms = time_ms(lambda: ct.cos_tail_backward(score, label, temb_n,
                                                 g_losses, nv, g_ssum),
                    iters=10)
    k6_plain_ms = time_ms(lambda: ct.cos_tail_plain_backward(
        score, label, temb, temb, tk, g_losses, g_ssum), iters=2)
    pix = TRAIN_BATCH * H * W
    k5_bytes = score.numel() * 4 + label.numel() * 4 + 2 * tk * tc * 4
    k5_ops = pix * (5 * tc + 2 * tk * tc)
    k6_bytes = 2 * score.numel() * 4 + label.numel() * 4 + tk * tc * 4
    k6_ops = pix * 9 * tc
    del score, label

    def bound(nbytes, ops, peak):
        t_b, t_o = nbytes / PEAK_BYTES_S, ops / peak
        return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

    k5_bound, k5_by = bound(k5_bytes, k5_ops, PEAK_FP32_FLOP_S)
    k6_bound, k6_by = bound(k6_bytes, k6_ops, PEAK_FP32_FLOP_S)
    log(f"[times] K3 {k3_ms:.3f} ms (plain {k3_plain_ms:.3f}, cuDNN "
        f"{k3_lib_ms:.3f}, bound {k3_bound:.3f}); K4 {k4_ms:.3f} ms (plain "
        f"{k4_plain_ms:.3f}, cuDNN {k4_lib_ms:.3f}, bound {k4_bound:.3f}); "
        f"K5 {k5_ms:.4f} ms (plain {k5_plain_ms:.3f}, bound "
        f"{k5_bound:.4f}); K6 {k6_ms:.4f} ms (plain {k6_plain_ms:.3f}, "
        f"bound {k6_bound:.4f})")

    src = "zeroshotsemanticsegmentation_tpu_torch/csrc/"
    ref = "zeroshotsemanticsegmentation_tpu/ops/"
    kernels = [
        {"name": "szn_fused_labels", "route": "cuda",
         "source": src + "szn_fused.cu",
         "replaces": ref + "szn_fused.py:44",
         "launches": launches["szn_fused"], "max_abs_err": k1_maxerr,
         "flip_rate": k1_flips, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "shape": [SERVE_BATCH, 17, 17, kp1, H, W]},
        {"name": "block1_fused_forward", "route": "cuda",
         "source": src + "block1_fused.cu",
         "replaces": ref + "block1_fused.py:485",
         "launches": launches["block1_fused"], "max_abs_err": k2_bf16_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib_ms,
         "shape": [SERVE_BATCH, H + 10, W + 10, 3], "dtype": "bfloat16"},
        {"name": "block1_train_forward", "route": "cuda",
         "source": src + "block1_train.cu",
         "replaces": ref + "block1_fused.py:288",
         "launches": tlaunches["block1_train_fwd"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": k3_lib_ms,
         "shape": [TRAIN_BATCH, hc, hc, 64], "dtype": "bfloat16"},
        {"name": "block1_train_backward", "route": "cuda",
         "source": src + "block1_train.cu",
         "replaces": ref + "block1_fused.py:676",
         "launches": tlaunches["block1_train_bwd"], "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
         "bound_by": k4_by, "library_ms": k4_lib_ms,
         "shape": [TRAIN_BATCH, hc, hc, 64], "dtype": "bfloat16"},
        {"name": "costail_forward", "route": "cuda",
         "source": src + "costail_fused.cu",
         "replaces": ref + "costail_fused.py:108",
         "launches": tlaunches["costail_fwd"], "max_abs_err": k5_err,
         "ms": k5_ms, "plain_ms": k5_plain_ms, "bound_ms": k5_bound,
         "bound_by": k5_by, "library_ms": None,
         "shape": [TRAIN_BATCH, H, W, tc, tk]},
        {"name": "costail_backward", "route": "cuda",
         "source": src + "costail_fused.cu",
         "replaces": ref + "costail_fused.py:145",
         "launches": tlaunches["costail_bwd"], "max_abs_err": k6_err,
         "ms": k6_ms, "plain_ms": k6_plain_ms, "bound_ms": k6_bound,
         "bound_by": k6_by, "library_ms": None,
         "shape": [TRAIN_BATCH, H, W, tc, tk]},
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
