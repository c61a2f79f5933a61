#!/usr/bin/env python3
"""Runs the PyTorch port's SZN serving, stage-1 and stage-2 training and
eval paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or ends the script with a non-zero exit:

1. device: needs CUDA; prints the card's name and power limit (nvidia-smi);
   TF32 off for the parity phases;
2. build: compiles the CUDA kernels from zeroshotsemanticsegmentation_tpu_torch
   /csrc with nvcc (sm_90a) and prints the build time and ptxas's summary;
   per block1_train, block1_fused and pdot kernel its registers, static
   shared memory, spills and, where cuobjdump exists, its HGMMA count (each
   bf16 wgmma kernel > 0: K3/K4's four, K2's block1_fused_wgmma, K7's
   pdot_tma and pdot_narrow instances, K8's conv1_1_wgmma), and the same
   for K5/K6's and K1's instances (szn_labels_kernel<22>, <34>, <0>);
3. the SZN-labels kernel (K1) vs its plain version at the serving shapes
   (B=8, K=21, C=20, 17x17 heads, 512x512), at the context width (K=33,
   C=300), at the edge cases of the JAX package's tests (zero-norm pixels,
   a zeroed embedding row, all-negative similarities) and on tie-heavy
   inputs on a 1/8 grid (K = 9, 21, 33, 70; duplicated and all-zero
   classes, gates of 0, all classes negative, empty partitions); one
   launch a call, two calls bit-equal;
4. the fused block-1 kernel (K2; bf16 on wgmma) vs its plain version at
   (2, 522, 522, 3) in fp32 and bf16, at the odd 375x500 geometry of the
   pruned path, and in bf16 at the serving batch (64, 522, 522, 3), where
   two calls must be bit-equal; fp32 also vs an fp64 plain version;
5. the slice: a full-width FCN-32s (20-dim embeddings, seeded random
   weights) served through make_szn_predictor with the bundled pascal
   embeddings and unseen classes [1, 13]; a few requests (float32 512x512,
   uint8, 500x375), both kernels' launch counts, labels vs the same predictor
   through the plain versions (fp32), vs the unfused full-resolution NNE
   reference, and the trained-upscore route; the serving bf16 bar
   (scripts/torch_serving_bar.py): bf16 labels through the kernels at most
   2x as far (flip rate) from the fp32 labels as bf16 labels with block 1
   through its plain version;
6. times with CUDA events: the predictor at B=64, 512x512, bf16, and each
   kernel at its serving shape beside its plain version and its bound; K1
   also by device time, with its share of the byte bound and of the issue
   floor (5 lane-instructions a class and pixel at the card's SM clock,
   logged only), and on the SZN and NNE routes at B=64 and B=16 at every
   band height `k1_plan` can choose (labels equal to the plan's);
7. the block-1 training kernels (K3 forward, K4 backward) vs their plain
   versions on c11 from (2, 522, 522, 3), from the odd 375x500 geometry
   (386x510) and from the train step's (24, 522, 522, 3), fp32 with TF32
   off and bf16; at B=24 in fp32 both K4 and its plain version also vs an
   fp64 autograd reference; in bf16 (the wgmma kernels) the route vs K3
   (with g = 1 one 1 in each window where K3's output is > 0, zeros where
   it is 0) and two K4 calls bit-equal;
8. the fused cosine tail (K5 forward, K6 backward) vs its plain versions at
   B=4 and at the train step's B=24, 512x512, C=20, K=21 with ignore
   labels, an all-ignore sample, a zeroed embedding row and zero-norm
   pixels; at the wider bundled tables, C=50 (pascal, K=21, B=24) and
   C=300 (context, K=33, B=8); at the odd 353x375 geometry with C=21
   (B=2: the tensor's end a plain-load tail); and with spatially coherent
   labels (constant over 32x32 patches, scores the target row plus noise,
   B=4, C=20); two calls of each bit-equal;
9. the training slice: a full-width bf16 FCN-32s (fused block 1, support
   pruning, seeded random weights) trained by make_fcn_train_step (cos
   loss, fused tail, Adam lr 1e-5, dropout 0.5 from a seeded CUDA
   generator) for a few steps at B=24, 512x512 with the bundled pascal
   embeddings, the last step with host syncs turned into errors; the
   launch counts of K3-K6 (and none of K2); then one fp32
   step at B=2 through the kernels vs the same step through the plain
   versions; then the bf16 bar: the same B=2 step in bf16 through the
   kernels and in bf16 with K3/K4 through their plain versions, each
   parameter's gradient vs the fp32 step's, the kernels' error at most 2x
   the plain versions';
10. times with CUDA events: the train step at B=24, 512x512, bf16 (the JAX
   package's bench_train configuration), its peak memory, and K3-K6 at the
   step's shapes beside their plain versions, bounds and library calls
   (K5/K6 by CUDA events and by device time with the share of the bound
   reached, K5 also with coherent labels, both also at C=300, K=33), K4's
   route, dK2 + reduction and d(c11) steps each alone;
11. the matmul kernel (K7) vs its plain version at the four products the
   dot-free model runs at B=24 (bf16 in, fp32 out) and at ragged tma
   shapes, fp32 at the fc7 shape and at the JAX tests' edge shapes vs an
   fp64 product; each product's variant (tma, narrow, wmma, fp32) logged
   with its own launch count, two calls bit-equal; its times (also by
   device time alone, as torch.matmul's);
12. stage 1 under the dot-free mode: three B=24 steps from phase 9's
   weights, batch and generator seed; K7 exactly 3 launches per step (two
   tma, one narrow), K3-K6 one each; one fp32 step at B=2 with the mode on
   vs off (K7 vs cuBLAS / cuDNN) at phase 9's gradient bar;
13. stage 2: make_seenmask_train_step with make_seenmask_optimizer at B=24,
   512x512, bf16, full width, dropout 0.5, with the dot-free mode off and
   on: K7 (narrow) once per step only with it on, K2 once per step and
   K3/K4 never (no backbone backward), finite losses, the seenmask head
   and upscore moved and every other parameter bit-identical, the last
   step with host syncs turned into errors; its time and peak memory per
   mode;
14. the fcn and szn eval steps, unfused and fused, at B=16, 512x512: in
   fp32 K1 once per fused call and the fused labels' flip rate vs the
   unfused ones < 1e-4; in bf16 K2 once per fused call; their times in
   bf16;
15. times: the stage-1 step in the default and dot-free modes in turns,
   stage 2, the eval steps, and K7 at each product beside its plain
   version, torch.matmul and its bound;
16. conv1_1 alone (K8; bf16 on wgmma with TMA stores) vs its plain version
   at the JAX tests' shapes and at the block-1 bench's (16, 530, 530, 3),
   one launch a call, two calls bit-equal: fp32 (TF32 off) max |err| <=
   1e-5; bf16 within one bf16 ulp, |a - b| <= 2^-7 max(|a|, |b|) + 1e-6
   elementwise, at most 1e-3 of the elements differing (logged), and a max
   relative error vs an fp32 conv1_1 of the same rounded inputs at most 2x
   the plain version's; K8 -> K3 vs the
   plain block 1 in fp32 (atol 1e-4); then scripts/torch_bench_block1.py's
   `run`: each variant's launches with the counts at 0 before it (K8 once
   in the two-stage forward), and K8's time beside its plain version, the
   cuDNN conv1_1 + bias + ReLU and its bound, all from that run;
17. the first-max pool backward (K9) vs its plain version, exactly, in fp32
   and bf16 with the JAX test's three input kinds and odd extents through
   `ceil_max_pool_2x2`, and vs F.max_pool2d's autograd; the four pool
   inputs of blocks 2-5 of the stage-1 step at B=24, 512x512 (read off the
   model) through `ceil_max_pool_2x2` with the counts at 0 before it, K9
   and that pass's dx equal to the plain version there; K9's times there
   beside its plain version, F.max_pool2d's backward and its bound;
18. the row dot (K10b) vs its plain version at (8, 512, 512, 21) and at odd
   small shapes (rtol 1e-6, atol 1e-6), K7 at the probe's 512x512 fp32
   product vs an fp64 product (relative norm < 1e-5), and their times
   beside plain versions, torch.linalg.vecdot / torch.matmul and bounds
   (the 512x512 product and torch.matmul also by device time alone);
19. scripts/torch_probe_h2d.py pallas_dot rowdot_pl, one fresh process per
   mode: exit code 0, one JSON line per mode, K7 (K10a) and K10b launched,
   the bandwidths logged;
20. the train CLI on the card: `cli.train.main(["-c", "14", "--synthetic",
   "-ve", "1", "-se", "1", ...])` at full width, bf16, the preset's batch
   sizes (num_viz set to 0 through run_experiment's cfg: the card's machine
   has no Pillow), its files, finite losses and the launch counts computed
   from the loaders' lengths (K3-K6 once a stage-1 step, K2 once a stage-2
   step and once a validation batch, K1 once a stage-1 validation batch,
   K7 never); a resume (`-r <log_dir>/checkpoint -ve 2 -se 0`) with the
   parameters and Adam's moments bit-equal to the file, starting at stage
   1's step count, and one more epoch; one loop timing of FCNTrainer at
   B=24, 512x512, the compact feed, 40 steps after a warm-up with host
   syncs turned into errors between log flushes (two flushes inside the
   epoch): its img/s over the epoch and in the steady window after the
   first step, beside the bare step on the same trainer and phase 10's,
   the loader's first batch and rate alone, the save time of one
   checkpoint and the peak memory.

The last line of standard output is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import os.path as osp
import re
import shutil
import signal
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
TRAIN_STEPS = 3        # phases 9 and 12, after which timed steps follow
STAGE2_STEPS = 3       # phase 13, per dot-free mode
TIMED_STEPS = 5
EVAL_BATCH = 16
UNSEEN = [1, 13]
# K7's products in the dot-free model at B=24, 512x512 (24 * 17^2 = 6936
# fc6 output pixels): (name, M, K, N, trans_a)
PDOT_SHAPES = (("fc6_input_grad", 6936, 4096, 25088, False),
               ("fc7_weight_grad", 4096, 6936, 4096, True),
               ("score_fr_weight_grad", 4096, 6936, 20, True),
               ("seenmask_score_weight_grad", 4096, 6936, 2, True))
# the edge shapes of the JAX package's tests/test_pdot.py: (M, K, N)
PDOT_EDGES = ((8, 128, 128), (17, 21, 33), (130, 257, 140), (1, 300, 1))
# aligned products with ragged M, N and K tiles: the tma variant, and wmma
# for the trans_a operand whose rows are not 16-byte aligned (M = 300)
PDOT_RAGGED = ((300, 1000, 264), (512, 1000, 264))
# K8: the JAX test's shapes (tests/test_block1_fused.py:176) and the block-1
# bench's (scripts/bench_block1.py:16)
C11_SHAPES = ((2, 38, 42, 3), (2, 66, 34, 3), (16, 530, 530, 3))
ROWDOT_SHAPE = (8, H, W, 21)      # the probe's rowdot_pl inputs
LOOP_IMAGES = 960                  # phase 20's loop: 40 steps at B=24
LOOP_WARMUP_IMAGES = 96            # its warm-up epoch: 4 steps
PROBE_TIMEOUT_S = 420


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


def device_ms(fn, iters: int, name: str = "") -> float:
    """Device time of one call of `fn`: torch.profiler's summed device
    kernel time over `iters` calls (after a warm-up), per call, of the
    kernels whose name holds `name`. Unlike `time_ms` it leaves out the
    host's time between launches, which sets the event time of a product
    as small as the probe's. A window in which the profiler recorded no
    device time at all (it has happened once in a run that had profiled
    before) is profiled again, up to three windows; then the script
    fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if name in e.key)
        if total > 0:
            return total / 1e3 / iters
        log(f"[profiler] no device time recorded for {name or 'the call'}; "
            "profiling again")
    fail(f"torch.profiler recorded no device time for {name or 'the call'} "
         "in three windows")


def card_line() -> str | None:
    """The card's name and power limit as nvidia-smi gives them, None if
    it fails."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else None


def rel(a, b) -> float:
    """Relative Frobenius norm of a - b against b, in fp64."""
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def bound(nbytes: float, ops: float, peak: float):
    """(least ms on the card, what bounds it) for `nbytes` moved and `ops`
    done at `peak` operations per second."""
    t_b, t_o = nbytes / PEAK_BYTES_S, ops / peak
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def phase_pdot(dev, pd, kernels, log, require) -> list:
    """Phase 11: K7 vs its plain version at the dot-free model's four
    shapes (bf16 in, fp32 out; the plain version is cuBLAS's fp32 product
    of the same rounded inputs, TF32 off: rtol 1e-4, atol 1e-3 of the
    output's root-mean-square), at ragged tma shapes, fp32 at the fc7 shape
    and the edge shapes vs an fp64 product (relative Frobenius norm <
    1e-5); each product's variant (`pdot_plan`) with its own launch count,
    two calls bit-equal; each path shape's times beside the plain version,
    torch.matmul and the bound."""
    import torch

    def operands(m, k, n, trans, dtype):
        a = torch.randn(*((k, m) if trans else (m, k)), device=dev)
        return a.to(dtype), torch.randn(k, n, device=dev).to(dtype)

    def bf16_check(name, a, b, trans):
        plan = pd.plan_for(a, b, trans_a=trans)
        key = "pdot_" + plan["variant"]
        before = kernels.launch_counts[key]
        got = pd.pdot(a, b, out_dtype=torch.float32, trans_a=trans)
        again = pd.pdot(a, b, out_dtype=torch.float32, trans_a=trans)
        want = pd.pdot_plain(a, b, out_dtype=torch.float32, trans_a=trans)
        torch.cuda.synchronize()
        launched = kernels.launch_counts[key] - before
        scale = (want.norm() / want.numel() ** 0.5).item()
        err, r = (got - want).abs().max().item(), rel(got, want)
        same = torch.equal(got, again)
        log(f"[K7] {name} bf16 (trans_a={trans}): {plan['variant']} "
            f"({plan['splits']} K splits), max|err| vs plain {err:.3e} (atol "
            f"{1e-3 * scale:.3e}, rtol 1e-4), rel-norm {r:.3e}, two calls "
            f"bit-equal: {same}")
        require(launched == 2, f"K7 {name}: {launched} {key} launches of 2")
        require(torch.allclose(got, want, rtol=1e-4, atol=1e-3 * scale),
                f"K7 {name} bf16 max|err| {err}")
        require(same, f"K7 {name} bf16: two calls differ")
        return err, r, plan

    rows = []
    for name, m, k, n, trans in PDOT_SHAPES:
        a, b = operands(m, k, n, trans, torch.bfloat16)
        err, r, plan = bf16_check(name, a, b, trans)
        a_lib = a.t() if trans else a
        ops = 2.0 * m * k * n
        b_ms, by = bound(a.numel() * 2 + b.numel() * 2 + m * n * 4, ops,
                         PEAK_BF16_FLOP_S)
        ms = time_ms(lambda: pd.pdot(a, b, out_dtype=torch.float32,
                                     trans_a=trans), iters=10)
        rows.append({
            "name": name, "m": m, "k": k, "n": n, "trans_a": trans,
            "variant": plan["variant"], "splits": plan["splits"],
            "ms": ms, "tflop_s": ops / ms / 1e9,
            "plain_ms": time_ms(lambda: pd.pdot_plain(
                a, b, out_dtype=torch.float32, trans_a=trans), iters=3),
            "library_ms": time_ms(lambda: torch.matmul(a_lib, b), iters=10),
            "device_ms": device_ms(lambda: pd.pdot(
                a, b, out_dtype=torch.float32, trans_a=trans), iters=10),
            "library_device_ms": device_ms(lambda: torch.matmul(a_lib, b),
                                           iters=10),
            "bound_ms": b_ms, "bound_by": by, "max_abs_err": err,
            "rel_norm": r, "bit_equal": True})
        log(f"[K7] {name} ({plan['variant']}): {ms:.4f} ms "
            f"({ops / ms / 1e9:.1f} TFLOP/s), plain "
            f"{rows[-1]['plain_ms']:.3f}, torch.matmul "
            f"{rows[-1]['library_ms']:.4f}, bound {b_ms:.4f} ({by}); device "
            f"time alone (profiler) {rows[-1]['device_ms']:.4f}, torch.matmul "
            f"{rows[-1]['library_device_ms']:.4f}")
        del a, b, a_lib
    for m, k, n in PDOT_RAGGED:
        for trans in (False, True):
            a, b = operands(m, k, n, trans, torch.bfloat16)
            bf16_check(f"{m}x{k}x{n}", a, b, trans)
    a, b = operands(4096, 6936, 4096, True, torch.float32)
    ref64 = a.double().t() @ b.double()
    r_k = rel(pd.pdot(a, b, trans_a=True), ref64)
    r_p = rel(pd.pdot_plain(a, b, trans_a=True), ref64)
    log(f"[K7] fc7 shape fp32 vs fp64: rel-norm {r_k:.3e} (plain, cuBLAS "
        f"fp32: {r_p:.3e}; bar 1e-5)")
    require(r_k < 1e-5, f"K7 fp32 fc7 shape rel {r_k}")
    del a, b, ref64
    for m, k, n in PDOT_EDGES:
        for trans in (False, True):
            a, b = operands(m, k, n, trans, torch.float32)
            a64 = a.double().t() if trans else a.double()
            got = pd.pdot(a, b, trans_a=trans)
            r_k = rel(got, a64 @ b.double())
            log(f"[K7] {m}x{k}x{n} fp32 (trans_a={trans}): "
                f"{pd.plan_for(a, b, trans_a=trans)}, rel-norm vs fp64 "
                f"{r_k:.3e} (bar 1e-5)")
            require(r_k < 1e-5, f"K7 fp32 {m}x{k}x{n} rel {r_k}")
            require(torch.equal(got, pd.pdot(a, b, trans_a=trans)),
                    f"K7 fp32 {m}x{k}x{n}: two calls differ")
            bf16_check(f"{m}x{k}x{n}", a.bfloat16(), b.bfloat16(), trans)
    return rows


def phase_eval(dev, model, train_batch, embed, uv, k_cls, log, require,
               flip_rate) -> dict:
    """Phase 14: the fcn and szn eval steps, unfused and fused, at
    B=EVAL_BATCH, 512x512: in fp32 the fused labels (K1, one launch per
    fused call) vs the unfused ones (flip rate < 1e-4), the same true-label
    histogram rows and loss; K2 once per fused bf16 call; then each step's
    ms per batch in bf16."""
    import torch
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
    from zeroshotsemanticsegmentation_tpu_torch.train import (
        make_fcn_eval_step, make_szn_eval_step)

    kw = dict(loss_name="cos", num_classes=k_cls, embeddings=embed,
              val_unseen_vec=uv)
    steps = {"fcn": (make_fcn_eval_step(**kw),
                     make_fcn_eval_step(**kw, fused=True)),
             "szn": (make_szn_eval_step(**kw, all_unseen_vec=uv),
                     make_szn_eval_step(**kw, all_unseen_vec=uv,
                                        fused=True))}
    ebatch = train_batch(EVAL_BATCH, 2)
    out = {"batch": EVAL_BATCH, "hw": [H, W], "k1_launches": 0}
    m32 = model(torch.float32)
    for name, (unfused, fused) in steps.items():
        _kernels.reset_launch_counts()
        a = unfused(m32, ebatch)
        torch.cuda.synchronize()
        require(_kernels.launch_counts["szn_fused"] == 0,
                f"{name} unfused eval launched K1")
        b = fused(m32, ebatch)
        torch.cuda.synchronize()
        k1 = _kernels.launch_counts["szn_fused"]
        out["k1_launches"] += k1
        fr = flip_rate(a["pred"], b["pred"])
        la, lb = a["loss_sum"].item(), b["loss_sum"].item()
        log(f"[eval] {name} fp32 B={EVAL_BATCH}: fused vs unfused flip rate "
            f"{fr:.3e}, loss sum {lb:.6f} vs {la:.6f}, K1 launches {k1}")
        require(k1 == 1, f"{name} fused eval: {k1} K1 launches")
        require(fr < 1e-4, f"{name} fused eval flip rate {fr}")
        require(np.isfinite(la) and abs(la - lb) <= 1e-5 * abs(la),
                f"{name} eval loss sums {la} vs {lb}")
        require(a["hists"].shape == (3, k_cls, k_cls)
                and torch.equal(a["hists"][0].sum(1), b["hists"][0].sum(1))
                and torch.equal(a["hists"][1] + a["hists"][2],
                                a["hists"][0]),
                f"{name} eval histograms")
    del m32
    mbf = model(torch.bfloat16)
    for name, (_, fused) in steps.items():  # bf16 block 1 on K2's wgmma path
        _kernels.reset_launch_counts()
        fused(mbf, ebatch)
        torch.cuda.synchronize()
        out[f"{name}_fused_bf16_k2_launches"] = k2 = \
            _kernels.launch_counts["block1_fused"]
        require(k2 == 1, f"{name} fused bf16 eval: {k2} K2 launches")
    for name, pair in steps.items():
        for suffix, fn in zip(("", "_fused"), pair):
            out[f"{name}{suffix}_ms_per_batch"] = time_ms(
                lambda: fn(mbf, ebatch), iters=3)
    return out


def kernel_build_stats(kernels, lib: str, names) -> dict:
    """Per kernel function of library `lib` named in `names`: registers,
    static shared memory and spill bytes from ptxas's -v summary, and,
    where cuobjdump is on the machine, the count of HGMMA (wgmma)
    instructions in its SASS. A template's instances are keyed
    `name<args>` (e.g. `pdot_tma<256,1>`)."""
    stats, fn = {}, None
    for line in kernels.build_logs.get(lib, "").splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            stats[fn] = {}
        elif fn and "spill stores" in line:
            stats[fn]["spill_bytes"] = sum(
                int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif fn and "registers" in line:
            words = line.replace(",", "").split()
            stats[fn]["registers"] = int(words[words.index("registers") - 1])
            stats[fn]["static_smem"] = (
                int(words[words.index("smem") - 2]) if "smem" in words else 0)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if osp.exists(tool):
        sass = subprocess.run([tool, "-sass", kernels._lib_path(lib)],
                              capture_output=True, text=True,
                              timeout=120).stdout
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                stats.setdefault(fn, {})["hgmma"] = 0
            elif fn and "HGMMA" in line:
                stats[fn]["hgmma"] += 1
    short = {}
    for mangled, st in stats.items():
        for name in names:
            tag = f"{len(name)}{name}"
            at = mangled.find(tag)
            if at < 0:
                continue
            rest = mangled[at + len(tag):]
            key = name
            if rest.startswith("I"):
                key += "<" + ",".join(re.findall(
                    r"L[a-z](\d+)E", rest[:rest.find("EE") + 2])) + ">"
            short.setdefault(key, {}).update(st)
            break
    return short


def load_script(name: str):
    """scripts/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        name, osp.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bf16_bar_misses(a, b) -> int:
    """Elements of two tensors of bf16 values more than one bf16 ulp apart:
    past 2^-7 max(|a|, |b|) + 1e-6 (the atol covers pre-ReLU sums near 0
    that the fp32 summation order puts on either side)."""
    a, b = a.float(), b.float()
    bar = 2.0 ** -7 * a.abs().maximum(b.abs()) + 1e-6
    return int(((a - b).abs() > bar).sum().item())


def phase_c11(dev, b1, kernels, log, require) -> dict:
    """Phase 16: K8 vs its plain version at C11_SHAPES in fp32 and bf16,
    one launch a call, K8 -> K3 vs the plain block 1 in fp32, then the
    block-1 bench's `run`: its launches per variant and K8's times. The
    bf16 bar: within one bf16 ulp elementwise, at most 1e-3 of the
    elements differing, and at most 2x as far from an fp32 conv1_1 of the
    same rounded inputs (TF32 off) as the plain version; two calls
    bit-equal."""
    import torch
    import torch.nn.functional as F

    out = {"max_abs_err_fp32": 0.0, "max_abs_err": 0.0, "differ_share": 0.0,
           "rel_err_vs_fp32": [], "bit_equal": True}
    for shape in C11_SHAPES:
        xp = torch.randn(*shape, device=dev) * 0.5
        k1 = torch.randn(64, 3, 3, 3, device=dev) * 0.1
        bias1 = torch.randn(64, device=dev) * 0.1
        for dtype in (torch.float32, torch.bfloat16):
            kernels.reset_launch_counts()
            got = b1.conv1_1_pairs(xp, k1, bias1, dtype)
            again = b1.conv1_1_pairs(xp, k1, bias1, dtype)
            torch.cuda.synchronize()
            n_k8 = kernels.launch_counts["conv1_1_pairs"]
            require(n_k8 == 2, f"K8: {n_k8} launches for two calls")
            want = b1.conv1_1_pairs_plain(xp, k1, bias1, dtype)
            torch.cuda.synchronize()
            require(got.shape == want.shape == (
                shape[0], shape[1] - 2, (shape[2] - 2) // 2, 128)
                and got.dtype == dtype, f"K8 output {tuple(got.shape)} "
                f"{got.dtype} at {shape}")
            equal = torch.equal(got, again)
            out["bit_equal"] &= equal
            require(equal, f"two K8 calls differ at {shape} {dtype}")
            err = (got.float() - want.float()).abs().max().item()
            if dtype == torch.float32:
                out["max_abs_err_fp32"] = max(out["max_abs_err_fp32"], err)
                log(f"[K8] {shape} fp32: max|err| vs plain {err:.3e} (bar "
                    f"1e-5)")
                require(err <= 1e-5, f"K8 fp32 error {err} at {shape}")
            else:
                misses = bf16_bar_misses(got, want)
                share = (got != want).float().mean().item()
                x = xp.to(dtype).float().permute(0, 3, 1, 2)
                ref = torch.relu(F.conv2d(x, k1.to(dtype).float(), bias1))
                ref = ref.permute(0, 2, 3, 1).reshape(got.shape)
                scale = ref.abs().max()
                e_k = ((got.float() - ref).abs().max() / scale).item()
                e_p = ((want.float() - ref).abs().max() / scale).item()
                del x, ref
                out["max_abs_err"] = max(out["max_abs_err"], err)
                out["differ_share"] = max(out["differ_share"], share)
                out["rel_err_vs_fp32"].append(
                    {"shape": list(shape), "kernel": e_k, "plain": e_p})
                log(f"[K8] {shape} bf16: max|err| vs plain {err:.3e}, "
                    f"share of elements differing {share:.3e} (bar 1e-3), "
                    f"{misses} past one bf16 ulp; max rel err vs fp32 "
                    f"conv1_1: kernel {e_k:.4e}, plain {e_p:.4e} (bar 2x)")
                require(misses == 0, f"K8 bf16: {misses} elements past the "
                        f"bar at {shape}")
                require(share <= 1e-3, f"K8 bf16: {share} of the elements "
                        f"differ at {shape}")
                require(e_k <= 2 * e_p, f"K8 bf16 vs fp32: {e_k} > 2x the "
                        f"plain version's {e_p} at {shape}")
            if dtype == torch.bfloat16 and shape == C11_SHAPES[-1]:
                x16 = xp.to(dtype)
                out["device_ms"] = device_ms(
                    lambda: b1.conv1_1_pairs(x16, k1, bias1, dtype), 20,
                    "conv1_1")
                log(f"[K8] {shape} bf16: {out['device_ms']:.4f} ms of "
                    f"device time (the kernel alone)")
                del x16
            del got, again, want
        del xp
    # the kernel refuses a tile plan that is not its own
    plan = b1.c11_tile_plan(2, 38, 42)
    with mock.patch.object(b1, "c11_tile_plan",
                           lambda *a: {**plan, "tile_m": 64}):
        try:
            b1.conv1_1_pairs(torch.zeros(2, 38, 42, 3, device=dev),
                             torch.zeros(64, 3, 3, 3, device=dev),
                             torch.zeros(64, device=dev), torch.bfloat16)
            refused = False
        except RuntimeError:
            refused = True
    require(refused, "K8 launched on a tile plan that is not its own")
    # K8 -> K3 vs the plain block 1, fp32
    for shape in (C11_SHAPES[1], C11_SHAPES[2]):
        xp = torch.randn(*shape, device=dev) * 0.5
        wts = (torch.randn(64, 3, 3, 3, device=dev) * 0.1,
               torch.randn(64, device=dev) * 0.1,
               torch.randn(64, 64, 3, 3, device=dev) * 0.05,
               torch.randn(64, device=dev) * 0.1)
        c11 = b1.conv1_1_pairs(xp, wts[0], wts[1], torch.float32)
        got = b1.conv2_pool(c11.view(shape[0], shape[1] - 2, shape[2] - 2, 64),
                            wts[2], wts[3])
        with torch.inference_mode():
            want = b1.block1_plain(xp, *wts, torch.float32)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        log(f"[K8] -> [K3] {shape} fp32 vs plain block 1: max|err| "
            f"{err:.3e} (bar 1e-4)")
        require(got.shape == want.shape and err <= 1e-4,
                f"K8 -> K3 vs plain block 1: {err} at {shape}")
        del xp, c11, got, want
    # the block-1 bench entry point: every variant's launches (counts at 0
    # just before its warm-up call) and times
    bench = load_script("torch_bench_block1")
    res = bench.run(iters=20, log=lambda m: log(f"[bench] {m}"))
    want = {bench.K8: {"conv1_1_pairs": 1}, bench.PLAIN_C11: {},
            bench.CUDNN_C11: {},
            "K8 -> K3": {"conv1_1_pairs": 1, "block1_train_fwd": 1},
            "cuDNN conv1_1 -> K3": {"block1_train_fwd": 1},
            "plain block 1": {}, "K2 (one kernel)": {"block1_fused": 1}}
    require(res["launches"] == want, f"the bench's launches: "
            f"{res['launches']}, expected {want}")
    ms = res["ms"]
    out.update(launches=res["launches"]["K8 -> K3"]["conv1_1_pairs"],
               ms=ms[bench.K8], plain_ms=ms[bench.PLAIN_C11],
               library_ms=ms[bench.CUDNN_C11],
               shape=[bench.B, bench.HP, bench.WP, 3], bench_ms=ms)
    n, ho, wo = bench.B, bench.HP - 2, bench.WP - 2
    nbytes = n * bench.HP * bench.WP * 3 * 2 + n * ho * wo * 64 * 2 \
        + 28 * 64 * 4
    ops = 2.0 * n * ho * wo * 64 * 27
    out["bound_ms"], out["bound_by"] = bound(nbytes, ops, PEAK_BF16_FLOP_S)
    log(f"[K8] {tuple(out['shape'])} bf16 (the bench's run): {out['ms']:.4f}"
        f" ms ({nbytes / out['ms'] / 1e6:.0f} GB/s), plain "
        f"{out['plain_ms']:.3f}, cuDNN conv1_1+bias+ReLU "
        f"{out['library_ms']:.4f}, bound {out['bound_ms']:.4f} "
        f"({out['bound_by']})")
    return out


def phase_pool(dev, model, kernels, log, require) -> dict:
    """Phase 17: K9 vs its plain version and vs F.max_pool2d's autograd,
    exactly; the four pool inputs of blocks 2-5 of the B=TRAIN_BATCH
    stage-1 step through `ceil_max_pool_2x2` with the counts at 0 before
    it, K9 and that pass's dx equal to the plain version there; K9's times
    there."""
    import torch
    import torch.nn.functional as F
    from zeroshotsemanticsegmentation_tpu_torch.ops import pool_bwd as pb

    def inputs(kind, shape, dtype):
        if kind == "dense_ties":
            x = torch.randint(0, 3, shape, device=dev).float()
        elif kind == "relu_zeros":
            x = torch.randn(*shape, device=dev).clamp(min=0)
            x[x < 0.5] = 0.0
        else:
            x = torch.randn(*shape, device=dev)
        return x.to(dtype)

    def through_autograd(x, g):
        xs = x.clone().requires_grad_()
        y = pb.ceil_max_pool_2x2(xs)
        (dx,) = torch.autograd.grad(y, xs, g)
        return y.detach(), dx

    def library(x, g):
        xl = x.permute(0, 3, 1, 2).clone().requires_grad_()
        yl = F.max_pool2d(xl, 2, 2, ceil_mode=True)
        (dl,) = torch.autograd.grad(yl, xl, g.permute(0, 3, 1, 2))
        return yl.detach().permute(0, 2, 3, 1), dl.permute(0, 2, 3, 1)

    checked = 0
    lib_ok = True
    for dtype in (torch.float32, torch.bfloat16):
        for kind in ("dense_ties", "relu_zeros", "smooth"):
            for shape in ((2, 64, 80, 64), (2, 33, 47, 40), (1, 7, 9, 3)):
                x = inputs(kind, shape, dtype)
                gshape = (shape[0], -(-shape[1] // 2), -(-shape[2] // 2),
                          shape[3])
                g = torch.randn(*gshape, device=dev).to(dtype)
                y, dx = through_autograd(x, g)
                xp = pb._pad(x, shape[1] % 2, shape[2] % 2)
                want = pb.pool_bwd_plain(xp, y, g)[:, :shape[1], :shape[2]]
                require(torch.equal(dx, want), f"K9 vs plain {kind} {dtype} "
                        f"{shape}: {int((dx != want).sum())} elements differ")
                yl, dl = library(x, g)
                require(torch.equal(y, yl), f"pool forward vs F.max_pool2d "
                        f"{kind} {dtype} {shape}")
                if not torch.equal(dx, dl):
                    lib_ok = False
                    log(f"[K9] {kind} {dtype} {shape}: F.max_pool2d's "
                        f"backward routes {int((dx != dl).sum())} elements "
                        f"otherwise")
                checked += 1
    log(f"[K9] {checked} cases equal to the plain version; F.max_pool2d's "
        f"autograd {'equal in every case' if lib_ok else 'differs'}")
    require(lib_ok, "K9 vs F.max_pool2d's autograd")

    # the pool inputs of blocks 2-5, read off a B=2 forward of the model
    seen = []
    orig = F.max_pool2d

    def record(x, *a, **k):
        if x.shape[0] == 2:
            seen.append(tuple(x.shape))
        return orig(x, *a, **k)

    with mock.patch.object(F, "max_pool2d", record), torch.inference_mode():
        model(torch.bfloat16)(torch.randn(2, H, W, 3, device=dev) * 40,
                              mode="raw")
    # blocks 2-5: the last four pools (block 1 pools inside K2)
    shapes = [(TRAIN_BATCH, h, w, c) for _, c, h, w in seen[-4:]]
    log(f"[K9] pool inputs of blocks 2-5 of the stage-1 step (NHWC): "
        f"{shapes}")
    require(len(shapes) == 4 and shapes[0][3] == 128,
            f"expected the four pools of blocks 2-5: {seen}")

    bf = torch.bfloat16
    xs_all = [torch.randn(*s, device=dev).clamp(min=0).to(bf).requires_grad_()
              for s in shapes]
    gs_all = [torch.randn(s[0], -(-s[1] // 2), -(-s[2] // 2), s[3],
                          device=dev).to(bf) for s in shapes]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    ys_all = []
    for x, g in zip(xs_all, gs_all):
        y = pb.ceil_max_pool_2x2(x)
        y.backward(g)
        ys_all.append(y.detach())
    torch.cuda.synchronize()
    launches = kernels.launch_counts["pool_bwd"]
    log(f"[K9] stage-1 pool shapes through ceil_max_pool_2x2: {launches} "
        f"K9 launches")
    require(launches == len(shapes), f"K9 launches {launches}")
    rows = []
    max_err = 0.0
    for x, y, g in zip(xs_all, ys_all, gs_all):
        dx_path, x = x.grad, x.detach()
        h, w = x.shape[1:3]
        xp = pb._pad(x, h % 2, w % 2)
        got = pb.pool_bwd(xp, y, g)
        want = pb.pool_bwd_plain(xp, y, g)
        torch.cuda.synchronize()
        err = max((got.float() - want.float()).abs().max().item(),
                  (dx_path.float() - want[:, :h, :w].float()).abs().max()
                  .item())
        max_err = max(max_err, err)
        log(f"[K9] {tuple(xp.shape)} bf16: K9 and the counted backward's dx "
            f"vs plain, max|err| {err:.3e} (bar: equal)")
        require(torch.equal(got, want)
                and torch.equal(dx_path, want[:, :h, :w]),
                f"K9 vs plain at {tuple(xp.shape)}: {int((got != want).sum())}"
                f" elements differ, the counted backward's dx "
                f"{int((dx_path != want[:, :h, :w]).sum())}")
        del got, want, dx_path
        xl = x.permute(0, 3, 1, 2).requires_grad_()
        yl = F.max_pool2d(xl, 2, 2, ceil_mode=True)
        gl = g.permute(0, 3, 1, 2)
        b_ms, by = bound(2.5 * xp.numel() * 2, xp.numel(), PEAK_FP32_FLOP_S)
        row = {"shape": list(xp.shape), "dtype": "bfloat16",
               "max_abs_err": err,
               "ms": time_ms(lambda: pb.pool_bwd(xp, y, g), iters=20),
               "plain_ms": time_ms(lambda: pb.pool_bwd_plain(xp, y, g),
                                   iters=3),
               "library_ms": time_ms(lambda: torch.autograd.grad(
                   yl, xl, gl, retain_graph=True), iters=20),
               "bound_ms": b_ms, "bound_by": by}
        rows.append(row)
        log(f"[K9] {tuple(xp.shape)}: {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.3f}, F.max_pool2d backward "
            f"{row['library_ms']:.4f}, bound {b_ms:.4f} ({by})")
        del xl, yl, gl
    return {"launches": launches, "max_abs_err": max_err, "shapes": rows,
            "cases": checked}


def phase_rowdot(dev, rd, pd, log, require) -> dict:
    """Phase 18: K10b vs its plain version, K7 at the probe's 512x512 fp32
    product vs fp64, and both kernels' times."""
    import torch

    out = {}
    for shape in (ROWDOT_SHAPE, (3, 5, 7, 1), (1, 3, 5, 300), (2, 9, 11, 33)):
        a = torch.randn(*shape, device=dev)
        b = torch.randn(*shape, device=dev)
        got, want = rd.rowdot(a, b), rd.rowdot_plain(a, b)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        log(f"[K10b] {shape}: max|err| vs plain {err:.3e} (rtol 1e-6, atol "
            f"1e-6)")
        require(got.shape == shape[:-1]
                and torch.allclose(got, want, rtol=1e-6, atol=1e-6),
                f"K10b vs plain at {shape}: {err}")
        if shape == ROWDOT_SHAPE:
            out["max_abs_err"] = err
            out["ms"] = time_ms(lambda: rd.rowdot(a, b), iters=20)
            out["plain_ms"] = time_ms(lambda: rd.rowdot_plain(a, b), iters=3)
            out["library_ms"] = time_ms(lambda: torch.linalg.vecdot(a, b),
                                        iters=20)
            nbytes = 2 * a.numel() * 4 + got.numel() * 4
            out["bound_ms"], out["bound_by"] = bound(
                nbytes, 2.0 * a.numel(), PEAK_FP32_FLOP_S)
            out["shape"] = list(shape)
            log(f"[K10b] {shape}: {out['ms']:.4f} ms ({nbytes / out['ms'] / 1e6:.0f}"
                f" GB/s), plain {out['plain_ms']:.3f}, torch.linalg.vecdot "
                f"{out['library_ms']:.4f}, bound {out['bound_ms']:.4f} "
                f"({out['bound_by']})")
        del a, b, got, want
    a = torch.randn(512, 512, device=dev)
    b = torch.randn(512, 512, device=dev)
    got, want = pd.pdot(a, b), pd.pdot_plain(a, b)
    r = rel(got, a.double() @ b.double())
    err = (got - want).abs().max().item()
    plan = pd.plan_for(a, b)
    log(f"[K10a] 512x512 fp32 on K7 ({plan}): rel-norm vs fp64 {r:.3e} (bar "
        f"1e-5), max|err| vs plain {err:.3e}")
    require(r < 1e-5, f"K7 at 512x512 fp32: rel {r}")
    b_ms, by = bound(3 * 512 * 512 * 4, 2.0 * 512 ** 3, PEAK_FP32_FLOP_S)
    out["k10a"] = {
        "max_abs_err": err, "rel_norm": r, "shape": [512, 512, 512],
        "variant": plan["variant"], "splits": plan["splits"],
        "ms": time_ms(lambda: pd.pdot(a, b), iters=20),
        "plain_ms": time_ms(lambda: pd.pdot_plain(a, b), iters=20),
        "library_ms": time_ms(lambda: torch.matmul(a, b), iters=20),
        "device_ms": device_ms(lambda: pd.pdot(a, b), iters=20),
        "library_device_ms": device_ms(lambda: torch.matmul(a, b), iters=20),
        "bound_ms": b_ms, "bound_by": by}
    k = out["k10a"]
    log(f"[K10a] {k['ms']:.4f} ms, plain {k['plain_ms']:.4f}, torch.matmul "
        f"{k['library_ms']:.4f}, bound {b_ms:.4f} ({by}); device time alone "
        f"(profiler) {k['device_ms']:.4f} ms, torch.matmul "
        f"{k['library_device_ms']:.4f}")
    return out


def phase_probe(log, require) -> dict:
    """Phase 19: scripts/torch_probe_h2d.py pallas_dot rowdot_pl (a fresh
    process per mode), the whole process group killed past
    PROBE_TIMEOUT_S."""
    cmd = [sys.executable, osp.join(ROOT, "scripts", "torch_probe_h2d.py"),
           "pallas_dot", "rowdot_pl"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=PROBE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"the H2D probe ran past {PROBE_TIMEOUT_S} s")
    for line in stdout.splitlines():
        log(f"[probe] {line}")
    require(proc.returncode == 0, f"the H2D probe exited {proc.returncode}: "
            f"{stderr.strip().splitlines()[-5:]}")
    modes = {}
    for line in stdout.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            modes[rec["mode"]] = rec
    require(set(modes) == {"pallas_dot", "rowdot_pl"},
            f"probe modes {sorted(modes)}")
    require(modes["pallas_dot"]["launches"].get("pdot", 0) >= 1,
            f"pallas_dot did not launch K7: {modes['pallas_dot']}")
    require(modes["rowdot_pl"]["launches"].get("rowdot", 0) >= 1,
            f"rowdot_pl did not launch K10b: {modes['rowdot_pl']}")
    return modes


def _nested_equal(a, b) -> bool:
    """Bit equality of two nests of dicts, lists, tuples and tensors (the
    tensors compared on the CPU)."""
    import torch
    if torch.is_tensor(b):
        return torch.is_tensor(a) and a.dtype == b.dtype and torch.equal(
            a.detach().cpu(), b.detach().cpu())
    if isinstance(b, dict):
        return isinstance(a, dict) and set(a) == set(b) and all(
            _nested_equal(a[k], b[k]) for k in b)
    if isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(
            _nested_equal(x, y) for x, y in zip(a, b))
    return a == b


def phase_train_cli(dev, embed, bare_img_s, log, require) -> dict:
    """Phase 20: the train CLI on the card.

    1. `cli.train.main(["-c", "14", "--synthetic", "-ve", "1", "-se", "1",
       "-dir", <tmp>])`: full width, bf16, the preset's batch sizes (1, 1),
       so 6 stage-1 steps, 4 validation images, 8 stage-2 steps and a
       second validation. `num_viz` is set to 0 through `run_experiment`'s
       cfg: the card's machine has no Pillow to write the viz tiles. Its
       files, finite losses, and the launch counts computed from the
       loaders' lengths: K3-K6 once a stage-1 step; K2 once a stage-2 step
       and once a validation batch of either stage (every forward without
       autograd); K1 once a stage-1 validation batch (the fused NNE eval);
       K7 never.
    2. The resume: `-r <log_dir>/checkpoint -ve 2 -se 0` restores the
       parameters and Adam's moments bit-equal to the file, starts at
       stage 1's step count (the file is stage 2's last save, which keeps
       stage 1's counters) and trains one more epoch.
    3. One loop timing: FCNTrainer over SyntheticDataset(960 images,
       500-512 px) at B=24, 512x512, the compact feed, log flushes at 16: a
       4-step warm-up epoch on 96 other images, then one epoch of 40 steps
       with host syncs turned into errors between flushes (the flushes at
       steps 16 and 32 fall inside it). Its img/s over the whole epoch and
       in the steady window (CUDA events recorded after each step: from
       the end of the first step to the end of the last, both flushes
       inside; the host's time between step calls beside it), the wait
       for the epoch's first batch apart, beside the bare step on the
       same trainer (a resident batch, no feed, no logging)
       and phase 10's (`bare_img_s`); the loader's first batch and its rate
       alone, the save time of one full-width checkpoint (Adam's moments
       with it) and the peak memory of the loop and of the bare step (the
       memory already allocated before the loop's model is logged beside
       them).
    """
    import tempfile

    import torch
    from zeroshotsemanticsegmentation_tpu_torch.cli import train as cli
    from zeroshotsemanticsegmentation_tpu_torch.configs import get_config
    from zeroshotsemanticsegmentation_tpu_torch.data import (
        BatchLoader, SyntheticDataset)
    from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
    from zeroshotsemanticsegmentation_tpu_torch.train import (
        FCNTrainer, make_fcn_optimizer)
    from zeroshotsemanticsegmentation_tpu_torch.train import checkpoint as ck
    from zeroshotsemanticsegmentation_tpu_torch.train import trainer_fcn
    from zeroshotsemanticsegmentation_tpu_torch.utils import RunLogger

    real_run = cli.run_experiment

    def run_no_viz(cfg, **kw):
        return real_run(cfg.replace(num_viz=0), **kw)

    def csv_rows(path):
        with open(path) as f:
            lines = f.read().splitlines()
        return [line.split(",") for line in lines[1:]]

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # 1. the two-stage run, launch counts from the loaders' lengths
        cfg = get_config(14, fcn_epochs=1, seenmask_epochs=1)
        train_ds, seen_ds, val_ds = cli._build_datasets(
            cfg, data_dir=tmp, synthetic=True)
        n_s1 = len(BatchLoader(seen_ds, cfg.batch_size))
        n_s2 = len(BatchLoader(train_ds, cfg.batch_size))
        n_val = len(BatchLoader(val_ds, cfg.eval_batch_size))
        want = {"block1_train_fwd": n_s1, "block1_train_bwd": n_s1,
                "costail_fwd": n_s1, "costail_bwd": n_s1,
                "block1_fused": n_s2 + 2 * n_val, "szn_fused": n_val}
        argv = ["-c", "14", "--synthetic", "-ve", "1", "-se", "1",
                "-dir", tmp]
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(cli, "run_experiment", run_no_viz):
            summary = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        got = dict(_kernels.launch_counts)
        log_dir = summary["log_dir"]
        log(f"[train cli] {' '.join(argv[:-2])}: {run_s:.1f} s, launches "
            f"{got}, expected {want}")
        for name in ("config.yaml", "counts.csv", "train_log.csv",
                     "val_log.csv", "seenmask_train_log.csv",
                     "seenmask_val_log.csv", "checkpoint", "best"):
            require(osp.isfile(osp.join(log_dir, name)),
                    f"train CLI did not write {name}")
        s1 = csv_rows(osp.join(log_dir, "train_log.csv"))
        s2 = csv_rows(osp.join(log_dir, "seenmask_train_log.csv"))
        losses = [float(r[2]) for r in s1 + s2]
        require(len(s1) == n_s1 and len(s2) == n_s2,
                f"train CLI logged {len(s1)} + {len(s2)} steps")
        require(all(np.isfinite(x) for x in losses),
                f"train CLI losses {losses}")
        for key, n in want.items():
            require(got[key] == n, f"train CLI: {key} launched {got[key]} "
                    f"times, expected {n}")
        require(got["pdot"] == 0, f"train CLI launched K7: {got}")
        out["cli"] = {"seconds": run_s, "launches": got,
                      "steps": [n_s1, n_s2], "val_batches": n_val,
                      "losses": losses,
                      "best_mean_iu": summary["best_mean_iu"],
                      "seenmask_best_mean_iu":
                          summary["seenmask_best_mean_iu"]}

        # 2. the resume: parameters and moments as saved, one more epoch
        path = osp.join(log_dir, "checkpoint")
        saved = ck.restore_checkpoint(path)
        os.remove(osp.join(log_dir, "best"))  # disk: one 1.6 GB file less
        real_train = trainer_fcn.FCNTrainer.train
        restored = {}

        def checked_train(self):
            sd = self.state.model.state_dict()
            restored["params"] = all(
                torch.equal(sd[k].cpu(), v) for k, v in
                saved["params"].items())
            live = self.state.optimizer.state_dict()
            restored["moments"] = bool(saved["opt_state"]["state"]) and \
                _nested_equal(live["state"], saved["opt_state"]["state"])
            restored["groups"] = (live["param_groups"]
                                  == saved["opt_state"]["param_groups"])
            restored["start"] = (self.epoch, self.iteration)
            return real_train(self)

        argv = ["-c", "14", "--synthetic", "-r", path, "-ve", "2", "-se",
                "0", "-dir", tmp]
        _kernels.reset_launch_counts()
        with mock.patch.object(cli, "run_experiment", run_no_viz), \
                mock.patch.object(trainer_fcn.FCNTrainer, "train",
                                  checked_train):
            resumed = cli.main(argv)
        torch.cuda.synchronize()
        got = dict(_kernels.launch_counts)
        r1 = csv_rows(osp.join(resumed["log_dir"], "train_log.csv"))
        log(f"[train cli] resume from {saved['epoch']}/{saved['iteration']}: "
            f"{restored}, {len(r1)} steps, launches {got}")
        require(restored.get("params") and restored.get("moments")
                and restored.get("groups"),
                f"resume did not restore the checkpoint bit-equal: "
                f"{restored}")
        # the run's last save is stage 2's: it keeps stage 1's counters
        require(restored["start"] == (saved["epoch"] + 1, n_s1)
                and saved["iteration"] == n_s1,
                f"resume starts at {restored['start']}, stage 1 ran {n_s1} "
                "steps")
        require(len(r1) == n_s1 and {r[0] for r in r1} == {"1"},
                f"resume trained {len(r1)} steps: {r1}")
        require(got["costail_fwd"] == n_s1 and got["szn_fused"] == n_val
                and got["pdot"] == 0, f"resume launches {got}")
        out["resume"] = {"restored": restored, "steps": len(r1)}
        del saved
        shutil.rmtree(log_dir)
        shutil.rmtree(resumed["log_dir"])

        # 3. the loop: FCNTrainer at B=24 on the compact feed
        lcfg = get_config(14, batch_size=TRAIN_BATCH,
                          eval_batch_size=TRAIN_BATCH)
        loader, warm_loader = (
            BatchLoader(SyntheticDataset(num_images=n, num_classes=21,
                                         size_range=(500, 512), seed=seed),
                        TRAIN_BATCH, bucket_hw=(H, W), shuffle=True,
                        seed=lcfg.seed, compact=True)
            for n, seed in ((LOOP_IMAGES, 0), (LOOP_WARMUP_IMAGES, 1)))
        t0 = time.perf_counter()
        it = iter(loader)
        next(it)  # an epoch's start: the first batch off the loader
        first_batch_s = time.perf_counter() - t0
        it.close()
        t0 = time.perf_counter()
        n_feed = sum(b["num_real"] for b in loader)
        feed_img_s = n_feed / (time.perf_counter() - t0)
        base_gb = torch.cuda.memory_allocated() / 1e9
        model = FCN32s(20, dtype=torch.bfloat16, fused_block1=True,
                       generator=torch.Generator().manual_seed(lcfg.seed),
                       device=dev)
        trainer = FCNTrainer(
            cfg=lcfg, model=model,
            optimizer=make_fcn_optimizer(model, optim="adam",
                                         lr=lcfg.fcn_lr),
            train_loader=warm_loader, val_loader=loader,
            logger=RunLogger(osp.join(tmp, "loop"), tensorboard=False,
                             verbose=False),
            embeddings=embed, target_embeddings=embed, upscore_trained=False)
        trainer.train_epoch()  # warm-up
        trainer.train_loader = loader
        torch.cuda.synchronize()
        real_flush = trainer_fcn.StepLogBuffer.flush
        real_step = trainer._train_step
        marks, flushes = [], []

        def flush_synced(self):  # a flush reads back by design
            if self._pending:
                flushes.append(len(marks))
            torch.cuda.set_sync_debug_mode("default")
            try:
                real_flush(self)
            finally:
                torch.cuda.set_sync_debug_mode("error")

        def marked_step(*a):  # (host time at the call, event after it)
            t = time.perf_counter()
            res = real_step(*a)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((t, ev))
            return res

        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        trainer.epoch = 1
        trainer._train_step = marked_step
        t0 = time.perf_counter()
        try:
            torch.cuda.set_sync_debug_mode("error")
            with mock.patch.object(trainer_fcn.StepLogBuffer, "flush",
                                   flush_synced):
                trainer.train_epoch()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            trainer._train_step = real_step
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        got = dict(_kernels.launch_counts)
        n_steps, n_warm = len(loader), len(warm_loader)
        require(got["costail_fwd"] == n_steps
                and got["block1_train_bwd"] == n_steps
                and len(marks) == n_steps,
                f"loop launches {got} for {n_steps} steps")
        fs = lcfg.log_flush_steps
        require(flushes == [*range(fs, n_steps, fs), n_steps]
                and len(flushes) >= 3,
                f"loop flushed after steps {flushes}")
        first_wait_s = marks[0][0] - t0
        steady_s = marks[0][1].elapsed_time(marks[-1][1]) / 1e3
        steady_img_s = (n_steps - 1) * TRAIN_BATCH / steady_s
        rows = csv_rows(osp.join(tmp, "loop", "train_log.csv"))
        require(len(rows) == n_warm + n_steps
                and all(np.isfinite(float(r[2])) for r in rows),
                f"loop rows {rows}")
        # the bare step on the same trainer, in this phase: one batch
        # resident on the card, no feed, no logging
        dbatch = trainer_fcn.take_batch(*trainer_fcn.put_batch(
            next(iter(loader)), dev))

        def bare_step():
            trainer.state, _ = trainer._train_step(
                trainer.state, dbatch, trainer._generator)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bare_ms = time_ms(bare_step, iters=8, warmup=1)
        bare_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del dbatch
        t0 = time.perf_counter()
        ck.save_checkpoint(osp.join(tmp, "save"),
                           model_state=model.state_dict(),
                           optim_state=trainer.state.optimizer.state_dict(),
                           epoch=1, iteration=trainer.iteration,
                           best_mean_iu=0.0, is_best=True)
        save_s = time.perf_counter() - t0
        save_gb = os.path.getsize(osp.join(tmp, "save", "checkpoint")) / 1e9
        loop_img_s = n_steps * TRAIN_BATCH / loop_s
        bare_here = TRAIN_BATCH / (bare_ms / 1e3)
        out["loop"] = {
            "batch": TRAIN_BATCH, "hw": [H, W], "dtype": "bfloat16",
            "steps": n_steps, "images": LOOP_IMAGES,
            "warmup_steps": n_warm,
            "log_flush_steps": fs, "flushes_after_steps": flushes,
            "seconds": loop_s, "images_per_s": loop_img_s,
            "first_step_wait_s": first_wait_s,
            "steady_seconds": steady_s,
            "steady_images_per_s": steady_img_s,
            "steady_host_ms_per_step":
                1e3 * (marks[-1][0] - marks[0][0]) / (n_steps - 1),
            "bare_step_images_per_s": bare_here,
            "bare_step_ms": bare_ms,
            "phase10_bare_step_images_per_s": bare_img_s,
            "loop_over_bare": loop_img_s / bare_here,
            "steady_over_bare": steady_img_s / bare_here,
            "overhead_ms_per_step": 1e3 * loop_s / n_steps - bare_ms,
            "steady_overhead_ms_per_step":
                1e3 * steady_s / (n_steps - 1) - bare_ms,
            "first_batch_s": first_batch_s,
            "feed_alone_images_per_s": feed_img_s,
            "allocated_before_gb": base_gb,
            "max_memory_allocated_gb": peak_gb,
            "bare_step_max_memory_allocated_gb": bare_peak_gb,
            "checkpoint_save_s": save_s, "checkpoint_gb": save_gb,
            "syncs_between_flushes": 0}
        log(json.dumps({"train_loop": out["loop"]}))
        del trainer, model
    out["launches"] = out["cli"]["launches"]
    return out


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
        from zeroshotsemanticsegmentation_tpu_torch.ops import dotpolicy
        from zeroshotsemanticsegmentation_tpu_torch.ops import pdot as pd
        from zeroshotsemanticsegmentation_tpu_torch.ops import rowdot as rd
        from zeroshotsemanticsegmentation_tpu_torch.train import (
            TrainState, make_fcn_optimizer, make_fcn_train_step,
            make_seenmask_optimizer, make_seenmask_train_step)
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
    card = card_line()
    require(card is not None, "nvidia-smi failed")
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
    b1_build = kernel_build_stats(_kernels, "block1_train", (
        "conv2_pool_fwd_wgmma", "conv2_pool_route_wgmma",
        "conv2_wgrad_wgmma", "conv2_dgrad_wgmma", "conv2_pool_fwd",
        "conv2_pool_route", "conv2_wgrad", "conv2_dgrad", "wgrad_reduce"))
    k2_build = kernel_build_stats(_kernels, "block1_fused", (
        "block1_fused_wgmma", "block1_kernel"))
    k7_build = kernel_build_stats(_kernels, "pdot", (
        "pdot_tma", "pdot_narrow", "pdot_bf16", "pdot_f32", "pdot_reduce"))
    k56_build = kernel_build_stats(_kernels, "costail_fused", (
        "costail_fwd_regs", "costail_bwd_regs", "costail_fwd_wide",
        "costail_bwd_wide", "costail_finalize"))
    k1_build = kernel_build_stats(_kernels, "szn_fused",
                                  ("szn_labels_kernel",))
    k8_build = kernel_build_stats(_kernels, "conv1_1", (
        "conv1_1_wgmma", "conv1_1_kernel"))
    for lib, built in (("block1_train", b1_build), ("block1_fused", k2_build),
                       ("pdot", k7_build), ("costail_fused", k56_build),
                       ("szn_fused", k1_build), ("conv1_1", k8_build)):
        for fn, st in built.items():
            log(f"[build] {lib} {fn}: {st}")
    # each bf16 wgmma kernel: HGMMA in its SASS (where cuobjdump exists)
    for built, fns in (
            (b1_build, ("conv2_pool_fwd_wgmma", "conv2_pool_route_wgmma",
                        "conv2_wgrad_wgmma", "conv2_dgrad_wgmma")),
            (k2_build, ("block1_fused_wgmma",)),
            (k8_build, ("conv1_1_wgmma",)),
            (k7_build, ("pdot_tma<256,0>", "pdot_tma<256,1>",
                        "pdot_narrow<8>", "pdot_narrow<16>",
                        "pdot_narrow<24>"))):
        for fn in fns:
            require(fn in built and built[fn].get("hgmma", 1) > 0,
                    f"{fn} is not built with an HGMMA instruction: "
                    f"{built.get(fn)}")

    for inst in ("szn_labels_kernel<22>", "szn_labels_kernel<34>",
                 "szn_labels_kernel<0>"):
        require(inst in k1_build, f"K1 instance {inst} not built: "
                f"{sorted(k1_build)}")

    @contextlib.contextmanager
    def plain_versions():
        """Routes the predictor through the kernels' plain versions."""
        with mock.patch.object(sz, "szn_labels", sz.szn_labels_plain), \
                mock.patch.object(b1, "block1_op", b1.block1_plain):
            yield

    @contextlib.contextmanager
    def plain_block1_training():
        """Routes the training form of block 1 through K3/K4's plain
        versions."""
        with mock.patch.object(b1, "conv2_pool", b1.conv2_pool_plain), \
                mock.patch.object(b1, "conv2_pool_backward",
                                  b1.conv2_pool_plain_backward):
            yield

    @contextlib.contextmanager
    def plain_training():
        """Routes the train step through K3-K6's plain versions: the
        training form of block 1 with plain conv2_pool, and the fused
        tail's plain version."""
        with plain_block1_training(), mock.patch.object(
                train_steps, "fused_cos_tail", ct.cos_tail_plain):
            yield

    def flip_rate(a, b) -> float:
        return (a != b).float().mean().item()

    rng = np.random.RandomState(0)
    embed = load_class_embeddings("pascal", 20)
    k_cls = embed.shape[0]

    # ---- 3. SZN-labels kernel vs plain ----------------------------------
    def szn_case(score, sm, emb, unseen, out_hw):
        """K1 (one launch, two calls bit-equal) and its plain version."""
        _kernels.reset_launch_counts()
        got = sz.infer_labels_szn_fused(score, sm, emb, unseen, out_hw)
        again = sz.infer_labels_szn_fused(score, sm, emb, unseen, out_hw)
        torch.cuda.synchronize()
        n_k1 = _kernels.launch_counts["szn_fused"]
        require(n_k1 == 2, f"K1: {n_k1} launches for two calls")
        require(torch.equal(got, again), "two K1 calls differ")
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
    # the context width (K = 33, 300-dim embeddings; K+1 = 34 has its own
    # instance) at the serving shapes
    e33 = rng.randn(33, 300).astype(np.float32)
    got, want = szn_case(torch.randn(8, 17, 17, 300, device=dev),
                         torch.randn(8, 17, 17, 2, device=dev), e33,
                         unseen_mask_vector(33, [2, 9, 30]), (H, W))
    k33_flips = flip_rate(got, want)
    log(f"[K1] B=8 512x512 K=33: flip rate {k33_flips:.3e}")
    require(k33_flips < 1e-4 and got.max().item() < 33,
            f"K1 K=33 flip rate {k33_flips}")
    # tie-heavy inputs on a 1/8 grid (every upsampled value exact in fp32):
    # duplicated classes, an all-zero class (ties with the 0.0 fill), gates
    # of 0, every class negative, an empty partition; K+1 = 10, 22, 34, 71
    tie_flips = 0.0
    for k in (9, 21, 33, 70):
        aug = torch.from_numpy(rng.randint(-4, 5, (4, 9, 12, k + 1)).astype(
            np.float32) / 8).to(dev)
        aug[..., 3] = aug[..., 1]
        aug[..., k - 1] = aug[..., 0]
        aug[..., 2] = 0.0
        aug[0, 1, :, k] = 0.0
        aug_neg = aug.clone()
        aug_neg[..., :k] = -aug_neg[..., :k].abs() - 0.125
        for uvk in (np.isin(np.arange(k), [1, k - 2]), np.zeros(k, bool),
                    np.ones(k, bool)):
            parts = sz._partition(~uvk, uvk)
            for a in (aug, aug_neg):
                _kernels.reset_launch_counts()
                got = sz.szn_labels(a, *parts, 260, 360)
                require(_kernels.launch_counts["szn_fused"] == 1,
                        "K1 tie case: not one launch")
                want = sz.szn_labels_plain(a, *parts, 260, 360)
                tie_flips = max(tie_flips, flip_rate(got, want))
    log(f"[K1] tie-heavy inputs, K = 9, 21, 33, 70, three partitions: "
        f"largest flip rate {tie_flips:.3e}")
    require(tie_flips < 1e-4, f"K1 tie-heavy flip rate {tie_flips}")

    # ---- 4. block-1 kernel vs plain -------------------------------------
    def b1_weights(gen_scale=(0.2, 0.1, 0.05, 0.1)):
        return (torch.randn(64, 3, 3, 3, device=dev) * gen_scale[0],
                torch.randn(64, device=dev) * gen_scale[1],
                torch.randn(64, 64, 3, 3, device=dev) * gen_scale[2],
                torch.randn(64, device=dev) * gen_scale[3])

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
    # bf16 K2 at the serving batch vs its plain version, and two calls
    # bit-equal
    xp = torch.randn(SERVE_BATCH, H + 10, W + 10, 3, device=dev)
    wts = b1_weights()
    with torch.inference_mode():
        ref = b1.block1_plain(xp, *wts, torch.float32)
        got16 = b1.block1_op(xp, *wts, torch.bfloat16)
        again = b1.block1_op(xp, *wts, torch.bfloat16)
    torch.cuda.synchronize()
    k2_bf16_err = (got16.float() - ref).abs().max().item()
    bar16 = 2 * ref.abs().max().item() * 2.0 ** -8
    k2_bit_equal = torch.equal(got16, again)
    log(f"[K2] {tuple(xp.shape)} bf16: max|err| vs plain fp32 "
        f"{k2_bf16_err:.3e} (bar {bar16:.3e}); two calls bit-equal: "
        f"{k2_bit_equal}")
    require(got16.shape == ref.shape and k2_bf16_err <= bar16,
            f"K2 bf16 error {k2_bf16_err} > {bar16} at {tuple(xp.shape)}")
    require(k2_bit_equal, "two bf16 K2 calls differ")
    del xp, ref, got16, again

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
    # the serving bf16 bar: bf16 labels through the kernels at most 2x as
    # far from the fp32 labels as bf16 labels with block 1 through its
    # plain version (scripts/torch_serving_bar.py)
    sbar = load_script("torch_serving_bar").run(
        log=lambda m: log(f"[serving bar] {m}"))
    require(sbar["block1_fused_launches"] > 0,
            f"the serving bar's kernel run did not launch K2: {sbar}")
    require(sbar["flip_kernels"] <= 2 * sbar["flip_plain"],
            f"bf16 serving flips {sbar['flip_kernels']} vs fp32, more than "
            f"2x the plain block 1's {sbar['flip_plain']}")

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
    parts = sz._partition(~uv, uv)
    k1_ms = time_ms(lambda: sz.szn_labels(aug, *parts, H, W), iters=20)
    k1_device_ms = device_ms(lambda: sz.szn_labels(aug, *parts, H, W),
                             20, "szn_labels")
    k1_plain_ms = time_ms(lambda: sz.szn_labels_plain(aug, *parts, H, W),
                          iters=3)
    kp1 = aug.shape[-1]
    k1_bytes = aug.numel() * 4 + SERVE_BATCH * H * W * 4
    k1_ops = 3 * SERVE_BATCH * H * (W + 17) * kp1
    k1_bound = 1e3 * max(k1_bytes / PEAK_BYTES_S, k1_ops / PEAK_FP32_FLOP_S)
    k1_by = ("bytes" if k1_bytes / PEAK_BYTES_S
             >= k1_ops / PEAK_FP32_FLOP_S else "operations")
    # the issue floor: 5 lane-instructions a class and pixel (2 of blend, 3
    # of argmax update) at 4 x 32 lanes an SM a cycle, at the card's
    # largest SM clock
    smi_clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    sm_mhz = float(smi_clk.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k1_issue_ms = 1e3 * 5 * SERVE_BATCH * H * W * kp1 / (
        sms * 4 * 32 * sm_mhz * 1e6)
    log(f"[K1] B={SERVE_BATCH} {H}x{W} K+1={kp1}: {k1_ms:.4f} ms by events, "
        f"{k1_device_ms:.4f} ms device time; byte bound {k1_bound:.4f} "
        f"({k1_bound / k1_device_ms:.1%} of it reached), issue floor "
        f"{k1_issue_ms:.4f} ({sms} SMs at {sm_mhz:.0f} MHz; "
        f"{k1_issue_ms / k1_device_ms:.1%}); plain {k1_plain_ms:.3f}")
    # K1 on both routes at every band height `k1_plan` can choose: the SZN
    # route (random gates, as above) and the NNE route of the fused fcn
    # eval (a constant -1 gate, every class seen), at B=64 and the evals'
    # B=16; each forced height's labels equal the plan's
    nne_parts = sz._partition(np.ones(uv.shape[0], bool),
                              np.zeros(uv.shape[0], bool))
    k1_rows = {}
    for route, g, rparts in (("szn", gate, parts),
                             ("nne", torch.full_like(gate, -1.0),
                              nne_parts)):
        for nb in (SERVE_BATCH, EVAL_BATCH):
            a = sz._aug(score[:nb], g[:nb], sz._embed_scaled(embed, dev))
            want = sz.szn_labels(a, *rparts, H, W)
            plan_rows = sz.k1_plan(nb, 17, 17, kp1, H, W,
                                   sz.kernel_partition(*rparts)[1])["rows"]
            times = {}
            for r in sz.K1_ROWS:
                with mock.patch.object(sz, "K1_ROWS", (r,)):
                    got = sz.szn_labels(a, *rparts, H, W)
                    require(torch.equal(got, want),
                            f"K1 {route} B={nb} rows={r}: labels differ "
                            "from the plan's")
                    times[r] = device_ms(
                        lambda: sz.szn_labels(a, *rparts, H, W), 20,
                        "szn_labels")
            k1_rows[f"{route}_b{nb}"] = {"plan_rows": plan_rows,
                                         "device_ms": times}
            log(f"[K1] {route} route B={nb} K+1={kp1}, device ms by band "
                f"height (the plan takes {plan_rows}): " + ", ".join(
                    f"{r} rows {t:.4f}" for r, t in times.items()))
    k1_nne_device_ms = k1_rows[f"nne_b{SERVE_BATCH}"]["device_ms"][
        k1_rows[f"nne_b{SERVE_BATCH}"]["plan_rows"]]

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
    k4_checks = []
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
            if dtype == torch.bfloat16:
                # the route recomputes K3's pre-activations bit for bit:
                # with g = 1 each window of dz holds exactly one 1 where
                # K3's output is > 0 and only zeros where it is 0
                bufs = b1.k4_buffers(c11, k2t, b2f, torch.ones_like(got))
                b1.k4_launch(bufs, b1.K4_ROUTE)
                n_, hh, ww = got.shape[:3]
                dzw = bufs["dz"].view(n_, hh, 2, ww, 2, 64)
                pos = got > 0
                route_ok = (torch.equal((dzw == 1).sum((2, 4)), pos.long())
                            and torch.equal(dzw.float().sum((2, 4)),
                                            pos.float()))
                del bufs, dzw
                again = b1.conv2_pool_backward(c11, k2t, b2f, g)
                det_ok = all(torch.equal(a, b) for a, b in zip(dgot, again))
                del again
                log(f"[K4] {tuple(c11.shape)} bf16: route agrees with K3 "
                    f"({pos.float().mean().item():.3f} of the windows > 0): "
                    f"{route_ok}; two calls bit-equal: {det_ok}")
                require(route_ok, f"K4's route disagrees with K3 at "
                        f"{tuple(c11.shape)}")
                require(det_ok, f"K4 is not deterministic at "
                        f"{tuple(c11.shape)}")
                k4_checks.append({"shape": list(c11.shape),
                                  "route_agrees": route_ok,
                                  "bit_equal": det_ok})
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
    g_ssum = torch.tensor(0.37, device=dev)
    tail_errs = {}
    tail_cases = []

    def tail_labels(tb, tk, th, tw, coherent):
        """int32 labels in [-1, tk): uniform, or constant over 32x32
        patches (spatially coherent, as real label maps are)."""
        if not coherent:
            return torch.randint(-1, tk, (tb, th, tw), device=dev,
                                 dtype=torch.int32)
        patch = torch.randint(-1, tk, (tb, th // 32 + 1, tw // 32 + 1),
                              device=dev, dtype=torch.int32)
        return patch.repeat_interleave(32, 1).repeat_interleave(
            32, 2)[:, :th, :tw].contiguous()

    # (batch, embeddings, H, W, coherent labels): the main path's pascal
    # 20-dim table at B=4 and B=24; the widths past the register form's:
    # pascal 50-dim (K=21) and context 300-dim (K=33); an odd geometry at an
    # odd width (353x375 at C=21: the tensor's end a plain-load tail); and
    # coherent labels with scores the target row plus noise, so that the
    # predictions cohere too
    ctx300 = load_class_embeddings("context", 300)
    for tb, emb, th, tw, coherent in (
            (4, embed, H, W, False), (TRAIN_BATCH, embed, H, W, False),
            (TRAIN_BATCH, load_class_embeddings("pascal", 50), H, W, False),
            (8, ctx300, H, W, False),
            (2, load_class_embeddings("pascal", 21), 353, 375, False),
            (4, embed, H, W, True)):
        tk, tc = emb.shape
        temb = torch.from_numpy(emb).to(dev).clone()
        iemb = temb.clone()
        temb[0] = 0.0                         # a zeroed embedding row
        iemb[3] = 0.0
        temb_n, iemb_n = l2_normalize(temb), l2_normalize(iemb)
        label = tail_labels(tb, tk, th, tw, coherent)
        if coherent:
            score = (temb_n[label.clamp(min=0).long()]
                     + 0.3 * torch.randn(tb, th, tw, tc, device=dev))
        else:
            score = torch.randn(tb, th, tw, tc, device=dev)
        score[:, :2, :3] = 0.0                # zero-norm pixels
        label[-1] = -1                        # an all-ignore sample
        losses, hist, ssum, nv = ct.cos_tail_forward(score, label, temb_n,
                                                     iemb_n, tk)
        w_losses, w_hist, w_ssum = ct.cos_tail_plain(score, label, temb,
                                                     iemb, tk)
        g_losses = torch.randn(tb, device=dev)
        ds = ct.cos_tail_backward(score, label, temb_n, g_losses, nv, g_ssum)
        w_ds = ct.cos_tail_plain_backward(score, label, temb, iemb, tk,
                                          g_losses, g_ssum)
        # a second call of each: bit-equal
        again = ct.cos_tail_forward(score, label, temb_n, iemb_n, tk)
        ds2 = ct.cos_tail_backward(score, label, temb_n, g_losses, nv,
                                   g_ssum)
        torch.cuda.synchronize()
        bit_equal = (all(torch.equal(a, b) for a, b in
                         zip((losses, hist, ssum, nv), again))
                     and torch.equal(ds, ds2))
        del again, ds2
        k5_err = (losses - w_losses).abs().max().item()
        k6_err = (ds - w_ds).abs().max().item()
        k5_rel = ((losses - w_losses).abs()
                  / w_losses.abs().clamp(min=1e-30)).max().item()
        hflips = (hist - w_hist).abs().sum().item()
        name = (f"B={tb} {th}x{tw} C={tc} K={tk}"
                + (" coherent" if coherent else ""))
        log(f"[K5] {name}: losses max|err| "
            f"{k5_err:.3e} (max rel {k5_rel:.3e}, bar 1e-5), ssum "
            f"{ssum.item():.6e} vs {w_ssum.item():.6e}, hist flips {hflips} "
            f"of {w_hist.sum().item()}; [K6] d score max|err| {k6_err:.3e}, "
            f"rel-norm {rel(ds, w_ds):.3e}; two calls bit-equal {bit_equal}")
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
        require(rel(ds, w_ds) < 1e-4, f"K6 d score rel {rel(ds, w_ds)}")
        require(bit_equal, f"K5/K6 {name}: two calls differ")
        tail_cases.append({"case": name, "k5_max_abs_err": k5_err,
                           "k6_max_abs_err": k6_err, "hist_flips": hflips,
                           "bit_equal": bit_equal})
        if (tb == TRAIN_BATCH or tc == 300) and not coherent:
            tail_errs[tc] = (k5_err, k6_err)
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
    def b2_step(dtype, routing):
        """One B=2 step from seed-1 weights, batch and dropout masks under
        the context `routing`: (aux, fp32 gradients)."""
        m = train_model(dtype, seed=1)
        st = TrainState.create(m, make_fcn_optimizer(m, optim="adam",
                                                     lr=1e-5))
        gen = torch.Generator(device=dev).manual_seed(1)
        with routing:
            _, aux = step(st, train_batch(2, 1), gen)
        grads = {n: p.grad.detach().float().clone()
                 for n, p in m.named_parameters() if p.grad is not None}
        del m, st
        return aux, grads

    def fp32_step(plain: bool):
        return b2_step(torch.float32, plain_training() if plain
                       else contextlib.nullcontext())

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

    # the bf16 end-to-end bar: the same B=2 step in bf16 through the
    # kernels and in bf16 with K3/K4 through their plain versions, each
    # parameter's gradient against the fp32 step's (TF32 off); the kernels
    # may be at most 2x as far from fp32 as the plain versions, parameter
    # by parameter
    _, grads_bk = b2_step(torch.bfloat16, contextlib.nullcontext())
    _, grads_bp = b2_step(torch.bfloat16, plain_block1_training())
    torch.cuda.synchronize()
    require(set(grads_bk) == set(grads_k) == set(grads_bp),
            "bf16 gradient sets differ")
    bf16_bar = {n: {"kernels": rel(grads_bk[n], grads_k[n]),
                    "plain": rel(grads_bp[n], grads_k[n])} for n in grads_k}
    log(json.dumps({"bf16_step_vs_fp32_grad_rel": bf16_bar}))
    bar_misses = [n for n, r in bf16_bar.items()
                  if not r["kernels"] <= 2 * r["plain"]]
    require(not bar_misses, f"bf16 kernel gradients more than 2x the plain "
            f"versions' error vs fp32: {bar_misses}")
    del grads_k, grads_p, grads_bk, grads_bp

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
    k3_ms = time_ms(lambda: b1.conv2_pool(c11, k2t, b2f), iters=20)
    k3_plain_ms = time_ms(lambda: b1.conv2_pool_plain(c11, k2t, b2f),
                          iters=3)
    k4_ms = time_ms(lambda: b1.conv2_pool_backward(c11, k2t, b2f, g),
                    iters=10)
    # K4's steps alone, on the scratch of one call (the route first fills
    # dz): the route, dK2/db2 with the fp64 reduction, d(c11)
    k4b = b1.k4_buffers(c11, k2t, b2f, g)
    k4_parts = {name: time_ms(lambda p=p: b1.k4_launch(k4b, p), iters=10)
                for name, p in (("route", b1.K4_ROUTE),
                                ("wgrad_reduce", b1.K4_WGRAD),
                                ("dgrad", b1.K4_DGRAD))}
    k4_chunks = k4b["n_chunks"]
    del k4b
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

    def tail_times(emb, plain_batch):
        """K5/K6 at B=24 with table `emb`: event and device time, bound and
        the share of it reached; K5 also with coherent labels; the plain
        versions' event times at `plain_batch`."""
        tk, tc = emb.shape
        temb = torch.from_numpy(emb).to(dev)
        temb_n = l2_normalize(temb)
        score = torch.randn(TRAIN_BATCH, H, W, tc, device=dev)
        label = tail_labels(TRAIN_BATCH, tk, H, W, False)
        _, _, _, nv = ct.cos_tail_forward(score, label, temb_n, temb_n, tk)
        g_losses = torch.randn(TRAIN_BATCH, device=dev)
        t = {"C": tc, "K": tk, "plain_batch": plain_batch}

        def k5():
            return ct.cos_tail_forward(score, label, temb_n, temb_n, tk)

        def k6():
            return ct.cos_tail_backward(score, label, temb_n, g_losses, nv,
                                        g_ssum)

        t["k5_ms"], t["k6_ms"] = time_ms(k5, iters=10), time_ms(k6, iters=10)
        t["k5_device_ms"] = device_ms(k5, iters=10)
        t["k6_device_ms"] = device_ms(k6, iters=10)
        pix = TRAIN_BATCH * H * W
        t["k5_bound"], t["k5_by"] = bound(
            score.numel() * 4 + label.numel() * 4 + 2 * tk * tc * 4,
            pix * (5 * tc + 2 * tk * tc), PEAK_FP32_FLOP_S)
        t["k6_bound"], t["k6_by"] = bound(
            2 * score.numel() * 4 + label.numel() * 4 + tk * tc * 4,
            pix * 9 * tc, PEAK_FP32_FLOP_S)
        for kn in ("k5", "k6"):
            t[f"{kn}_share"] = t[f"{kn}_bound"] / t[f"{kn}_device_ms"]
        sp, lp = score[:plain_batch], label[:plain_batch]
        t["k5_plain_ms"] = time_ms(lambda: ct.cos_tail_plain(
            sp, lp, temb, temb, tk), iters=2)
        t["k6_plain_ms"] = time_ms(lambda: ct.cos_tail_plain_backward(
            sp, lp, temb, temb, tk, g_losses[:plain_batch], g_ssum), iters=2)
        del sp, lp
        # coherent labels, scores the target row plus noise (k5 reads the
        # new score and label)
        label = tail_labels(TRAIN_BATCH, tk, H, W, True)
        score = (temb_n[label.clamp(min=0).long()]
                 + 0.3 * torch.randn_like(score))
        t["k5_coherent_ms"] = time_ms(k5, iters=10)
        t["k5_coherent_device_ms"] = device_ms(k5, iters=10)
        del score, label
        log(f"[times] C={tc} K={tk}: K5 {t['k5_ms']:.4f} ms, device "
            f"{t['k5_device_ms']:.4f} ({100 * t['k5_share']:.1f}% of the "
            f"bound {t['k5_bound']:.4f}, {t['k5_by']}), coherent labels "
            f"{t['k5_coherent_ms']:.4f} / device "
            f"{t['k5_coherent_device_ms']:.4f} (plain "
            f"{t['k5_plain_ms']:.3f} at B={plain_batch}); K6 "
            f"{t['k6_ms']:.4f} ms, device {t['k6_device_ms']:.4f} "
            f"({100 * t['k6_share']:.1f}% of the bound "
            f"{t['k6_bound']:.4f}, {t['k6_by']}; plain "
            f"{t['k6_plain_ms']:.3f})")
        return t

    tail20 = tail_times(embed, TRAIN_BATCH)
    # the plain versions' per-sample autograd graphs at C=300 would hold
    # ~40 GB at B=24: they are timed at B=8
    tail300 = tail_times(ctx300, 8)
    log(f"[times] K3 {k3_ms:.4f} ms (plain {k3_plain_ms:.3f}, cuDNN "
        f"{k3_lib_ms:.4f}, bound {k3_bound:.3f}); K4 {k4_ms:.4f} ms (plain "
        f"{k4_plain_ms:.3f}, cuDNN {k4_lib_ms:.4f}, bound {k4_bound:.3f}); "
        f"K4's steps " + ", ".join(f"{k} {v:.4f}" for k, v in
                                   k4_parts.items())
        + f" ms ({k4_chunks} dK2 chunks)")

    # ---- 11. K7 (matmul) vs plain -----------------------------------------
    pdot_rows = phase_pdot(dev, pd, _kernels, log, require)

    # ---- 12. stage 1 under the dot-free mode ------------------------------
    px = TRAIN_BATCH * (H // 32 + 1) ** 2   # fc6 output pixels: 24 * 17^2
    dotpolicy.set_dot_free(True)
    try:
        tmodel = train_model(torch.bfloat16)
        tstate = TrainState.create(
            tmodel, make_fcn_optimizer(tmodel, optim="adam", lr=1e-5))
        tgen = torch.Generator(device=dev).manual_seed(0)
        tbatch = train_batch(TRAIN_BATCH, 0)
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        dlosses = []
        for _ in range(TRAIN_STEPS):
            tstate, aux = step(tstate, tbatch, tgen)
            dlosses.append(aux["loss"])
        torch.cuda.synchronize()
        dlaunches = dict(_kernels.launch_counts)
        dlosses = [x.item() for x in dlosses]
        log(f"[dot-free] launches in {TRAIN_STEPS} stage-1 steps: "
            f"{dlaunches}; losses {dlosses} (default mode {tlosses})")
        require(dlaunches["pdot"] == 3 * TRAIN_STEPS,
                f"K7 launched {dlaunches['pdot']} times in {TRAIN_STEPS} "
                f"dot-free steps, not 3 per step")
        # fc6's input gradient and fc7's weight gradient on tma, score_fr's
        # weight gradient (N = 20) on narrow
        require(dlaunches["pdot_tma"] == 2 * TRAIN_STEPS
                and dlaunches["pdot_narrow"] == TRAIN_STEPS,
                f"K7's variants in the dot-free steps: {dlaunches}")
        for key in ("block1_train_fwd", "block1_train_bwd", "costail_fwd",
                    "costail_bwd"):
            require(dlaunches[key] == TRAIN_STEPS,
                    f"{key} under the dot-free mode: {dlaunches}")
        require(all(np.isfinite(x) for x in dlosses), f"losses {dlosses}")
        # one fp32 step at B=2, dot-free (K7) vs default (cuBLAS, cuDNN)
        aux_d, grads_d = fp32_step(False)
        dotpolicy.set_dot_free(False)
        aux_c, grads_c = fp32_step(False)
    finally:
        dotpolicy.set_dot_free(None)
    torch.cuda.synchronize()
    d_rels = {n: rel(grads_d[n], grads_c[n]) for n in grads_c}
    d_worst = max(d_rels, key=d_rels.get)
    log(f"[dot-free] fp32 B=2 step, K7 vs cuBLAS/cuDNN: loss "
        f"{aux_d['loss'].item():.7f} vs {aux_c['loss'].item():.7f}, worst "
        f"gradient rel-norm {d_rels[d_worst]:.3e} ({d_worst}); fc6.weight "
        f"{d_rels['fc6.weight']:.1e}, fc7.weight {d_rels['fc7.weight']:.1e}"
        f", score_fr.weight {d_rels['score_fr.weight']:.1e}, conv1_1.weight"
        f" {d_rels['conv1_1.weight']:.1e}")
    require(set(grads_d) == set(grads_c), "dot-free gradient sets differ")
    require(abs(aux_d["loss"].item() - aux_c["loss"].item())
            <= 1e-5 * abs(aux_c["loss"].item()), "dot-free fp32 step loss")
    require(d_rels[d_worst] < grad_bar,
            f"dot-free fp32 gradient {d_worst} rel {d_rels[d_worst]}")
    del grads_d, grads_c

    # ---- 13. stage 2 ------------------------------------------------------
    seen = ~unseen_mask_vector(k_cls, UNSEEN)
    sbatch = train_batch(TRAIN_BATCH, 3)
    stage2 = {}
    for mode in (False, True):
        dotpolicy.set_dot_free(mode)
        try:
            smodel = train_model(torch.bfloat16)
            before = {n: p.detach().clone()
                      for n, p in smodel.named_parameters()}
            sstate = TrainState.create(
                smodel, make_seenmask_optimizer(smodel, lr=1e-3))
            sstep = make_seenmask_train_step(seen_vec=seen)
            sgen = torch.Generator(device=dev).manual_seed(0)
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            saux = []
            for i in range(STAGE2_STEPS):
                if i == STAGE2_STEPS - 1:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    sstate, aux = sstep(sstate, sbatch, sgen)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                saux.append(aux)
            torch.cuda.synchronize()
            slaunches = dict(_kernels.launch_counts)
            slosses = [a["loss"].item() for a in saux]
            log(f"[stage2] dot_free={mode}: launches in {STAGE2_STEPS} "
                f"steps {slaunches}; losses {slosses}; hist "
                f"{saux[-1]['hist'].tolist()}; seenmask_grad_sum "
                f"{[a['seenmask_grad_sum'].item() for a in saux]}")
            require(slaunches["pdot"] == slaunches["pdot_narrow"]
                    == (STAGE2_STEPS if mode else 0),
                    f"stage 2 K7 launches {slaunches} (dot_free={mode}; the "
                    f"seenmask_score weight gradient, N = 2, on narrow)")
            require(slaunches["block1_fused"] == STAGE2_STEPS,
                    f"stage 2 must run block 1 through K2 once per step: "
                    f"{slaunches}")
            require(slaunches["block1_train_fwd"] == 0
                    and slaunches["block1_train_bwd"] == 0,
                    f"stage 2 built a backbone backward: {slaunches}")
            require(all(np.isfinite(x) for x in slosses),
                    f"stage 2 losses {slosses}")
            for n, p in smodel.named_parameters():
                moved = not torch.equal(p.detach(), before[n])
                trained = n.split(".")[0] in FROZEN_MODULES
                require(moved == trained,
                        f"stage 2: {n} {'moved' if moved else 'stayed'}")
            del before
            torch.cuda.reset_peak_memory_stats()
            s_ms = time_ms(lambda: sstep(sstate, sbatch, sgen),
                           iters=TIMED_STEPS, warmup=1)
            stage2["dot_free" if mode else "default"] = {
                "ms_per_step": s_ms,
                "images_per_s": TRAIN_BATCH / (s_ms / 1e3),
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 1e9}
            del smodel, sstate, saux
        finally:
            dotpolicy.set_dot_free(None)
    del sbatch

    # ---- 14. eval steps -----------------------------------------------------
    evals = phase_eval(dev, model, train_batch, embed, uv, k_cls, log,
                       require, flip_rate)

    # ---- 15. times ------------------------------------------------------------
    # the stage-1 step, default and dot-free in turns on the same state
    s1 = {"default": [], "dot_free": []}
    try:
        for mode in (False, True, True, False):
            dotpolicy.set_dot_free(mode)
            s1["dot_free" if mode else "default"].append(time_ms(
                lambda: step(tstate, tbatch, tgen), iters=TIMED_STEPS,
                warmup=1))
    finally:
        dotpolicy.set_dot_free(None)
    del tstate, tmodel, tbatch
    log(json.dumps({"train_stage1_modes": {
        k: {"ms_per_step": v, "images_per_s": [TRAIN_BATCH / (x / 1e3)
                                               for x in v]}
        for k, v in s1.items()}, "batch": TRAIN_BATCH, "dtype": "bfloat16",
        "order": "default, dot-free, dot-free, default"}))
    log(json.dumps({"train_stage2": stage2, "batch": TRAIN_BATCH,
                    "hw": [H, W], "dtype": "bfloat16",
                    "steps_timed": TIMED_STEPS}))
    log(json.dumps({"eval": evals}))
    log(json.dumps({"pdot": pdot_rows}))
    fc6_row = pdot_rows[0]
    log(f"[times] K7 fc6 input gradient ({fc6_row['m']}x{fc6_row['k']}x"
        f"{fc6_row['n']}, px {px}): {fc6_row['ms']:.3f} ms (plain "
        f"{fc6_row['plain_ms']:.3f}, torch.matmul {fc6_row['library_ms']:.3f}"
        f", bound {fc6_row['bound_ms']:.3f})")

    # ---- 16. conv1_1 alone (K8) -------------------------------------------
    c11 = phase_c11(dev, b1, _kernels, log, require)

    # ---- 17. the first-max pool backward (K9) -----------------------------
    pool = phase_pool(dev, model, _kernels, log, require)

    # ---- 18. the row dot (K10b) and the probe's product on K7 (K10a) -------
    rdot = phase_rowdot(dev, rd, pd, log, require)

    # ---- 19. the H2D probe's two kernel modes -------------------------------
    probe = phase_probe(log, require)

    # ---- 20. the train CLI on the card ----------------------------------------
    tcli = phase_train_cli(dev, embed, img_s, log, require)
    cli_launches = tcli["launches"]

    src = "zeroshotsemanticsegmentation_tpu_torch/csrc/"
    ref = "zeroshotsemanticsegmentation_tpu/ops/"
    kernels = [
        {"name": "szn_fused_labels", "route": "cuda",
         "source": src + "szn_fused.cu",
         "replaces": ref + "szn_fused.py:44",
         "launches": launches["szn_fused"],
         "launches_train_cli": cli_launches["szn_fused"],
         "launches_eval": evals["k1_launches"], "max_abs_err": k1_maxerr,
         "flip_rate": k1_flips, "flip_rate_k33": k33_flips,
         "flip_rate_ties": tie_flips, "ms": k1_ms,
         "device_ms": k1_device_ms, "plain_ms": k1_plain_ms,
         "device_ms_nne": k1_nne_device_ms,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "shape": [SERVE_BATCH, 17, 17, kp1, H, W], "build": k1_build},
        {"name": "block1_fused_forward", "route": "cuda",
         "source": src + "block1_fused.cu",
         "replaces": ref + "block1_fused.py:485",
         "launches": launches["block1_fused"],
         "launches_train_cli": cli_launches["block1_fused"],
         "max_abs_err": k2_bf16_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib_ms,
         "shape": [SERVE_BATCH, H + 10, W + 10, 3], "dtype": "bfloat16",
         "bit_equal": k2_bit_equal, "serving_bar": sbar,
         "design": "block1_fused_wgmma: persistent, conv1_1 as a K=32 "
                   "wgmma GEMM from the input patch into the c11 tile, "
                   "conv1_2 on c3w::conv_mainloop, PoolStore epilogue; fp32 "
                   "keeps the CUDA-core block1_kernel",
         "build": k2_build},
        {"name": "block1_train_forward", "route": "cuda",
         "source": src + "block1_train.cu",
         "replaces": ref + "block1_fused.py:288",
         "launches": tlaunches["block1_train_fwd"],
         "launches_train_cli": cli_launches["block1_train_fwd"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": k3_lib_ms,
         "shape": [TRAIN_BATCH, hc, hc, 64], "dtype": "bfloat16",
         "design": "conv2_pool_fwd_wgmma: persistent wgmma m64n64k16 "
                   "implicit GEMM (csrc/conv3x3_wgmma.cuh), pool epilogue; "
                   "fp32 keeps the CUDA-core conv2_pool_fwd",
         "build": {k: v for k, v in b1_build.items()
                   if k == "conv2_pool_fwd_wgmma"}},
        {"name": "block1_train_backward", "route": "cuda",
         "source": src + "block1_train.cu",
         "replaces": ref + "block1_fused.py:676",
         "launches": tlaunches["block1_train_bwd"],
         "launches_train_cli": cli_launches["block1_train_bwd"], "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
         "bound_by": k4_by, "library_ms": k4_lib_ms,
         "shape": [TRAIN_BATCH, hc, hc, 64], "dtype": "bfloat16",
         "parts_ms": k4_parts, "wgrad_chunks": k4_chunks,
         "checks": k4_checks, "bf16_step_bar": "kernels <= 2x plain",
         "design": "route and dgrad on K3's wgmma mainloop, "
                   "conv2_wgrad_wgmma (wgmma, MN-major c11 taps) + ordered "
                   "fp64 reduce; fp32 keeps the CUDA-core kernels",
         "build": {k: v for k, v in b1_build.items()
                   if k in ("conv2_pool_route_wgmma", "conv2_wgrad_wgmma",
                            "conv2_dgrad_wgmma", "wgrad_reduce")}},
        {"name": "costail_forward", "route": "cuda",
         "source": src + "costail_fused.cu",
         "replaces": ref + "costail_fused.py:108",
         "launches": tlaunches["costail_fwd"],
         "launches_train_cli": cli_launches["costail_fwd"],
         "max_abs_err": tail_errs[20][0], "ms": tail20["k5_ms"],
         "device_ms": tail20["k5_device_ms"],
         "bound_share": tail20["k5_share"],
         "coherent_ms": tail20["k5_coherent_ms"],
         "coherent_device_ms": tail20["k5_coherent_device_ms"],
         "plain_ms": tail20["k5_plain_ms"], "bound_ms": tail20["k5_bound"],
         "bound_by": tail20["k5_by"], "library_ms": None,
         "shape": [TRAIN_BATCH, H, W, 20, k_cls],
         "widths_checked": [[20, 21], [50, 21], [300, 33], [21, 21]],
         "max_abs_err_by_width": {str(c): e[0] for c, e in tail_errs.items()},
         "cases": tail_cases,
         "c300": {k: tail300[k] for k in (
             "k5_ms", "k5_device_ms", "k5_share", "k5_coherent_ms",
             "k5_coherent_device_ms", "k5_plain_ms", "k5_bound", "k5_by",
             "plain_batch")},
         "design": "persistent pipelined stream: bulk-copy (TMA) ring of "
                   "3-4 tile stages, one mbarrier a stage; register form "
                   "(C in 2/5/10/20/21, 2 px a thread) or wide form (8 "
                   "lanes a pixel pair, 2 x 11 register-blocked argmax); "
                   "warp-aggregated histogram; ordered partials",
         "build": {k: v for k, v in k56_build.items()
                   if k.startswith("costail_fwd") or k == "costail_finalize"}},
        {"name": "costail_backward", "route": "cuda",
         "source": src + "costail_fused.cu",
         "replaces": ref + "costail_fused.py:145",
         "launches": tlaunches["costail_bwd"],
         "launches_train_cli": cli_launches["costail_bwd"],
         "max_abs_err": tail_errs[20][1], "ms": tail20["k6_ms"],
         "device_ms": tail20["k6_device_ms"],
         "bound_share": tail20["k6_share"],
         "plain_ms": tail20["k6_plain_ms"], "bound_ms": tail20["k6_bound"],
         "bound_by": tail20["k6_by"], "library_ms": None,
         "shape": [TRAIN_BATCH, H, W, 20, k_cls],
         "widths_checked": [[20, 21], [50, 21], [300, 33], [21, 21]],
         "max_abs_err_by_width": {str(c): e[1] for c, e in tail_errs.items()},
         "c300": {k: tail300[k] for k in (
             "k6_ms", "k6_device_ms", "k6_share", "k6_plain_ms", "k6_bound",
             "k6_by", "plain_batch")},
         "design": "the forward's ring, d score computed in place and "
                   "stored by bulk copies (fence.proxy.async, "
                   "wait_group.read before the stage is refilled)",
         "build": {k: v for k, v in k56_build.items()
                   if k.startswith("costail_bwd")}},
        {"name": "pdot", "route": "cuda", "source": src + "pdot.cu",
         "replaces": ref + "pdot.py:47",
         "launches": dlaunches["pdot"],
         "launches_train_cli": cli_launches["pdot"],
         "launches_stage2_dot_free": STAGE2_STEPS,
         "max_abs_err": fc6_row["max_abs_err"], "ms": fc6_row["ms"],
         "plain_ms": fc6_row["plain_ms"], "bound_ms": fc6_row["bound_ms"],
         "bound_by": fc6_row["bound_by"],
         "library_ms": fc6_row["library_ms"],
         "shape": [fc6_row["m"], fc6_row["k"], fc6_row["n"]],
         "dtype": "bfloat16 in, float32 out", "variant": fc6_row["variant"],
         "launches_by_variant": {v: dlaunches[f"pdot_{v}"] for v in (
             "tma", "narrow", "wmma", "fp32")},
         "design": "tma: TMA ring + wgmma, one producer and two consumer "
                   "warpgroups, persistent; narrow: wgmma n8/16/24, cp.async "
                   "ring, 512-deep K chunks + ordered reduce; wmma and fp32 "
                   "for the other shapes",
         "build": k7_build, "shapes": pdot_rows},
        {"name": "conv1_1_pairs", "route": "cuda",
         "source": src + "conv1_1.cu",
         "replaces": ref + "block1_fused.py:201",
         "launches": c11["launches"], "max_abs_err": c11["max_abs_err"],
         "max_abs_err_fp32": c11["max_abs_err_fp32"], "ms": c11["ms"],
         "plain_ms": c11["plain_ms"], "bound_ms": c11["bound_ms"],
         "bound_by": c11["bound_by"], "library_ms": c11["library_ms"],
         "shape": c11["shape"], "dtype": "bfloat16",
         "device_ms": c11["device_ms"], "differ_share": c11["differ_share"],
         "rel_err_vs_fp32": c11["rel_err_vs_fp32"], "build": k8_build},
        {"name": "pool_bwd", "route": "cuda", "source": src + "pool_bwd.cu",
         "replaces": "scripts/experiments/pool_bwd_pallas.py:111",
         "launches": pool["launches"], "max_abs_err": pool["max_abs_err"],
         **{k: pool["shapes"][0][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "shape", "dtype")},
         "shapes": pool["shapes"]},
        {"name": "rowdot", "route": "cuda", "source": src + "rowdot.cu",
         "replaces": "scripts/probe_h2d.py:763",
         "launches": probe["rowdot_pl"]["launches"]["rowdot"],
         **{k: rdot[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "shape")}},
        {"name": "pdot (probe 512x512 fp32, K10a)", "route": "cuda",
         "source": src + "pdot.cu", "replaces": "scripts/probe_h2d.py:258",
         "launches": probe["pallas_dot"]["launches"]["pdot"],
         **rdot["k10a"], "dtype": "float32"},
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
