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
   through the plain versions (fp32; the ring pads' concatenations too),
   vs the unfused full-resolution NNE
   reference, and the trained-upscore route; the serving bf16 bar
   (scripts/torch_serving_bar.py): bf16 labels through the kernels at most
   2x as far (flip rate) from the fp32 labels as bf16 labels with block 1
   through its plain version and fc6's forward on F.conv2d;
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
   versions; fc6's forward on its implicit-GEMM kernel once a step; then
   the bf16 bar: the same B=2 step in bf16 through the kernels and in bf16
   with K3/K4 through their plain versions and fc6's forward on F.conv2d,
   each parameter's gradient vs the fp32 step's, the kernels' error at most
   2x the plain versions';
10. times with CUDA events: the train step at B=24, 512x512, bf16 (the JAX
   package's bench_train configuration), its peak memory, and K3-K6 at the
   step's shapes beside their plain versions, bounds and library calls
   (K5/K6 by CUDA events and by device time with the share of the bound
   reached, K5 also with coherent labels, both also at C=300, K=33), K4's
   route, dK2 + reduction and d(c11) steps each alone;
11. the matmul kernel (K7) vs its plain version at the four products the
   dot-free model runs at B=24 (bf16 in, fp32 out) and at ragged tma
   shapes; its fp32 route at those four products, at the JAX tests' edge
   shapes and at 512^3 (both layouts) vs an fp64 product (relative norm <
   1e-5); each product's variant (tma, narrow, wmma, and the fp32
   instances fp32, fp32_narrow, fp32_scalar, fp32_narrow_scalar) logged
   with its own launch count, two calls bit-equal; its times at the four
   products in bf16 and in fp32 (also by device time alone, as
   torch.matmul's with TF32 off), beside the bound;
12. stage 1 under the dot-free mode: three B=24 steps from phase 9's
   weights, batch and generator seed; K7 exactly 3 launches per step (two
   tma, one narrow), K3-K6 one each; one fp32 step at B=2 with the mode on
   (K7's fp32 route: 3 launches) vs off (cuBLAS / cuDNN) at phase 9's
   gradient bar, and that step's time in each mode, in turns;
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
   product vs an fp64 product (relative norm < 1e-5), two calls bit-equal
   and one device kernel a call (torch.profiler), and their times
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
   1's step count, and one more epoch (`cli_run_and_resume`; the run's
   checkpoint is kept for phase 21); one loop timing of FCNTrainer at
   B=24, 512x512, the compact feed, 40 steps after a warm-up with host
   syncs turned into errors between log flushes (two flushes inside the
   epoch): its img/s over the epoch and in the steady window after the
   first step, beside the bare step on the same trainer and phase 10's,
   the loader's first batch and rate alone, the save time of one
   checkpoint and the peak memory;
21. FCN-8s, the predict and export CLIs and int8 serving
   (`phase_fcn8s_int8`): FCN-8s serving at B=64 (K2 once a call, K1
   never; vs K2's plain version; the serving bf16 bar; fp32 B=2 flips <
   1e-4), FCN-8s stage 1 at B=24 (K3-K6 once a step, K2 never; fp32 B=2
   gradients vs the plain versions < 1e-4), FCN-8s stage 2 (K2 once, only
   `seenmask_score` moves), the train CLI with `--arch fcn8s` and its
   resume, `cli.predict`'s `build_predictor` and `predict_arrays` from
   both checkpoints (and `--int8`), `cli.export` on phase 20's checkpoint
   (round trip; FCN-8s refused), int8 serving of FCN-32s at B=64 (K1 once,
   K2 never, flips vs bf16 < 0.08); times, peak memory and profile windows
   of FCN-8s serving, its stage-1 step and int8 serving. The kernels line
   carries each kernel's launches on these paths;
22. multi-device (`phase_mesh`): (a) `make_mesh(1, 1)` on a one-rank NCCL
   group, three bf16 B=24 stage-1 steps bit-equal to the bare step's
   (where two bare runs are; cuDNN deterministic), and the step's time on
   the mesh path beside the bare one's; (b) two ranks sharing the card
   over gloo: DP=2, TP=2 and the 2x1x1 multislice mesh vs one device
   (fp32, dropout on: loss, parameters, the first step's gradients,
   hist), bf16 DP=2 at B=24 (K3-K6 once a rank and step), the dot-free
   mode on TP=2 (K7 at the TP shard shapes), the fused SZN eval on DP=2
   and TP=2, serving at B=64 on DP=2 in fp32 and bf16 (K2, K1 once a rank
   and call), TP=2 serving, the trained gate and FCN-8s's unfused route;
   (c) the train CLI with `--data_parallel 2` on two ranks, its files,
   checkpoint and resume. The kernels line carries each kernel's launches
   on these paths, by rank;
23. height-sharded serving and int8 serving on a mesh (`phase_spatial`):
   (a) `make_szn_predictor(..., mesh=make_mesh(1, 1), spatial=True)` on a
   one-rank NCCL group, FCN-32s at full width, B=1, 2048x2048: fp32 labels
   vs the one-device predictor (flips < 1e-4), bf16 under the serving bar,
   K2 and K1 once a call; K2 and K1 on the bands of this image's two-band
   plan vs their plain versions (the bf16 bar of phase 4; flips < 1e-4)
   and vs the whole call's rows (K1 equal); both predictors timed in turns
   in bf16, and a profile window of each; (b) two ranks sharing the card
   over gloo at 512x512 vs one device: spatial data=2 on the pristine
   gate, the trained gate and FCN-8s (flips < 1e-4), int8 DP=2 and TP=2 at
   B=8 and int8 spatial data=2 (equal to the one-device int8 labels: flips
   < 1e-4; < 0.08 from the one-device bf16 labels); (c) one 4096x4096
   image, bf16, over the two ranks: each rank's peak memory below 0.75x
   the one-device run's.
   The kernels line carries K1's and K2's launches on these paths, by
   rank, and their band checks;
24. the native decoder (`phase_decoder`; host C++, not a kernel): (a) built
   from zeroshotsemanticsegmentation_tpu_torch/csrc/zss_loader.cc with g++
   (libjpeg where the compiler finds jpeglib.h, else nvJPEG), the
   toolchain printed; (b) the committed JPEG fixtures
   (scripts/torch_make_decode_fixtures.py) within DECODE_MEAN_ERR /
   DECODE_MAX_ERR of their seeded sources and DECODE_VS_LIBJPEG levels of
   libjpeg's pixels (bit-equal to the recorded SHA-256 printed), PNG
   labels from a stdlib writer (8-bit and 1/2/4-bit gray and palette,
   Adam7) and `.mat` labels (scipy, compressed and not) exact, corrupt,
   truncated and oversized files to their error codes; (c) a VOC/SBD
   tree of links to the fixtures in the temporary directory, 960 train and
   96 val ids, and the native presence scan of preset 14's train_seen;
   (d) the feed alone at 1, 2, 4 and 8 threads; (e) FCNTrainer at B=24 over
   the tree, as phase 20's loop, beside its bare step and phase 20's
   synthetic loop, every batch natively decoded; (f) `-c 14 -ve 1 -se 0`
   through the train CLI on the tree at full width, its log naming the
   native decoder. (c)-(f) run with `import PIL` failing. The kernels line
   adds the decoder's batches;
25. rematerialized blocks, overlapped saves, the decoder's device
   (`phase_remat`): (a) a full-width bf16 FCN-32s stage-1 step at B=24
   with `remat=True` beside the plain step (same weights, batch, dropout
   seed): gradients bit-equal or within the bf16 bar, the fp32 pair
   (TF32 off) at the gradient bar, launches (K3 2, K4 1, K5 1, K6 1 a
   remat step), times and peak memory; (b) the pair unpruned at the first
   batch that fits; (c) FCN-8s's pair; (d) the train CLI with `--remat`
   and its resume; (e) a routine checkpoint save's return time and its
   `finish_pending` beside a blocking save, the files equal; (f)
   `build_info()["device"]` after nvJPEG decodes. The kernels line adds
   K3-K6's remat launches;
26. parity evidence on the card (`phase_parity`): (a)
   scripts/torch_parity_evidence.py's bf16 drift: the full-width bf16
   FCN-32s trained 12 stage-1 steps at B=8, 512x512 (K3-K6 at least once a
   step), then 4 x 8 images served through the production predictor (K2,
   K1 at least once a call), through K1 and K2's plain versions and in
   fp32 (unpruned, TF32 off): the kernels' label flips vs fp32 at most 2x
   the plain versions', the metric |delta|s logged; (b) the context-59
   label tool (scripts/torch_make_context59_labels.py) on seeded `.mat`
   fixtures through its CLI and `convert` with `import PIL` failing, its
   PNGs read back through the native decoder and `PascalContext(n_classes=
   59)` equal to the remap, and whether Pillow is importable here. The
   kernels line adds K1-K6's launches there.
27. the measurement programs (`phase_bench`): the bench's serving, train
   and loop modes (`zeroshotsemanticsegmentation_tpu_torch.bench`), the
   trained-gate serving bench and the stage-2 step bench
   (scripts/torch_bench_trained_gate.py, torch_bench_seenmask_step.py),
   each at its real shapes with its warm and timed run, in this process:
   each one's launches of K1-K6 (serving K1 and K2 once a chain step,
   train and loop K3-K6 once a step, the trained gate K1 three times and
   K2 twice a step over its two chains, stage 2 K2 once a step; fc6's
   kernel as often as K2 serving and K3 training), finite
   non-zero checksums, 0 < mfu < 1.05, peak memory above 0, and no host
   sync in the timed chains (each timed under the sync debug mode "error",
   which raises here on a fetch); then the ratchet
   (scripts/torch_bench_gate.py) in fresh processes on a temporary record
   directory: the first run writes the record (rc 0), the second passes
   (rc 0), a record forged at 10x fails it (rc 1). Prints the five lines;
   the kernels line adds K1-K6's launches there;
28. fc6's implicit-GEMM forward alone (`phase_fc6`), bf16, at B=16 and
   B=24, (B, 512, 23, 23) -> 4096: one launch a call, two calls bit-equal,
   every output within one bf16 ulp (plus 2^-13 of the output's scale) of
   the exact product and its error norm at most 1.01x cuDNN's bf16
   output's; its time beside its bound, cuDNN's
   F.conv2d and torch.matmul over the materialised patch matrix. Its
   kernels-line row gathers its launches on the paths of phases 5, 9 and
   20-27;
29. DeepLab-v2 ResNet-101 on the serving path and K1 at x8
   (`phase_deeplab`): the model at its published widths (bf16, seeded
   weights) serves a B=16 batch of VOC-sized images in the 512 bucket
   through `predict_arrays` and `make_szn_predictor`: K1 once a request
   and no fold of batch norm after the first, its labels vs K1's plain
   version on the same heads (flips < 1e-4, phase 3's bar); K1 alone at
   the x8 geometry (stride 8, kernel 16, crop 4) on (16, 64, 64, K+1)
   heads vs its plain version (flips < 1e-4, one launch a call, two calls
   bit-equal), its time beside `benchmark.bounds.k1_bound_s` at
   h8 = w8 = 64 in its own kernels-line row;
30. the ring pads alone (`phase_ring_pad`): `csrc/ring_pad.cu` at the ten
   pads of an FCN-32s forward at the 512 bucket (blocks 2-4, read from
   `run_pruned_blocks`), bf16, B=16 and B=64: one launch a pad, each bit-
   equal to its plain version; the forward's pads by CUDA events and
   device time beside their bytes bound and the plain version's time, and
   each pad's device time; `ring_sum` over the same pads at B=24, each
   sum within bf16's rounding plus 1e-5 of the ring's sum of magnitudes
   of its plain version's fp32 sum. Its kernels-line row adds the
   serving, stage-1 and train-CLI launches, and each path's of phases
   21-27, where every path that ran the pruned blocks on the card (K2 or
   K3 launched, or int8) launched `ring_pad`, and every one that ran K4
   `ring_sum`. Phases 5, 9 and 21's plain runs take the pads'
   concatenations (`kernel_takes` patched), so their bars hold the pads
   too.

The script reaches no network: `urllib.request.urlretrieve` raises in it,
so the train CLI's VGG16 fetch of a fresh real-data run (phase 24 (f))
fails and the run goes on with a warning.

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
import tempfile
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
# K7's fp32 instances' launch counts (`pdot_plan`)
F32_COUNTS = ("pdot_fp32", "pdot_fp32_narrow", "pdot_fp32_scalar",
              "pdot_fp32_narrow_scalar")


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


SPIN_CYCLES = 50_000_000   # about 30 ms of the card's clock


def profiled(fn, iters: int) -> list:
    """torch.profiler's key_averages() entries with device time over a
    window of `iters` calls of `fn`, the calls after a ~30 ms spin kernel
    (left out). Late in this script a window can miss kernels: of 3 calls
    of a 36 ms kernel 2 were recorded without the spin, and of 4 calls of
    a 20-microsecond one 3 with it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.self_device_time_total > 0 and "spin_kernel" not in e.key]


def _per_call_us(e, iters: int) -> float:
    """A profiler entry's device microseconds a call: its mean time times
    its launches a call (recorded launches over `iters`, rounded), or, for
    a kernel that runs in fewer than half the calls, its total over
    `iters`."""
    n = round(e.count / iters)
    return (e.self_device_time_total / e.count * n if n >= 1
            else e.self_device_time_total / iters)


def device_ms(fn, iters: int, name: str = "") -> float:
    """Device time of one call of `fn` from torch.profiler over `iters`
    calls (after a warm-up), of the kernels whose name holds `name`, each
    kernel's by `_per_call_us`, so a launch the profiler missed does not
    lower the time. Unlike `time_ms` it leaves out the host's time
    between launches, which sets the event time of a product as small as
    the probe's. A window that recorded no such kernel is profiled again,
    up to three windows; then the script fails."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        got = [e for e in profiled(fn, iters) if name in e.key]
        if got:
            return sum(_per_call_us(e, iters) for e in got) / 1e3
        log(f"[profiler] no device time recorded for {name or 'the call'}; "
            "profiling again")
    fail(f"torch.profiler recorded no device time for {name or 'the call'} "
         "in three windows")


def kernels_per_call(fn, calls: int = 8) -> dict:
    """{device kernel name: recorded launches over `calls` calls} of `fn`
    (after a warm-up call), from torch.profiler; a launch the profiler
    missed lowers a value below its launches a call, and a kernel that
    runs in no call is absent. A window that recorded no kernel is
    profiled again, up to three windows."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        got = {e.key: e.count / calls for e in profiled(fn, calls)}
        if got:
            return got
        log("[profiler] no device kernel recorded; profiling again")
    fail("torch.profiler recorded no device kernel in three windows")


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
    output's root-mean-square), at ragged tma shapes; the fp32 route at the
    four shapes, the edge shapes and 512^3 vs an fp64 product (relative
    Frobenius norm < 1e-5); each product's variant (`pdot_plan`) with its
    own launch count, two calls bit-equal; each path shape's times, bf16
    and fp32, beside the plain version, torch.matmul and the bound.
    Returns (bf16 rows, fp32 rows)."""
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
    def f32_check(name, a, b, trans):
        """K7's fp32 route vs an fp64 product and its plain version (cuBLAS
        fp32, TF32 off): (max |err| vs plain, rel-norm vs fp64, plan)."""
        plan = pd.plan_for(a, b, trans_a=trans)
        key = "pdot_" + plan["variant"]
        before = kernels.launch_counts[key]
        got = pd.pdot(a, b, trans_a=trans)
        again = pd.pdot(a, b, trans_a=trans)
        torch.cuda.synchronize()
        launched = kernels.launch_counts[key] - before
        same = torch.equal(got, again)
        del again
        err = (got - pd.pdot_plain(a, b, trans_a=trans)).abs().max().item()
        r = rel(got, (a.double().t() if trans else a.double()) @ b.double())
        log(f"[K7] {name} fp32 (trans_a={trans}): {plan['variant']} "
            f"({plan['splits']} K chunks, one cluster), rel-norm vs fp64 "
            f"{r:.3e} (bar 1e-5), max|err| vs plain {err:.3e}, two calls "
            f"bit-equal: {same}")
        require(launched == 2, f"K7 {name} fp32: {launched} {key} launches "
                "of 2")
        require(r < 1e-5, f"K7 fp32 {name} rel {r}")
        require(same, f"K7 fp32 {name}: two calls differ")
        return err, r, plan

    # the fp32 route at the model's four products, timed
    f32_rows = []
    for name, m, k, n, trans in PDOT_SHAPES:
        a, b = operands(m, k, n, trans, torch.float32)
        err, r, plan = f32_check(name, a, b, trans)
        a_lib = a.t() if trans else a
        ops = 2.0 * m * k * n
        b_ms, by = bound((a.numel() + b.numel() + m * n) * 4, ops,
                         PEAK_FP32_FLOP_S)
        iters = 3 if ops > 1e12 else 10

        def k7():
            return pd.pdot(a, b, trans_a=trans)

        def lib():
            return torch.matmul(a_lib, b)

        row = {"name": name, "m": m, "k": k, "n": n, "trans_a": trans,
               "variant": plan["variant"], "splits": plan["splits"],
               "ms": time_ms(k7, iters=iters),
               "device_ms": device_ms(k7, iters=iters),
               "plain_ms": time_ms(lambda: pd.pdot_plain(
                   a, b, trans_a=trans), iters=iters),
               "library_ms": time_ms(lib, iters=iters),
               "library_device_ms": device_ms(lib, iters=iters),
               "bound_ms": b_ms, "bound_by": by, "max_abs_err": err,
               "rel_norm": r, "bit_equal": True}
        row["tflop_s"] = ops / row["device_ms"] / 1e9
        row["bound_share"] = b_ms / row["device_ms"]
        f32_rows.append(row)
        log(f"[K7] {name} fp32 ({plan['variant']}, {plan['splits']} "
            f"splits): {row['ms']:.4f} ms, device {row['device_ms']:.4f} "
            f"({row['tflop_s']:.1f} TFLOP/s, {100 * row['bound_share']:.1f}% "
            f"of the bound {b_ms:.4f}, {by}); torch.matmul (TF32 off) "
            f"{row['library_ms']:.4f}, device {row['library_device_ms']:.4f};"
            f" plain {row['plain_ms']:.4f}")
        del a, b, a_lib
        torch.cuda.empty_cache()
    for m, k, n in PDOT_EDGES + ((512, 512, 512),):
        for trans in (False, True):
            a, b = operands(m, k, n, trans, torch.float32)
            f32_check(f"{m}x{k}x{n}", a, b, trans)
            if (m, k, n) in PDOT_EDGES:
                bf16_check(f"{m}x{k}x{n}", a.bfloat16(), b.bfloat16(), trans)
    return rows, f32_rows


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
    product vs fp64 (one kernel a call; the clusters the card places at
    once), and both kernels' times."""
    import ctypes

    import torch
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels as kernels

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
    require(torch.equal(got, pd.pdot(a, b)), "K7 at 512x512 fp32: two calls "
            "differ")
    per_call = kernels_per_call(lambda: pd.pdot(a, b))
    log(f"[K10a] device kernels in one call: {per_call}")
    # the split-K launch's clusters that the card places at once
    max_clusters = kernels.function("pdot", "pdot_f32_max_clusters",
                                    [kernels.I, kernels.I, kernels.P])
    placed = {}
    for splits in (1, 2, 4, 8):
        got = ctypes.c_int(0)
        kernels.check("pdot", max_clusters(0, splits, ctypes.byref(got)))
        placed[splits] = got.value
    log(f"[K10a] clusters of 1/2/4/8 blocks of pdot_f32<0,0,1> the card "
        f"runs at once: {placed}; this launch: "
        f"{(512 // 128) ** 2} clusters of {plan['splits']}")
    # one kernel name, at most one launch a call (a launch the profiler
    # missed shows as less than 1)
    require(len(per_call) == 1 and "pdot_f32" in next(iter(per_call))
            and 0.5 <= next(iter(per_call.values())) <= 1,
            f"one fp32 pdot call at 512^3 is not one kernel: {per_call}")
    b_ms, by = bound(3 * 512 * 512 * 4, 2.0 * 512 ** 3, PEAK_FP32_FLOP_S)
    out["k10a"] = {
        "max_abs_err": err, "rel_norm": r, "shape": [512, 512, 512],
        "variant": plan["variant"], "splits": plan["splits"],
        "ms": time_ms(lambda: pd.pdot(a, b), iters=20),
        "plain_ms": time_ms(lambda: pd.pdot_plain(a, b), iters=20),
        "library_ms": time_ms(lambda: torch.matmul(a, b), iters=20),
        "device_ms": device_ms(lambda: pd.pdot(a, b), iters=20),
        "library_device_ms": device_ms(lambda: torch.matmul(a, b), iters=20),
        "bound_ms": b_ms, "bound_by": by,
        "kernels_per_call": len(per_call),
        "max_active_clusters": placed}
    k = out["k10a"]
    k["bound_share"] = b_ms / k["device_ms"]
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


def cli_run_and_resume(tmp: str, arch: str, log, require,
                       remat: bool = False) -> dict:
    """The train CLI's `-c 14 --synthetic -ve 1 -se 1 --arch <arch>` run
    on the card, and a resume from its last checkpoint (phase 20 for
    FCN-32s, phase 21 (d) for FCN-8s; with `remat`, both with `--remat`,
    phase 25 (d): K3 runs twice a stage-1 step, again in the backward).
    The first run returns with its checkpoint complete (saves overlap
    training).

    The run: full width, bf16, the preset's batch sizes (1, 1), so 6
    stage-1 steps, 4 validation images, 8 stage-2 steps and a second
    validation. `num_viz` is set to 0 through `run_experiment`'s cfg: the
    card's machine has no Pillow to write the viz tiles. Its files, finite
    losses, the checkpoint's arch, and the launch counts computed from the
    loaders' lengths: K3-K6 once a stage-1 step; K2 once a stage-2 step and
    once a validation batch of either stage (every forward without
    autograd); K1 once a stage-1 validation batch for FCN-32s (the fused
    NNE eval) and never for FCN-8s (no raw heads: the unfused eval); K7
    never. The resume: `-r <log_dir>/checkpoint -ve 2 -se 0` restores the
    parameters and Adam's moments bit-equal to the file, starts at stage
    1's step count (the file is stage 2's last save, which keeps stage 1's
    counters) and trains one more epoch. The first run's log directory
    (config.yaml, `checkpoint`) is kept for the predict and export CLIs;
    its `best` and the resumed run's directory are removed."""
    import torch
    from zeroshotsemanticsegmentation_tpu_torch.cli import train as cli
    from zeroshotsemanticsegmentation_tpu_torch.configs import get_config
    from zeroshotsemanticsegmentation_tpu_torch.data import BatchLoader
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
    from zeroshotsemanticsegmentation_tpu_torch.train import checkpoint as ck
    from zeroshotsemanticsegmentation_tpu_torch.train import trainer_fcn

    real_run = cli.run_experiment

    def run_no_viz(cfg, **kw):
        return real_run(cfg.replace(num_viz=0), **kw)

    out = {}
    cfg = get_config(14, fcn_epochs=1, seenmask_epochs=1, arch=arch)
    train_ds, seen_ds, val_ds = cli._build_datasets(
        cfg, data_dir=tmp, synthetic=True)
    n_s1 = len(BatchLoader(seen_ds, cfg.batch_size))
    n_s2 = len(BatchLoader(train_ds, cfg.batch_size))
    n_val = len(BatchLoader(val_ds, cfg.eval_batch_size))
    k1_val = n_val if arch == "fcn32s" else 0
    flags = ["--remat"] if remat else []
    tag = arch + ("_remat" if remat else "")
    want = {"block1_train_fwd": n_s1 * (2 if remat else 1),
            "block1_train_bwd": n_s1,
            "costail_fwd": n_s1, "costail_bwd": n_s1,
            "block1_fused": n_s2 + 2 * n_val, "szn_fused": k1_val}
    argv = ["-c", "14", "--synthetic", "-ve", "1", "-se", "1", "--arch",
            arch, *flags, "-n", tag, "-dir", tmp]
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
    require(ck._pending is None and not [
        f for f in os.listdir(log_dir) if f.endswith(".tmp")],
        "the train CLI returned with a checkpoint save in flight")
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
    out["cli"] = {"arch": arch, "seconds": run_s, "launches": got,
                  "steps": [n_s1, n_s2], "val_batches": n_val,
                  "losses": losses,
                  "best_mean_iu": summary["best_mean_iu"],
                  "seenmask_best_mean_iu": summary["seenmask_best_mean_iu"]}

    # the resume: parameters and moments as saved, one more epoch
    path = osp.join(log_dir, "checkpoint")
    saved = ck.restore_checkpoint(path)
    want_arch = {"fcn32s": "FCN32s", "fcn8s": "FCN8s"}[arch]
    require(saved["arch"] == want_arch,
            f"the {arch} checkpoint says arch {saved['arch']!r}")
    os.remove(osp.join(log_dir, "best"))  # disk: one 1.6 GB file less
    real_train = trainer_fcn.FCNTrainer.train
    restored = {}

    def checked_train(self):
        sd = self.state.model.state_dict()
        restored["params"] = all(
            torch.equal(sd[k].cpu(), v) for k, v in saved["params"].items())
        live = self.state.optimizer.state_dict()
        restored["moments"] = bool(saved["opt_state"]["state"]) and \
            _nested_equal(live["state"], saved["opt_state"]["state"])
        restored["groups"] = (live["param_groups"]
                              == saved["opt_state"]["param_groups"])
        restored["start"] = (self.epoch, self.iteration)
        return real_train(self)

    argv = ["-c", "14", "--synthetic", "-r", path, "-ve", "2", "-se", "0",
            "--arch", arch, *flags, "-n", tag + "_resume", "-dir", tmp]
    _kernels.reset_launch_counts()
    with mock.patch.object(cli, "run_experiment", run_no_viz), \
            mock.patch.object(trainer_fcn.FCNTrainer, "train",
                              checked_train):
        resumed = cli.main(argv)
    torch.cuda.synchronize()
    got = dict(_kernels.launch_counts)
    r1 = csv_rows(osp.join(resumed["log_dir"], "train_log.csv"))
    log(f"[train cli] {arch} resume from {saved['epoch']}/"
        f"{saved['iteration']}: {restored}, {len(r1)} steps, launches {got}")
    require(restored.get("params") and restored.get("moments")
            and restored.get("groups"),
            f"resume did not restore the checkpoint bit-equal: {restored}")
    # the run's last save is stage 2's: it keeps stage 1's counters
    require(restored["start"] == (saved["epoch"] + 1, n_s1)
            and saved["iteration"] == n_s1,
            f"resume starts at {restored['start']}, stage 1 ran {n_s1} "
            "steps")
    require(len(r1) == n_s1 and {r[0] for r in r1} == {"1"},
            f"resume trained {len(r1)} steps: {r1}")
    require(got["costail_fwd"] == n_s1 and got["szn_fused"] == k1_val
            and got["block1_train_fwd"] == want["block1_train_fwd"]
            and got["pdot"] == 0, f"resume launches {got}")
    out["resume"] = {"restored": restored, "steps": len(r1),
                     "launches": got}
    out["checkpoint"] = path
    del saved
    shutil.rmtree(resumed["log_dir"])
    return out


def csv_rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return [line.split(",") for line in lines[1:]]


def phase_train_cli(dev, embed, bare_img_s, tmp, log, require) -> dict:
    """Phase 20: the train CLI on the card.

    1. and 2. `cli_run_and_resume(tmp, "fcn32s")`: the `-c 14 --synthetic
       -ve 1 -se 1` run, its files, losses and launch counts, and the
       resume (its first run's log directory stays in `tmp` for phase 21).
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
    import torch
    from zeroshotsemanticsegmentation_tpu_torch.configs import get_config
    from zeroshotsemanticsegmentation_tpu_torch.data import (
        BatchLoader, SyntheticDataset)
    from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
    from zeroshotsemanticsegmentation_tpu_torch.train import (
        FCNTrainer, make_fcn_optimizer)
    from zeroshotsemanticsegmentation_tpu_torch.train import checkpoint as ck
    from zeroshotsemanticsegmentation_tpu_torch.utils import RunLogger

    out = cli_run_and_resume(tmp, "fcn32s", log, require)
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
    lp = time_loop(dev, trainer, loader, osp.join(tmp, "loop"), require)
    t0 = time.perf_counter()
    ck.save_checkpoint(osp.join(tmp, "save"),
                       model_state=model.state_dict(),
                       optim_state=trainer.state.optimizer.state_dict(),
                       epoch=1, iteration=trainer.iteration,
                       best_mean_iu=0.0, is_best=True)
    save_s = time.perf_counter() - t0
    save_gb = os.path.getsize(osp.join(tmp, "save", "checkpoint")) / 1e9
    out["loop"] = {
        "batch": TRAIN_BATCH, "hw": [H, W], "dtype": "bfloat16",
        "steps": lp["steps"], "images": LOOP_IMAGES,
        "warmup_steps": lp["warmup_steps"],
        "log_flush_steps": lp["log_flush_steps"],
        "flushes_after_steps": lp["flushes_after_steps"],
        **{k: lp[k] for k in (
            "seconds", "images_per_s", "first_step_wait_s",
            "steady_seconds", "steady_images_per_s",
            "steady_host_ms_per_step", "bare_step_images_per_s",
            "bare_step_ms")},
        "phase10_bare_step_images_per_s": bare_img_s,
        **{k: lp[k] for k in (
            "loop_over_bare", "steady_over_bare", "overhead_ms_per_step",
            "steady_overhead_ms_per_step")},
        "first_batch_s": first_batch_s,
        "feed_alone_images_per_s": feed_img_s,
        "allocated_before_gb": base_gb,
        "max_memory_allocated_gb": lp["max_memory_allocated_gb"],
        "bare_step_max_memory_allocated_gb":
            lp["bare_step_max_memory_allocated_gb"],
        "checkpoint_save_s": save_s, "checkpoint_gb": save_gb,
        "syncs_between_flushes": 0}
    log(json.dumps({"train_loop": out["loop"]}))
    del trainer, model
    out["launches"] = out["cli"]["launches"]
    return out


def time_loop(dev, trainer, loader, log_dir: str, require) -> dict:
    """One loop timing of `trainer` (phases 20 and 24): a warm-up epoch on
    its train loader, then one epoch on `loader` with host syncs turned
    into errors between the log flushes; its img/s over the epoch and in
    the steady window (CUDA events after each step, from the end of the
    first to the end of the last; the host's time between step calls
    beside it), and the bare step on the same trainer (one batch of
    `loader` resident on the card, no feed, no logging); the launch counts
    of the timed epoch and both peaks of memory."""
    import torch
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
    from zeroshotsemanticsegmentation_tpu_torch.train import trainer_fcn
    warm_loader = trainer.train_loader
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
    fs = trainer.cfg.log_flush_steps
    require(flushes == [*range(fs, n_steps, fs), n_steps]
            and len(flushes) >= 3,
            f"loop flushed after steps {flushes}")
    first_wait_s = marks[0][0] - t0
    steady_s = marks[0][1].elapsed_time(marks[-1][1]) / 1e3
    steady_img_s = (n_steps - 1) * TRAIN_BATCH / steady_s
    rows = csv_rows(osp.join(log_dir, "train_log.csv"))
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
    loop_img_s = n_steps * TRAIN_BATCH / loop_s
    bare_here = TRAIN_BATCH / (bare_ms / 1e3)
    return {
        "steps": n_steps, "warmup_steps": n_warm,
        "log_flush_steps": fs, "flushes_after_steps": flushes,
        "seconds": loop_s, "images_per_s": loop_img_s,
        "first_step_wait_s": first_wait_s,
        "steady_seconds": steady_s,
        "steady_images_per_s": steady_img_s,
        "steady_host_ms_per_step":
            1e3 * (marks[-1][0] - marks[0][0]) / (n_steps - 1),
        "bare_step_images_per_s": bare_here,
        "bare_step_ms": bare_ms,
        "loop_over_bare": loop_img_s / bare_here,
        "steady_over_bare": steady_img_s / bare_here,
        "overhead_ms_per_step": 1e3 * loop_s / n_steps - bare_ms,
        "steady_overhead_ms_per_step":
            1e3 * steady_s / (n_steps - 1) - bare_ms,
        "max_memory_allocated_gb": peak_gb,
        "bare_step_max_memory_allocated_gb": bare_peak_gb,
        "launches": got}


def profile_window(fn, iters: int, top: int = 12) -> dict:
    """One torch.profiler window (CPU and CUDA activity) of `iters` calls of
    `fn` after a warm-up call: the window's wall ms a call, the device
    kernels' ms a call, the device's idle share (1 - kernels / wall) and the
    `top` device operations by self device time. A window with no device
    time recorded is profiled again, up to three windows."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
        # device kernels only: a user annotation such as the optimizer's
        # "Optimizer.step#Adam.step" has a device range over the kernels
        # (scripts/torch_train_profile.py leaves them out the same way)
        events = [e for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")
                  and not getattr(e, "is_user_annotation", False)
                  and not e.key.startswith("Optimizer.")]
        kern_ms = sum(e.self_device_time_total for e in events) / 1e3 / iters
        if kern_ms > 0:
            break
        log("[profiler] no device time recorded in the window; profiling "
            "again")
    else:
        fail("torch.profiler recorded no device time in three windows")
    rows = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    return {"wall_ms": wall_ms, "device_kernel_ms": kern_ms,
            "idle_share": 1 - kern_ms / wall_ms,
            "top": [{"name": e.key[:90],
                     "ms": e.self_device_time_total / 1e3 / iters,
                     "calls": e.count / iters} for e in rows]}


def phase_fcn8s_int8(dev, embed, serve_bf16_ms, ckpt32, tmp, train_batch,
                     plain_training, flip_rate, log, require) -> dict:
    """Phase 21: FCN-8s through serving, both training stages and the train
    CLI, the predict and export CLIs, and int8 serving, at full width,
    512x512, with the bundled 20-dim pascal embeddings (21 classes, unseen
    [1, 13]) and seeded random weights; FCN-8s's skip heads seeded non-zero
    except where a fresh model is the point ((b): they must move from
    zero).

    (a) FCN-8s serving (bf16, B=64, the unfused full-resolution route): K2
        once a call and K1 never; labels vs the same predictor with K2
        through its plain version; the serving bf16 bar on 8 images (bf16
        labels through K2 at most 2x as far from fp32's as with block 1
        through its plain version); at B=2 in fp32 K2 vs its plain version,
        flip rate < 1e-4; ms/batch, MP/s, peak memory and a profile window.
    (b) FCN-8s stage 1: three B=24 steps (cos loss, fused tail, Adam lr
        1e-5, dropout 0.5 from a seeded CUDA generator), K3-K6 once a step
        and K2 never, finite losses, the zero-initialised skip heads moved,
        the last step with host syncs as errors; one fp32 B=2 step through
        the kernels vs their plain versions (each gradient's relative norm
        < 1e-4); ms/step, img/s, peak memory and a profile window.
    (c) FCN-8s stage 2: one B=24 step (dot-free mode off): K2 once, K3/K4
        never, `seenmask_score` moved and every other parameter
        bit-identical.
    (d) the train CLI with `--arch fcn8s` (`cli_run_and_resume`): K1 never
        (the unfused eval), the checkpoint's arch "FCN8s", the resume.
    (e) the predict CLI on arrays: `build_predictor` from phase 20's FCN-32s
        checkpoint (`ckpt32`) and from (d)'s FCN-8s one, `predict_arrays`
        over 6 images below the bucket at batch 4 (a tail batch of 2) equal
        to each predictor called on the same padded batches and cropped;
        `--int8` on the FCN-32s checkpoint (K1, no K2), its flip rate vs
        the bf16 labels.
    (f) the export CLI on phase 20's checkpoint: the round trip verified,
        the file reloaded into the port bit-equal; (d)'s FCN-8s checkpoint
        refused.
    (g) int8 serving of FCN-32s at B=64: K1 once a call and K2 never, label
        flips vs the bf16 predictor on the same weights < 0.08 (the JAX
        bar), ms/batch and MP/s beside the bf16 predictor's in turns (bf16,
        int8, int8, bf16) and phase 6's, peak memory and a profile window.
    Each peak memory stands beside the memory already allocated before it
    (the weights of this phase and earlier phases' tensors).
    """
    import contextlib
    import io
    import math

    import torch
    from zeroshotsemanticsegmentation_tpu_torch.cli import export as cexp
    from zeroshotsemanticsegmentation_tpu_torch.cli import predict as cpred
    from zeroshotsemanticsegmentation_tpu_torch.configs import get_config
    from zeroshotsemanticsegmentation_tpu_torch.data.transforms import (
        transform_image)
    from zeroshotsemanticsegmentation_tpu_torch.models import FCN8s, FCN32s
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
    from zeroshotsemanticsegmentation_tpu_torch.ops import (
        block1_fused as b1)
    from zeroshotsemanticsegmentation_tpu_torch.ops.metrics import (
        unseen_mask_vector)
    from zeroshotsemanticsegmentation_tpu_torch.serving import (
        make_szn_predictor)
    from zeroshotsemanticsegmentation_tpu_torch.train import (
        TrainState, make_fcn_optimizer, make_fcn_train_step,
        make_seenmask_optimizer, make_seenmask_train_step)
    from zeroshotsemanticsegmentation_tpu_torch.train import checkpoint as ck

    t_phase = time.perf_counter()
    bf, f32 = torch.bfloat16, torch.float32
    k_cls = embed.shape[0]
    rng = np.random.RandomState(21)
    out = {}

    def counts():
        torch.cuda.synchronize()
        return dict(_kernels.launch_counts)

    def fcn8s(dtype, seed=0, skips=True, dropout=0.5):
        m = FCN8s(20, dtype=dtype, fused_block1=True, dropout_rate=dropout,
                  generator=torch.Generator().manual_seed(seed), device=dev)
        if skips:  # seeded LeCun-normal skip heads, small biases
            g = torch.Generator().manual_seed(seed + 100)
            with torch.no_grad():
                for name in ("score_pool3", "score_pool4"):
                    conv = getattr(m, name)
                    conv.weight.copy_(torch.randn(
                        conv.weight.shape, generator=g)
                        / math.sqrt(conv.weight[0].numel()))
                    conv.bias.copy_(0.1 * torch.randn(conv.bias.shape,
                                                      generator=g))
        return m

    plain_k2 = mock.patch.object(b1, "block1_op", b1.block1_plain)

    raw8 = rng.randint(0, 256, (8, H, W, 3)).astype(np.uint8)
    x8 = torch.from_numpy(np.stack([transform_image(r) for r in raw8])).to(
        dev)
    x64 = x8.repeat(SERVE_BATCH // 8, 1, 1, 1)
    x64 = x64 + torch.randn_like(x64)

    # ---- (a) FCN-8s serving ---------------------------------------------
    serve8 = make_szn_predictor(fcn8s(bf), None, embed, UNSEEN)
    serve8(x8[:2])
    _kernels.reset_launch_counts()
    lab64 = serve8(x64)
    serve_launches = counts()
    log(f"[fcn8s serve] B={SERVE_BATCH} launches {serve_launches}")
    require(serve_launches["block1_fused"] == 1
            and serve_launches["szn_fused"] == 0,
            f"FCN-8s serving: K2 once and K1 never a call, got "
            f"{serve_launches}")
    require(tuple(lab64.shape) == (SERVE_BATCH, H, W)
            and lab64.dtype == torch.int32 and lab64.min().item() >= 0
            and lab64.max().item() < k_cls, "FCN-8s labels")
    with plain_k2:
        lab64_plain = serve8(x64)
    flip_k2 = flip_rate(lab64, lab64_plain)
    # the serving bf16 bar on 8 images: fp32 (TF32 off) labels as the
    # reference, bf16 through K2 and bf16 with block 1's plain version
    ref8 = make_szn_predictor(fcn8s(f32), None, embed, UNSEEN)(x8)
    kern8 = serve8(x8)
    with plain_k2:
        plain8 = serve8(x8)
    bar = {"flip_kernels": flip_rate(kern8, ref8),
           "flip_plain": flip_rate(plain8, ref8)}
    pred32 = make_szn_predictor(fcn8s(f32), None, embed, UNSEEN)
    got2 = pred32(x8[:2])
    with plain_k2:
        want2 = pred32(x8[:2])
    flip32 = flip_rate(got2, want2)
    log(f"[fcn8s serve] bf16 B=64 flip rate K2 vs plain {flip_k2:.3e}; "
        f"bf16 bar vs fp32: kernels {bar['flip_kernels']:.4e}, plain "
        f"{bar['flip_plain']:.4e}; fp32 B=2 kernels vs plain {flip32:.3e}")
    require(bar["flip_kernels"] <= 2 * bar["flip_plain"],
            f"FCN-8s bf16 serving flips {bar} break the serving bf16 bar")
    require(flip32 < 1e-4, f"FCN-8s fp32 flip rate {flip32} >= 1e-4")
    del ref8, kern8, plain8, pred32, lab64_plain
    torch.cuda.synchronize()
    base8 = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    ms8 = time_ms(lambda: serve8(x64), iters=3)
    peak8 = torch.cuda.max_memory_allocated() / 1e9
    prof_serve = profile_window(lambda: serve8(x64), iters=2)
    out["serve"] = {"batch": SERVE_BATCH, "hw": [H, W], "dtype": "bfloat16",
                    "ms_per_batch": ms8,
                    "megapixels_per_s": SERVE_BATCH * H * W / (ms8 * 1e3),
                    "max_memory_allocated_gb": peak8,
                    "allocated_before_gb": base8,
                    "flip_k2_vs_plain": flip_k2, "bar": bar,
                    "flip_fp32_b2": flip32, "launches": serve_launches,
                    "profile": prof_serve}
    log(json.dumps({"fcn8s_serving": out["serve"]}))
    del serve8

    # ---- (b) FCN-8s stage 1 ----------------------------------------------
    step = make_fcn_train_step(loss_name="cos", num_classes=k_cls,
                               embeddings=embed)
    tm = fcn8s(bf, skips=False)
    tst = TrainState.create(tm, make_fcn_optimizer(tm, optim="adam",
                                                   lr=1e-5))
    tgen = torch.Generator(device=dev).manual_seed(0)
    tbatch = train_batch(TRAIN_BATCH, 0)
    _kernels.reset_launch_counts()
    losses = []
    for i in range(TRAIN_STEPS):
        if i == TRAIN_STEPS - 1:
            torch.cuda.set_sync_debug_mode("error")
        try:
            tst, aux = step(tst, tbatch, tgen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        losses.append(aux["loss"])
    train_launches = counts()
    losses = [x.item() for x in losses]
    moved = {n: getattr(tm, n).weight.abs().max().item()
             for n in ("score_pool3", "score_pool4")}
    log(f"[fcn8s train] {TRAIN_STEPS} B={TRAIN_BATCH} steps: launches "
        f"{train_launches}, losses {losses}, skip heads' max |w| {moved}")
    for key in ("block1_train_fwd", "block1_train_bwd", "costail_fwd",
                "costail_bwd"):
        require(train_launches[key] == TRAIN_STEPS,
                f"FCN-8s stage 1: {key} launched {train_launches[key]} "
                f"times in {TRAIN_STEPS} steps")
    require(train_launches["block1_fused"] == 0,
            f"K2 ran under FCN-8s training: {train_launches}")
    require(all(np.isfinite(x) for x in losses), f"losses {losses}")
    require(all(v > 0 for v in moved.values()),
            f"the skip heads did not move from zero: {moved}")

    def b2_grads(routing):
        m = fcn8s(f32, seed=1)
        st = TrainState.create(m, make_fcn_optimizer(m, optim="adam",
                                                     lr=1e-5))
        gen = torch.Generator(device=dev).manual_seed(1)
        with routing:
            _, aux = step(st, train_batch(2, 1), gen)
        grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()
                 if p.grad is not None}
        return aux["loss"].item(), grads

    loss_k, grads_k = b2_grads(contextlib.nullcontext())
    loss_p, grads_p = b2_grads(plain_training())
    require(set(grads_k) == set(grads_p), "FCN-8s gradient sets differ")
    grad_rels = {n: rel(grads_k[n], grads_p[n]) for n in grads_p}
    worst = max(grad_rels, key=grad_rels.get)
    log(f"[fcn8s train] fp32 B=2 kernels vs plain: loss {loss_k:.7f} vs "
        f"{loss_p:.7f}, worst gradient rel-norm {grad_rels[worst]:.3e} "
        f"({worst}); score_pool3.weight "
        f"{grad_rels['score_pool3.weight']:.1e}, score_pool4.weight "
        f"{grad_rels['score_pool4.weight']:.1e}")
    require(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), "FCN-8s fp32 loss")
    require(grad_rels[worst] < 1e-4,
            f"FCN-8s fp32 gradient {worst} rel {grad_rels[worst]}")
    del grads_k, grads_p
    torch.cuda.synchronize()
    tbase = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(tst, tbatch, tgen), iters=TIMED_STEPS,
                      warmup=1)
    tpeak = torch.cuda.max_memory_allocated() / 1e9
    prof_train = profile_window(lambda: step(tst, tbatch, tgen), iters=2)
    out["train"] = {"batch": TRAIN_BATCH, "hw": [H, W], "dtype": "bfloat16",
                    "ms_per_step": step_ms,
                    "images_per_s": TRAIN_BATCH / (step_ms / 1e3),
                    "max_memory_allocated_gb": tpeak,
                    "allocated_before_gb": tbase, "losses": losses,
                    "launches": train_launches,
                    "fp32_b2_worst_grad_rel": [worst, grad_rels[worst]],
                    "profile": prof_train}
    log(json.dumps({"fcn8s_train": out["train"]}))
    del tst, tm, tbatch

    # ---- (c) FCN-8s stage 2 ----------------------------------------------
    sm = fcn8s(bf)
    before = {n: p.detach().clone() for n, p in sm.named_parameters()}
    sst = TrainState.create(sm, make_seenmask_optimizer(sm, lr=1e-3))
    sstep = make_seenmask_train_step(
        seen_vec=~unseen_mask_vector(k_cls, UNSEEN))
    sbatch = train_batch(TRAIN_BATCH, 3)
    _kernels.reset_launch_counts()
    sst, saux = sstep(sst, sbatch, torch.Generator(device=dev).manual_seed(0))
    s2_launches = counts()
    log(f"[fcn8s stage2] launches {s2_launches}, loss "
        f"{saux['loss'].item():.6f}")
    require(s2_launches["block1_fused"] == 1
            and s2_launches["block1_train_fwd"] == 0
            and s2_launches["block1_train_bwd"] == 0
            and s2_launches["pdot"] == 0,
            f"FCN-8s stage 2 (dot-free mode off): K2 once, K3/K4 and K7 "
            f"never, got {s2_launches}")
    require(np.isfinite(saux["loss"].item()), "FCN-8s stage-2 loss")
    for n, p in sm.named_parameters():
        changed = not torch.equal(p.detach(), before[n])
        require(changed == n.startswith("seenmask_score"),
                f"FCN-8s stage 2: {n} {'moved' if changed else 'stayed'}")
    out["stage2"] = {"launches": s2_launches, "loss": saux["loss"].item()}
    del sm, sst, before, sbatch

    # ---- (d) the train CLI with --arch fcn8s -------------------------------
    cli8 = cli_run_and_resume(tmp, "fcn8s", log, require)
    ckpt8 = cli8["checkpoint"]
    out["cli"] = {k: cli8[k] for k in ("cli", "resume")}

    # ---- (e) the predict CLI on arrays -------------------------------------
    sizes = [(h * H // 512, w * W // 512) for h, w in (
        (375, 500), (512, 512), (333, 512), (512, 287), (200, 200),
        (480, 360))]
    imgs = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in sizes]
    preds, pred_launches, labels = {}, {}, {}
    for name, cfg, path, int8 in (
            ("fcn32s", get_config(14), ckpt32, False),
            ("fcn8s", get_config(14, arch="fcn8s"), ckpt8, False),
            ("fcn32s_int8", get_config(14), ckpt32, True)):
        predict, names, trained = cpred.build_predictor(cfg, path,
                                                        int8=int8)
        _kernels.reset_launch_counts()
        labs = cpred.predict_arrays(predict, imgs, bucket=cfg.bucket,
                                    batch_size=4)
        pred_launches[name] = counts()
        for i in range(0, len(imgs), 4):  # the same padded batches, direct
            batch = np.zeros((4, H, W, 3), np.uint8)
            for j, img in enumerate(imgs[i:i + 4]):
                batch[j, :img.shape[0], :img.shape[1]] = img
            direct = predict(torch.from_numpy(batch)).cpu().numpy()
            for j, img in enumerate(imgs[i:i + 4]):
                h, w = img.shape[:2]
                require(labs[i + j].shape == (h, w) and np.array_equal(
                    labs[i + j], direct[j, :h, :w]),
                    f"predict_arrays {name}: image {i + j} differs from the "
                    "predictor's own labels")
        labels[name] = labs
        preds[name] = {"upscore_trained": trained, "classes": len(names),
                       "launches": pred_launches[name]}
        del predict
    int8_flips = float(np.mean(np.concatenate([
        (a != b).ravel() for a, b in zip(labels["fcn32s_int8"],
                                         labels["fcn32s"])])))
    log(f"[predict cli] {preds}; int8 vs bf16 label flips {int8_flips:.4f}")
    require(pred_launches["fcn32s"]["szn_fused"] > 0
            and pred_launches["fcn8s"]["szn_fused"] == 0
            and pred_launches["fcn8s"]["block1_fused"] == 2
            and pred_launches["fcn32s_int8"]["block1_fused"] == 0
            and pred_launches["fcn32s_int8"]["szn_fused"] > 0,
            f"predict CLI launches {pred_launches}")
    require(int8_flips < 0.08, f"predict CLI int8 flips {int8_flips}")
    out["predict"] = {"predictors": preds, "images": [list(s) for s in sizes],
                      "batch_size": 4, "int8_vs_bf16_flips": int8_flips}

    # ---- (f) the export CLI ----------------------------------------------
    exported = osp.join(tmp, "exported")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cexp.main([ckpt32, "-o", exported])
    log(f"[export cli] {buf.getvalue().strip()}")
    require("round-trip verified" in buf.getvalue(), "export CLI summary")
    back = ck.restore_checkpoint(exported)["params"]
    src = ck.restore_checkpoint(ckpt32)["params"]
    reloaded = FCN32s(20, device=dev)
    reloaded.load_state_dict(back, strict=True)
    require(sorted(back) == sorted(src) and all(
        torch.equal(reloaded.state_dict()[k].cpu(), v)
        for k, v in src.items()), "the export does not reload bit-equal")
    try:
        cexp.main([ckpt8, "-o", osp.join(tmp, "exported8")])
        refused = None
    except ValueError as e:
        refused = str(e)
    require(refused is not None and "FCN8s trees are not exportable"
            in refused, f"the export CLI took an FCN-8s checkpoint: "
            f"{refused}")
    out["export"] = {"summary": buf.getvalue().strip(),
                     "fcn8s_refusal": refused}
    del back, src, reloaded

    # ---- (g) int8 serving ------------------------------------------------
    m32 = FCN32s(20, dtype=bf, fused_block1=True,
                 generator=torch.Generator().manual_seed(0), device=dev)
    serve_bf = make_szn_predictor(m32, None, embed, UNSEEN)
    serve_i8 = make_szn_predictor(m32, None, embed, UNSEEN, int8=True)
    serve_i8(x8[:2])
    torch.cuda.synchronize()
    i8_base = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    li = serve_i8(x64)
    i8_launches = counts()
    i8_peak = torch.cuda.max_memory_allocated() / 1e9
    lb = serve_bf(x64)
    i8_flips = flip_rate(li, lb)
    log(f"[int8 serve] B={SERVE_BATCH} launches {i8_launches}, flips vs "
        f"bf16 {i8_flips:.4f}, peak {i8_peak:.2f} GB")
    require(i8_launches["szn_fused"] == 1
            and i8_launches["block1_fused"] == 0,
            f"int8 serving: K1 once and K2 never a call, got {i8_launches}")
    require(i8_flips < 0.08, f"int8 flips vs bf16 {i8_flips} >= 0.08")
    turns = {"bfloat16": [], "int8": []}
    for name, fn in (("bfloat16", serve_bf), ("int8", serve_i8),
                     ("int8", serve_i8), ("bfloat16", serve_bf)):
        turns[name].append(time_ms(lambda fn=fn: fn(x64), iters=2))
    prof_i8 = profile_window(lambda: serve_i8(x64), iters=1)
    out["int8"] = {
        "batch": SERVE_BATCH, "hw": [H, W], "launches": i8_launches,
        "flips_vs_bf16": i8_flips, "ms_per_batch": turns,
        "megapixels_per_s": {k: [SERVE_BATCH * H * W / (t * 1e3) for t in v]
                             for k, v in turns.items()},
        "phase6_bf16_ms_per_batch": serve_bf16_ms,
        "max_memory_allocated_gb": i8_peak, "allocated_before_gb": i8_base,
        "profile": prof_i8,
        "order": "bf16, int8, int8, bf16"}
    log(json.dumps({"int8_serving": out["int8"]}))
    del serve_bf, serve_i8, m32, li, lb, x64, x8
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[phase 21] {out['seconds']:.1f} s")
    out["launches"] = {"fcn8s_serve": serve_launches,
                       "fcn8s_train": train_launches,
                       "fcn8s_cli": cli8["cli"]["launches"],
                       "int8_serve": i8_launches}
    return out


MESH_STEPS = 2          # (b)'s fp32 steps on each two-rank mesh
MESH_BATCH = 4          # their batch
MESH_BF16_BATCH = 24    # (b)'s bf16 DP=2 step
MESH_DOT_FREE_BATCH = 8  # (b)'s bf16 TP=2 dot-free step
MESH_SERVE_BATCH = 64
MESH_SMALL_SERVE_BATCH = 16  # TP=2 serving, the trained gate, FCN-8s
MESH_EVAL_BATCH = 4


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_kit(dev, hw: int, scale: float):
    """What phase 22's runs share: the 20-dim pascal embeddings (21
    classes), a seeded batch maker and a model maker from a state dict
    (`fresh`, built on the meta device, so no init draws are repeated)."""
    import torch
    from zeroshotsemanticsegmentation_tpu_torch.data.assets import (
        load_class_embeddings)
    from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s

    embed = load_class_embeddings("pascal", 20)
    k_cls = embed.shape[0]

    def batch(b, seed):
        r = np.random.RandomState(seed)
        return {"image": torch.from_numpy(
                    r.randn(b, hw, hw, 3).astype(np.float32) * 40).to(dev),
                "label": torch.from_numpy(r.randint(
                    -1, k_cls, (b, hw, hw)).astype(np.int32)).to(dev),
                "sizes": torch.full((b, 2), hw, dtype=torch.int32,
                                    device=dev),
                "num_real": torch.tensor(b, device=dev)}

    def init_state(seed=0, cls=FCN32s):
        m = cls(20, channel_scale=scale,
                generator=torch.Generator().manual_seed(seed), device=dev)
        return {k: v.detach().clone() for k, v in m.state_dict().items()}

    def fresh(sd, dtype, dropout=0.5, cls=FCN32s):
        with torch.device("meta"):
            m = cls(20, dtype=dtype, channel_scale=scale, fused_block1=True,
                    dropout_rate=dropout, device="meta")
        m = m.to_empty(device=dev)
        m.load_state_dict(sd)
        return m

    return embed, k_cls, batch, init_state, fresh


def _train(model, mesh, embed, k_cls, batch, steps, lr=1e-5, seed=100):
    """`steps` stage-1 steps (cos loss, fused tail, Adam): the auxes, the
    state, and each step's gradients as the optimizer took them (global;
    this rank's shards)."""
    import torch
    from zeroshotsemanticsegmentation_tpu_torch.train import (
        TrainState, make_fcn_optimizer, make_fcn_train_step)
    step = make_fcn_train_step(loss_name="cos", num_classes=k_cls,
                               embeddings=embed, mesh=mesh)
    st = TrainState.create(model, make_fcn_optimizer(model, optim="adam",
                                                     lr=lr))
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    auxes, grads = [], []
    for _ in range(steps):
        st, aux = step(st, batch, gen)
        auxes.append(aux)
        grads.append({n: p.grad.detach().clone()
                      for n, p in model.named_parameters()
                      if p.grad is not None})
    return auxes, st, grads


def _replay_adam(model, grads, lr=1e-5) -> dict:
    """The parameters after one-device Adam (`make_fcn_optimizer`, as
    `_train`) takes the given steps' full gradients from `model`'s: what
    a mesh's optimizer steps on its shards must give."""
    from zeroshotsemanticsegmentation_tpu_torch.train import (
        make_fcn_optimizer)
    opt = make_fcn_optimizer(model, optim="adam", lr=lr)
    for g in grads:
        for n, p in model.named_parameters():
            p.grad = g.get(n)
        opt.step()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _hist_held(got, want) -> dict:
    """Histograms equal, or within the fused tail's near-tie allowance
    (row sums equal, at most max(16, 0.5%) of the mass moved)."""
    got, want = got.cpu().long(), want.cpu().long()
    moved = int((got - want).abs().sum())
    rows = bool((got.sum(1) == want.sum(1)).all())
    return {"equal": bool((got == want).all()), "moved": moved,
            "rows_equal": rows,
            "ok": rows and moved <= max(16, 0.005 * int(want.sum()))}


def _mesh_rank(rank: int, world: int, init_method: str, hw: int,
               scale: float, sizes: dict) -> dict:
    """Phase 22 (b)'s rank function: two ranks sharing the card over gloo
    (the run's device is `cuda:0` for both, or the CPU for a small check
    of this code). Rank 0 runs the one-device references too and holds
    the mesh runs against them; every rank reports its launch counts."""
    import torch
    import torch.distributed as dist
    from zeroshotsemanticsegmentation_tpu_torch.models.fcn8s import FCN8s
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
    from zeroshotsemanticsegmentation_tpu_torch.ops import dotpolicy
    from zeroshotsemanticsegmentation_tpu_torch.ops import pdot as pd
    from zeroshotsemanticsegmentation_tpu_torch.ops.metrics import (
        unseen_mask_vector)
    from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
        gather_params, gather_rows, init_distributed, make_mesh,
        make_multislice_mesh, shard_model)
    from zeroshotsemanticsegmentation_tpu_torch.serving import (
        make_szn_predictor)
    from zeroshotsemanticsegmentation_tpu_torch.train import (
        make_szn_eval_step)

    cuda = torch.cuda.is_available() and sizes.get("device") != "cpu"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed("gloo", init_method, rank, world, timeout=300)
    devices = [dev] * world
    embed, k_cls, batch, init_state, fresh = _mesh_kit(dev, hw, scale)
    f32, bf16 = torch.float32, torch.bfloat16
    main = rank == 0
    out = {"rank": rank, "launches": {}, "checks": {}, "seconds": {}}

    def counted(name, fn):
        """fn() with this rank's launch counts from 0, recorded; the time
        it took on this rank."""
        if cuda:
            torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        r = fn()
        if cuda:
            torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        out["launches"][name] = {k: v for k, v in
                                 _kernels.launch_counts.items() if v}
        return r

    def free():
        if cuda:
            torch.cuda.empty_cache()

    sd = init_state(0)
    meshes = {"dp2": lambda: make_mesh(2, 1, devices=devices),
              "tp2": lambda: make_mesh(1, 2, devices=devices),
              "slice2": lambda: make_multislice_mesh(2, 1, 1,
                                                     devices=devices)}
    b_fp32 = batch(sizes["mesh_batch"], 1)

    # fp32 steps with dropout: every mesh vs the one-device run
    ref = None
    if main:
        m = fresh(sd, f32)
        auxes, st, grads = _train(m, None, embed, k_cls, b_fp32,
                                  sizes["mesh_steps"])
        ref = {"loss": auxes[-1]["loss"].item(),
               "hist": auxes[-1]["hist"].clone(), "grads": grads[0],
               "params": {k: v.detach().clone()
                          for k, v in m.state_dict().items()}}
        del m, st
        free()
    dist.barrier()
    for name, make in meshes.items():
        mesh = make()
        m = shard_model(fresh(sd, f32), mesh)
        auxes, st, grads = counted(name, lambda: _train(
            m, mesh, embed, k_cls, b_fp32, sizes["mesh_steps"]))
        params = gather_params(m.state_dict(), mesh)
        grads = [gather_params(g, mesh) for g in grads]
        del m, st
        free()
        if main:
            loss = auxes[-1]["loss"].item()
            prel = max((params[k] - ref["params"][k]).abs().sub(
                2e-3 * ref["params"][k].abs()).max().item()
                for k in params)
            grel = {k: rel(grads[0][k], g) for k, g in ref["grads"].items()}
            # the mesh's optimizer steps vs one-device Adam on the mesh's
            # own gradients: each parameter's change at relative norm
            replay = _replay_adam(fresh(sd, f32), grads)
            urel = {k: rel(params[k] - sd[k], replay[k] - sd[k])
                    for k in replay}
            out["checks"][name] = {
                "loss": loss, "loss_ref": ref["loss"],
                "loss_rel": abs(loss - ref["loss"]) / abs(ref["loss"]),
                "params_excess_over_rtol": prel,
                "params_ok": prel <= 1e-4,
                "replay_rel_max": max(urel.values()),
                "replay_keys_equal": set(params) == set(replay),
                "grad_rel_max": max(grel.values()),
                "grad_keys_equal": set(grads[0]) == set(ref["grads"]),
                "hist": _hist_held(auxes[-1]["hist"], ref["hist"])}
            del replay
        del params, grads
        free()
    del ref
    free()

    # bf16 DP=2 steps at B=24, then the dot-free mode on TP=2: K7's shapes
    mesh = meshes["dp2"]()
    m = shard_model(fresh(sd, bf16), mesh)
    b24 = batch(sizes["bf16_batch"], 2)
    auxes, st, _ = counted("bf16_dp2", lambda: _train(
        m, mesh, embed, k_cls, b24, 2))
    out["checks"]["bf16_dp2"] = {"losses": [a["loss"].item()
                                            for a in auxes]}
    del m, st, b24, auxes
    free()
    mesh = meshes["tp2"]()
    m = shard_model(fresh(sd, bf16), mesh)
    b8 = batch(sizes["dot_free_batch"], 3)
    shapes = []
    real_plan = pd.pdot_plan

    def recording_plan(mm, k, n, **kw):
        shapes.append((mm, k, n, kw["trans_a"]))
        return real_plan(mm, k, n, **kw)

    pd.pdot_plan = recording_plan
    dotpolicy.set_dot_free(True)
    try:
        auxes, st, _ = counted("bf16_tp2_dot_free", lambda: _train(
            m, mesh, embed, k_cls, b8, 1))
    finally:
        dotpolicy.set_dot_free(None)
        pd.pdot_plan = real_plan
    out["checks"]["bf16_tp2_dot_free"] = {
        "losses": [a["loss"].item() for a in auxes], "pdot_shapes": shapes}
    del m, st, b8, auxes
    free()

    # one sharded SZN eval (fused, K1) on DP=2 and on TP=2 vs one device
    uv = unseen_mask_vector(k_cls, UNSEEN)
    beval = batch(sizes["eval_batch"], 4)

    def szn_eval(mesh):
        m = fresh(sd, f32, dropout=0.0)
        if mesh is not None:
            shard_model(m, mesh)
        step = make_szn_eval_step(loss_name="cos", num_classes=k_cls,
                                  embeddings=embed, all_unseen_vec=uv,
                                  val_unseen_vec=uv, fused=True, mesh=mesh)
        r = step(m, beval)
        if mesh is not None:
            r["pred"] = gather_rows(r["pred"], mesh)
        return r

    want = szn_eval(None) if main else None
    for name in ("dp2", "tp2"):
        got = counted("eval_" + name, lambda: szn_eval(meshes[name]()))
        if main:
            out["checks"]["eval_" + name] = {
                "hists": _hist_held(got["hists"].reshape(-1, k_cls),
                                    want["hists"].reshape(-1, k_cls)),
                "loss_rel": abs(got["loss_sum"].item()
                                - want["loss_sum"].item())
                / abs(want["loss_sum"].item()),
                "pred_flips": (got["pred"] != want["pred"]).float().mean()
                .item()}
    del want
    free()

    # serving: DP=2 in fp32 and bf16 at B=64 (the pristine gate), TP=2 in
    # fp32, the trained gate, FCN-8s's unfused route
    images = batch(sizes["serve_batch"], 5)["image"]

    def serve(mesh, dtype, n, state=sd, cls=None):
        kw = {} if cls is None else {"cls": cls}
        m = fresh(state, dtype, dropout=0.0, **kw)
        pred = make_szn_predictor(m, None, embed, UNSEEN, device=dev,
                                  mesh=mesh)
        return pred(images[:n])

    n_all, n_small = sizes["serve_batch"], sizes["small_serve_batch"]
    ref32 = serve(None, f32, n_all) if main else None
    ref16 = serve(None, bf16, n_all) if main else None
    runs = {"serve_dp2_fp32": ("dp2", f32, n_all),
            "serve_dp2_bf16": ("dp2", bf16, n_all),
            "serve_tp2_fp32": ("tp2", f32, n_small)}
    for name, (mname, dtype, n) in runs.items():
        got = counted(name, lambda: serve(meshes[mname](), dtype, n))
        if main:
            flips32 = (got != ref32[:n]).float().mean().item()
            chk = {"shape": list(got.shape), "flips_vs_fp32": flips32}
            if dtype == bf16:
                base = (ref16 != ref32).float().mean().item()
                chk.update(flips_vs_bf16=(got != ref16).float().mean()
                           .item(), flips_one_device_bf16=base,
                           bar_ok=flips32 <= 2 * base + 1e-6)
            out["checks"][name] = chk
    # the trained gate: a perturbed seenmask upscore (K1 twice)
    trained = dict(sd)
    g = torch.Generator().manual_seed(7)
    trained["seenmask_upscore.weight"] = sd["seenmask_upscore.weight"] + (
        0.05 * torch.randn(sd["seenmask_upscore.weight"].shape,
                           generator=g)).to(dev)
    want = serve(None, f32, n_small, trained) if main else None
    got = counted("serve_dp2_trained_gate",
                  lambda: serve(meshes["dp2"](), f32, n_small, trained))
    if main:
        out["checks"]["serve_dp2_trained_gate"] = {
            "flips": (got != want).float().mean().item()}
    # FCN-8s: the unfused full-resolution route on TP=2
    sd8 = init_state(0, FCN8s)
    want = serve(None, f32, n_small, sd8, FCN8s) if main else None
    got = counted("serve_tp2_fcn8s",
                  lambda: serve(meshes["tp2"](), f32, n_small, sd8, FCN8s))
    if main:
        out["checks"]["serve_tp2_fcn8s"] = {
            "flips": (got != want).float().mean().item()}
    dist.barrier()
    dist.destroy_process_group()
    return out


def _cli_rank(rank: int, world: int, init_method: str, tmp: str,
              ports: list, device: str, extra=()) -> dict:
    """Phase 22 (c)'s rank function: `cli.train.main` as torchrun would
    start it on two ranks sharing `device` over gloo (num_viz 0: the
    card's machine has no Pillow), then a one-epoch resume from its
    checkpoint on the same mesh."""
    from zeroshotsemanticsegmentation_tpu_torch.cli import train as cli
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels

    real_run = cli.run_experiment

    def run_no_viz(cfg, **kw):
        return real_run(cfg.replace(num_viz=0), **kw)

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost")
    common = ["-c", "14", "--synthetic", "--data_parallel", "2",
              "--batch_size", "2", "--eval_batch_size", "2", "-dir", tmp,
              "--device", device, *extra]
    out = {}
    with mock.patch.object(cli, "run_experiment", run_no_viz):
        os.environ["MASTER_PORT"] = str(ports[0])
        _kernels.reset_launch_counts()
        out["first"] = cli.main(common + ["-ve", "1", "-se", "1", "-n",
                                          "mesh"])
        out["launches_first"] = dict(_kernels.launch_counts)
        os.environ["MASTER_PORT"] = str(ports[1])
        resume = osp.join(out["first"]["log_dir"], "checkpoint")
        out["second"] = cli.main(common + ["-r", resume, "-ve", "2", "-se",
                                           "0", "-n", "mesh_resume"])
    return out


def phase_mesh(dev, ckpt32, tmp, card, log, require) -> dict:
    """Phase 22: the mesh layer (`parallel.mesh`) on the card.

    (a) world 1 over NCCL: `make_mesh(1, 1)` through the mesh code path
        (every collective called on a one-rank NCCL group); three bf16
        stage-1 steps at B=24 (dropout 0.5) from the same weights, batch
        and generator as two bare runs, with cuDNN deterministic: the
        parameters bit-equal to the bare run's where two bare runs are
        bit-equal; K3-K6 once a step; the last mesh step with host syncs as
        errors (a sync fails the phase); then the step's time on the mesh path beside the
        bare step's (CUDA events, alternating): the mesh path's cost.
    (b) two ranks sharing the card over gloo (`_mesh_rank`): DP=2, TP=2
        and the 2x1x1 multislice mesh, each two fp32 steps at B=4 with
        dropout on vs the one-device run (loss rtol 1e-5; parameters at
        tests/test_parallel.py's bar; the first step's gradients at
        relative norm < 1e-4 each, which an average instead of a sum
        fails; each parameter's change against one-device Adam replayed
        on the mesh's own gradients at relative norm < 1e-6, which a
        skipped or mis-sharded optimizer step fails; hist exact or the
        near-tie allowance); bf16 DP=2 at B=24
        (finite, K3-K6 once a rank and step); the dot-free mode on TP=2
        bf16 at B=8 (K7 at the TP shard shapes, three launches a rank);
        the fused SZN eval on DP=2 and TP=2 (hists held like the step's);
        serving on DP=2 at B=64 in fp32 (flips < 1e-4) and bf16 (the
        serving bar vs the one-device fp32 labels: at most 2x the
        one-device bf16 run's flips), K2 and K1 once a rank and call; TP=2
        serving, the trained gate (K1 twice) and FCN-8s's unfused route,
        each vs one device (flips < 1e-4).
    (c) the train CLI on two ranks (`_cli_rank`): one set of files from
        rank 0, the checkpoint's keys and shapes those of phase 20's
        one-device file, a resume that continues the counters.
    """
    import torch
    import torch.distributed as dist
    from zeroshotsemanticsegmentation_tpu_torch.data import BatchLoader
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
    from zeroshotsemanticsegmentation_tpu_torch.parallel import dryrun
    from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
        init_distributed, make_mesh, shard_model)
    from zeroshotsemanticsegmentation_tpu_torch.train import (
        TrainState, make_fcn_optimizer, make_fcn_train_step)

    out = {}
    t_phase = time.perf_counter()
    log(f"[mesh] {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        "by this process before phase 22")
    embed, k_cls, batch, init_state, fresh = _mesh_kit(dev, H, 1.0)

    # ---- (a) world 1 over NCCL -------------------------------------------
    init_distributed("nccl", f"tcp://localhost:{free_port()}", 0, 1,
                     timeout=120)
    mesh = make_mesh(1, 1)
    sd = init_state(0)
    tb = batch(TRAIN_BATCH, 0)
    bf = torch.bfloat16

    def run(with_mesh, steps=TRAIN_STEPS, sync_check=False):
        """(model, state, step, generator) of `steps` bf16 steps, on the
        world-1 mesh or bare; with `sync_check` a host sync in the last
        step raises and fails the phase."""
        m = fresh(sd, bf)
        if with_mesh:
            shard_model(m, mesh)
        step = make_fcn_train_step(loss_name="cos", num_classes=k_cls,
                                   embeddings=embed,
                                   mesh=mesh if with_mesh else None)
        st = TrainState.create(m, make_fcn_optimizer(m, optim="adam",
                                                     lr=1e-5))
        gen = torch.Generator(device=dev).manual_seed(0)
        for i in range(steps):
            if sync_check and i == steps - 1:
                torch.cuda.set_sync_debug_mode("error")
            try:
                st, _ = step(st, tb, gen)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return m, st, step, gen

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        a1 = run(False)[0].state_dict()
        a1 = {k: v.clone() for k, v in a1.items()}
        a2 = {k: v.clone() for k, v in run(False)[0].state_dict().items()}
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        mm = run(True, sync_check=True)[0]
        torch.cuda.synchronize()
        la = dict(_kernels.launch_counts)
        am = {k: v.clone() for k, v in mm.state_dict().items()}
    finally:
        torch.backends.cudnn.deterministic = False
    del mm
    bare_equal = all(torch.equal(a1[k], a2[k]) for k in a1)
    mesh_equal = all(torch.equal(a1[k], am[k]) for k in a1)
    bare_rel = max(rel(a2[k], a1[k]) for k in a1)
    mesh_rel = max(rel(am[k], a1[k]) for k in a1)
    del a1, a2, am
    torch.cuda.empty_cache()
    log(f"[mesh a] world 1 nccl: bare runs bit-equal {bare_equal} (max rel "
        f"{bare_rel:.3g}), mesh vs bare bit-equal {mesh_equal} (max rel "
        f"{mesh_rel:.3g}); launches in {TRAIN_STEPS} mesh steps {la}; "
        "no host sync in the last mesh step")
    require(mesh_equal if bare_equal else mesh_rel <= 2 * bare_rel + 1e-7,
            f"world-1 mesh step differs from the bare step: bit-equal "
            f"{mesh_equal}, rel {mesh_rel} (bare vs bare {bare_rel})")
    for key in ("block1_train_fwd", "block1_train_bwd", "costail_fwd",
                "costail_bwd"):
        require(la[key] == TRAIN_STEPS,
                f"world-1 mesh: {key} launched {la[key]} times in "
                f"{TRAIN_STEPS} steps")
    # the mesh path's cost on one card: the same trainer's step with and
    # without it, alternating
    mb = run(False, steps=1)
    mmsh = run(True, steps=1)
    times = {"bare": [], "mesh": []}
    for _ in range(2):
        for name, (m_, st_, step_, gen_) in (("bare", mb), ("mesh", mmsh)):
            st_box = [st_]

            def one(step_=step_, gen_=gen_, st_box=st_box):
                st_box[0], _ = step_(st_box[0], tb, gen_)
            times[name].append(time_ms(one, iters=TIMED_STEPS, warmup=1))
    bare_ms = float(np.mean(times["bare"]))
    mesh_ms = float(np.mean(times["mesh"]))
    del mb, mmsh, tb
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    log(f"[mesh a] {card}: B={TRAIN_BATCH} bf16 step {bare_ms:.2f} ms bare, "
        f"{mesh_ms:.2f} ms on the world-1 NCCL mesh (runs {times}); cost "
        f"{mesh_ms - bare_ms:+.2f} ms a step")
    out["a"] = {"bare_bit_equal": bare_equal, "mesh_bit_equal": mesh_equal,
                "bare_rel": bare_rel, "mesh_rel": mesh_rel,
                "launches": la, "sync_check": "no sync",
                "bare_ms": bare_ms, "mesh_ms": mesh_ms, "runs_ms": times,
                "card": card}
    out["seconds_a"] = time.perf_counter() - t_phase

    # ---- (b) two ranks sharing the card over gloo ---------------------------
    t0 = time.perf_counter()
    sizes = {"mesh_steps": MESH_STEPS, "mesh_batch": MESH_BATCH,
             "bf16_batch": MESH_BF16_BATCH,
             "dot_free_batch": MESH_DOT_FREE_BATCH,
             "serve_batch": MESH_SERVE_BATCH,
             "small_serve_batch": MESH_SMALL_SERVE_BATCH,
             "eval_batch": MESH_EVAL_BATCH}
    ranks = dryrun.spawn(_mesh_rank, 2, (H, 1.0, sizes), timeout_s=600)
    out["seconds_b"] = time.perf_counter() - t0
    checks = ranks[0]["checks"]
    for r in ranks:
        log(f"[mesh b] rank {r['rank']} launches {r['launches']}")
        log(f"[mesh b] rank {r['rank']} seconds "
            + json.dumps({k: round(v, 3) for k, v in r["seconds"].items()}))
    for name, c in checks.items():
        log(f"[mesh b] {name}: {json.dumps(c, default=str)}")
    for name in ("dp2", "tp2", "slice2"):
        c = checks[name]
        require(c["loss_rel"] <= 1e-5 and c["params_ok"]
                and c["grad_keys_equal"] and c["grad_rel_max"] < 1e-4
                and c["replay_keys_equal"] and c["replay_rel_max"] < 1e-6
                and c["hist"]["ok"],
                f"two-rank {name} step vs one device: {c}")
    px = MESH_DOT_FREE_BATCH * 17 * 17
    want_shapes = {(px, 2048, 25088, False), (2048, px, 4096, True),
                   (4096, px, 20, True)}
    for r in ranks:
        lr_ = r["launches"]
        for key in ("block1_train_fwd", "block1_train_bwd", "costail_fwd",
                    "costail_bwd"):
            require(lr_["bf16_dp2"].get(key) == 2,
                    f"rank {r['rank']} bf16 DP=2: {key} "
                    f"{lr_['bf16_dp2'].get(key)} launches in 2 steps")
        require(lr_["bf16_tp2_dot_free"].get("pdot") == 3,
                f"rank {r['rank']} dot-free TP=2: "
                f"{lr_['bf16_tp2_dot_free']}")
        for name in ("serve_dp2_fp32", "serve_dp2_bf16", "serve_tp2_fp32"):
            require(lr_[name].get("block1_fused") == 1
                    and lr_[name].get("szn_fused") == 1,
                    f"rank {r['rank']} {name}: {lr_[name]}")
        require(lr_["serve_dp2_trained_gate"].get("szn_fused") == 2,
                f"rank {r['rank']} trained gate: "
                f"{lr_['serve_dp2_trained_gate']}")
        require(lr_["serve_tp2_fcn8s"].get("block1_fused") == 1
                and not lr_["serve_tp2_fcn8s"].get("szn_fused"),
                f"rank {r['rank']} FCN-8s: {lr_['serve_tp2_fcn8s']}")
        for name in ("eval_dp2", "eval_tp2"):
            require(lr_[name].get("szn_fused") == 1,
                    f"rank {r['rank']} {name}: {lr_[name]}")
    got_shapes = set(map(tuple, checks["bf16_tp2_dot_free"]["pdot_shapes"]))
    require(got_shapes == want_shapes,
            f"dot-free TP=2 products {got_shapes}, want {want_shapes}")
    require(all(np.isfinite(x) for x in checks["bf16_dp2"]["losses"]
                + checks["bf16_tp2_dot_free"]["losses"]),
            f"bf16 mesh losses {checks['bf16_dp2']}")
    for name in ("eval_dp2", "eval_tp2"):
        c = checks[name]
        require(c["hists"]["ok"] and c["loss_rel"] < 1e-4
                and c["pred_flips"] < 1e-4, f"{name}: {c}")
    for name in ("serve_dp2_fp32", "serve_tp2_fp32"):
        require(checks[name]["flips_vs_fp32"] < 1e-4, f"{name}: "
                f"{checks[name]}")
    require(checks["serve_dp2_bf16"]["bar_ok"],
            f"bf16 mesh serving misses the bar: {checks['serve_dp2_bf16']}")
    for name in ("serve_dp2_trained_gate", "serve_tp2_fcn8s"):
        require(checks[name]["flips"] < 1e-4, f"{name}: {checks[name]}")
    out["b"] = {"launches": {r["rank"]: r["launches"] for r in ranks},
                "seconds": {r["rank"]: r["seconds"] for r in ranks},
                "checks": checks}

    # ---- (c) the train CLI on two ranks -------------------------------------
    t0 = time.perf_counter()
    ctmp = osp.join(tmp, "mesh_cli")
    res = dryrun.spawn(_cli_rank, 2, (ctmp, [free_port(), free_port()],
                                      "cuda:0"), timeout_s=600)
    out["seconds_c"] = time.perf_counter() - t0
    first, second = res[0]["first"], res[0]["second"]
    require(all(r["first"]["log_dir"] == first["log_dir"] for r in res),
            "the ranks named different log directories")
    runs = sorted(os.listdir(osp.join(ctmp, "logs")))
    log(f"[mesh c] log dirs {runs}; summary {first}; resume {second}")
    require(len(runs) == 2 and runs[0].startswith("mesh_CFG")
            and runs[1].startswith("mesh_resume_CFG"),
            f"two-rank CLI wrote {runs}")
    log_dir = first["log_dir"]
    names = sorted(os.listdir(log_dir))
    for name in ("config.yaml", "counts.csv", "train_log.csv",
                 "val_log.csv", "seenmask_train_log.csv",
                 "seenmask_val_log.csv", "checkpoint", "best"):
        require(name in names, f"two-rank CLI did not write {name}: {names}")
    require(not [n for n in names if n.endswith(".tmp")],
            f"leftover temporary files: {names}")
    from zeroshotsemanticsegmentation_tpu_torch.cli import train as cli
    from zeroshotsemanticsegmentation_tpu_torch.configs import get_config
    cfg = get_config(14, fcn_epochs=1, seenmask_epochs=1, batch_size=2,
                     eval_batch_size=2, data_parallel=2)
    train_ds, seen_ds, _ = cli._build_datasets(cfg, data_dir=ctmp,
                                               synthetic=True)
    n_s1 = len(BatchLoader(seen_ds, 2))
    n_s2 = len(BatchLoader(train_ds, 2))
    s1 = csv_rows(osp.join(log_dir, "train_log.csv"))
    s2 = csv_rows(osp.join(log_dir, "seenmask_train_log.csv"))
    require(len(s1) == n_s1 and len(s2) == n_s2,
            f"two-rank CLI logged {len(s1)} + {len(s2)} steps, want "
            f"{n_s1} + {n_s2}")
    require(all(np.isfinite(float(r[2])) for r in s1 + s2),
            f"two-rank CLI losses {s1 + s2}")
    for r in res:
        lf = r["launches_first"]
        require(lf["costail_fwd"] == n_s1 and lf["block1_train_bwd"] == n_s1,
                f"rank CLI launches {lf}, {n_s1} stage-1 steps")
    mine = torch.load(osp.join(log_dir, "checkpoint"), map_location="cpu",
                      weights_only=True, mmap=True)
    theirs = torch.load(ckpt32, map_location="cpu", weights_only=True,
                        mmap=True)

    def shapes(blob):
        return ({k: tuple(v.shape)
                 for k, v in blob["model_state_dict"].items()},
                {i: {k: tuple(v.shape) for k, v in s.items()}
                 for i, s in blob["optim_state_dict"]["state"].items()},
                blob["optim_state_dict"]["param_groups"])

    require(shapes(mine) == shapes(theirs),
            "the two-rank checkpoint's keys or shapes differ from the "
            "one-device run's")
    del mine, theirs
    r2 = csv_rows(osp.join(second["log_dir"], "train_log.csv"))
    require(len(r2) == n_s1 and {r[0] for r in r2} == {"1"}
            and int(r2[0][1]) == n_s1,
            f"the two-rank resume trained {r2}")
    out["c"] = {"runs": runs, "steps": [n_s1, n_s2], "resume_rows": len(r2),
                "launches_first": [r["launches_first"] for r in res]}
    for d in runs:
        shutil.rmtree(osp.join(ctmp, "logs", d))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[mesh] {card}: phase 22 {out['seconds']:.1f} s (a "
        f"{out['seconds_a']:.1f}, b {out['seconds_b']:.1f}, c "
        f"{out['seconds_c']:.1f})")
    return out


SPATIAL_HW = 2048       # phase 23 (a): one image, B=1, world 1 over NCCL
SPATIAL_MESH_HW = 512   # (b): two ranks over gloo
SPATIAL_INT8_BATCH = 8  # (b)'s int8 DP=2 and TP=2
SPATIAL_BIG_HW = 4096   # (c): the per-rank peak memory
SPATIAL_TIMED = 3       # (a)'s calls a timing, two timings each in turn
SPATIAL_PEAK_SHARE = 0.75


def _labels_flip(a, b) -> float:
    return (a != b).float().mean().item()


def _spatial_rank(rank: int, world: int, init_method: str, hw: int,
                  big_hw: int, scale: float, device: str | None) -> dict:
    """Phase 23 (b) and (c)'s rank function: two ranks sharing the card
    over gloo (or the CPU, for a small check of this code). Rank 0 runs
    the one-device references; every rank reports its launch counts and
    (c)'s peak memory."""
    import torch
    import torch.distributed as dist
    from zeroshotsemanticsegmentation_tpu_torch.models.fcn8s import FCN8s
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
    from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
        init_distributed, make_mesh)
    from zeroshotsemanticsegmentation_tpu_torch.serving import (
        make_szn_predictor)

    dev = torch.device(device or "cuda:0")
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed("gloo", init_method, rank, world, timeout=300)
    embed, _, batch, init_state, fresh = _mesh_kit(dev, hw, scale)
    f32, bf16 = torch.float32, torch.bfloat16
    main = rank == 0
    out = {"rank": rank, "launches": {}, "checks": {}, "seconds": {}}
    sd, sd8 = init_state(0), init_state(0, FCN8s)
    trained = dict(sd)
    g = torch.Generator().manual_seed(7)
    trained["seenmask_upscore.weight"] = sd["seenmask_upscore.weight"] + (
        0.05 * torch.randn(sd["seenmask_upscore.weight"].shape,
                           generator=g)).to(dev)
    img1 = batch(1, 31)["image"]
    img8 = batch(SPATIAL_INT8_BATCH, 32)["image"]
    meshes = {"dp2": lambda: make_mesh(2, 1, devices=[dev] * world),
              "tp2": lambda: make_mesh(1, 2, devices=[dev] * world)}

    def serve(mesh, images, state=sd, cls=None, dtype=f32, **kw):
        m = fresh(state, dtype, dropout=0.0,
                  **({} if cls is None else {"cls": cls}))
        return make_szn_predictor(m, None, embed, UNSEEN, device=dev,
                                  mesh=mesh, **kw)(images)

    def counted(name, fn):
        if cuda:
            torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        r = fn()
        if cuda:
            torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        out["launches"][name] = {k: v for k, v in
                                 _kernels.launch_counts.items() if v}
        return r

    # (b): (mesh, images, state, class, flags); the reference is the same
    # call on one device
    runs = {"spatial_pristine": ("dp2", img1, sd, None, {"spatial": True}),
            "spatial_trained": ("dp2", img1, trained, None,
                                {"spatial": True}),
            "spatial_fcn8s": ("dp2", img1, sd8, FCN8s, {"spatial": True}),
            "int8_dp2": ("dp2", img8, sd, None, {"int8": True}),
            "int8_tp2": ("tp2", img8, sd, None, {"int8": True}),
            "int8_spatial": ("dp2", img1, sd, None,
                             {"spatial": True, "int8": True})}
    for name, (mname, images, state, cls, kw) in runs.items():
        got = counted(name, lambda: serve(meshes[mname](), images, state,
                                          cls, **kw))
        if main:
            int8 = kw.get("int8", False)
            want = serve(None, images, state, cls, int8=int8)
            chk = {"shape": list(got.shape),
                   "flips": _labels_flip(got, want)}
            if int8:
                chk["flips_vs_bf16"] = _labels_flip(
                    got, serve(None, images, state, cls, dtype=bf16))
            out["checks"][name] = chk
        if cuda:
            torch.cuda.empty_cache()

    # (c): one big image in bf16, rank 0 on one device first; peaks from
    # a reset with the model's weights and the image already allocated
    gen = torch.Generator(device=dev).manual_seed(33)
    big = torch.randn((1, big_hw, big_hw, 3), generator=gen,
                      device=dev) * 40
    if main:
        m = fresh(sd, bf16, dropout=0.0)
        pred = make_szn_predictor(m, None, embed, UNSEEN, device=dev)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        base = counted("big_one_device", lambda: pred(big)).cpu()
        if cuda:
            out["checks"]["peak_one_device"] = (
                torch.cuda.max_memory_allocated())
        del m, pred
    dist.barrier()
    m = fresh(sd, bf16, dropout=0.0)
    pred = make_szn_predictor(m, None, embed, UNSEEN, device=dev,
                              mesh=meshes["dp2"](), spatial=True)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    got = counted("big_spatial", lambda: pred(big))
    if cuda:
        out["peak_spatial"] = torch.cuda.max_memory_allocated()
    if main:
        out["checks"]["big_flips_vs_one_device_bf16"] = _labels_flip(
            got.cpu(), base)
    dist.barrier()
    dist.destroy_process_group()
    return out


def phase_spatial(dev, card, log, require) -> dict:
    """Phase 23: height-sharded (spatial) serving and int8 serving on a
    mesh (`parallel.spatial`, `models.quantized` with `mesh=`).

    (a) world 1 over NCCL: FCN-32s at full width, B=1, 2048x2048, through
        `make_szn_predictor(..., mesh=make_mesh(1, 1), spatial=True)`: fp32
        labels vs the one-device predictor (flips < 1e-4), bf16 vs fp32
        under the serving bar (at most 2x the one-device bf16 run's
        flips), K2 and K1 once a call; the band calls of K2 and K1 on the
        two-band plan of this image held against their plain versions
        (and against the whole call's rows); then both predictors timed
        in turns with CUDA events in bf16, the spatial path's cost, and a
        profile window of each.
    (b) two ranks sharing the card over gloo (`_spatial_rank`) at
        512x512 vs one device: spatial data=2 (B=1) on the pristine gate
        (K2, K1 once a rank), the trained gate (K1 twice) and FCN-8s (K2
        once, K1 never), flips < 1e-4; int8 DP=2 and TP=2 at B=8 and int8
        spatial data=2, each equal to the one-device int8 labels (flips <
        1e-4) and within the int8 bar of the one-device bf16 labels (<
        0.08), K1 once a rank, K2 never.
    (c) a 4096x4096 image at B=1, bf16, over the same two ranks: each
        rank's `torch.cuda.max_memory_allocated` below 0.75x the one-device
        run's, and the labels vs the one-device bf16 labels (logged).
    """
    import torch
    import torch.distributed as dist
    from zeroshotsemanticsegmentation_tpu_torch.models.pruned import (
        _image_rows)
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
    from zeroshotsemanticsegmentation_tpu_torch.ops import block1_fused as b1
    from zeroshotsemanticsegmentation_tpu_torch.ops import szn_fused as sz
    from zeroshotsemanticsegmentation_tpu_torch.parallel import dryrun
    from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
        init_distributed, make_mesh)
    from zeroshotsemanticsegmentation_tpu_torch.parallel.spatial import (
        plan_bands)
    from zeroshotsemanticsegmentation_tpu_torch.serving import (
        make_szn_predictor)

    out = {}
    t_phase = time.perf_counter()
    embed, _, batch, init_state, fresh = _mesh_kit(dev, SPATIAL_HW, 1.0)
    f32, bf16 = torch.float32, torch.bfloat16
    sd = init_state(0)
    img = batch(1, 23)["image"]

    # ---- (a) world 1 over NCCL -------------------------------------------
    init_distributed("nccl", f"tcp://localhost:{free_port()}", 0, 1,
                     timeout=120)
    mesh = make_mesh(1, 1)

    def predictor(dtype, spatial):
        return make_szn_predictor(
            fresh(sd, dtype, dropout=0.0), None, embed, UNSEEN, device=dev,
            mesh=mesh if spatial else None, spatial=spatial)

    def counted(fn):
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        r = fn()
        torch.cuda.synchronize()
        return r, {k: v for k, v in _kernels.launch_counts.items() if v}

    one32, sp32 = predictor(f32, False), predictor(f32, True)
    want32 = one32(img)
    got32, la32 = counted(lambda: sp32(img))
    del one32, sp32
    one16, sp16 = predictor(bf16, False), predictor(bf16, True)
    want16 = one16(img)
    got16, la16 = counted(lambda: sp16(img))
    flips32 = _labels_flip(got32, want32)
    base = _labels_flip(want16, want32)
    flips16 = _labels_flip(got16, want32)
    log(f"[spatial a] world 1 nccl, B=1 {SPATIAL_HW}x{SPATIAL_HW}: fp32 "
        f"flips vs one device {flips32:.3g}; bf16 flips vs fp32 "
        f"{flips16:.4g} (one-device bf16 {base:.4g}, bar 2x); launches "
        f"fp32 {la32}, bf16 {la16}")
    require(got32.shape == want32.shape and flips32 < 1e-4,
            f"world-1 spatial fp32 flips {flips32}")
    require(flips16 <= 2 * base + 1e-6,
            f"world-1 spatial bf16 misses the serving bar: {flips16} vs "
            f"one-device {base}")
    for la in (la32, la16):
        require(la.get("block1_fused") == 1 and la.get("szn_fused") == 1,
                f"world-1 spatial launches {la}")
    times = {"one_device": [], "spatial": []}
    for _ in range(2):
        for name, fn in (("one_device", lambda: one16(img)),
                         ("spatial", lambda: sp16(img))):
            times[name].append(time_ms(fn, iters=SPATIAL_TIMED, warmup=1))
    one_ms = float(np.mean(times["one_device"]))
    sp_ms = float(np.mean(times["spatial"]))
    log(f"[spatial a] {card}: B=1 {SPATIAL_HW}x{SPATIAL_HW} bf16 "
        f"{one_ms:.2f} ms one device, {sp_ms:.2f} ms spatial on the world-1 "
        f"NCCL mesh (runs {times}); cost {sp_ms - one_ms:+.2f} ms a call")
    profiles = {"one_device": profile_window(lambda: one16(img), iters=3),
                "spatial": profile_window(lambda: sp16(img), iters=3)}
    for name, prof in profiles.items():
        log(f"[spatial a] profile {name}: {json.dumps(prof)}")
    del one16, sp16, got16, want16, got32, want32
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    out["a"] = {"flips_fp32": flips32, "flips_bf16_vs_fp32": flips16,
                "flips_one_device_bf16": base, "launches_fp32": la32,
                "launches_bf16": la16, "one_device_ms": one_ms,
                "spatial_ms": sp_ms, "runs_ms": times, "profiles": profiles,
                "card": card}

    # the band calls of K2 and K1 on this image's two-band plan, vs their
    # plain versions on the same inputs and vs the whole call's rows
    plan = plan_bands(SPATIAL_HW, SPATIAL_HW, 2)
    x = img.to(f32)
    wts = [sd[f"conv1_{i}.{t}"] for i in (1, 2) for t in ("weight", "bias")]
    s1 = 48  # K2's first output row on the pool1 grid (models.pruned)
    e1 = s1 + (SPATIAL_HW + 6) // 2

    def k2_input(lo, hi):
        """K2's input for its output rows [lo, hi) of the pool1 grid, as
        `run_pruned_blocks` slices it (even widths)."""
        return _image_rows(x, 2 * (lo - s1) - 5, 2 * (hi - s1) - 1, bf16,
                           5, 5)

    k2 = {"max_abs_err": 0.0, "bit_equal_to_whole": True, "shapes": []}
    with torch.inference_mode():
        whole = b1.block1_fused(k2_input(s1, e1), *wts, bf16)
        for r in range(2):
            lo, hi = plan.rows(1, r)
            lo, hi = max(lo, s1), min(hi, e1)
            xp = k2_input(lo, hi)
            got = b1.block1_fused(xp, *wts, bf16)
            ref = b1.block1_plain(xp, *wts, f32)
            err = (got.float() - ref).abs().max().item()
            bar = 2 * ref.abs().max().item() * 2.0 ** -8
            require(err <= bar, f"K2 band {r}: bf16 error {err} > {bar}")
            k2["max_abs_err"] = max(k2["max_abs_err"], err)
            k2["bit_equal_to_whole"] &= torch.equal(
                got, whole[:, lo - s1:hi - s1])
            k2["shapes"].append(list(xp.shape))
    k1 = {"flips_vs_plain": 0.0, "equal_to_whole": True, "rows": []}
    h32 = plan.heights[5] - 6
    aug = torch.randn((1, h32, h32, 22), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(5))
    uv = np.zeros(21, bool)
    uv[UNSEEN] = True
    part = sz._partition(~uv, uv)
    whole = sz.szn_labels(aug, *part, SPATIAL_HW, SPATIAL_HW)
    for r in range(2):
        rows = plan.out_rows[r:r + 2]
        got = sz.szn_labels(aug, *part, SPATIAL_HW, SPATIAL_HW, rows)
        ref = sz.szn_labels_plain(aug, *part, SPATIAL_HW, SPATIAL_HW, rows)
        fl = _labels_flip(got, ref)
        require(fl < 1e-4, f"K1 band {rows}: flips vs plain {fl}")
        k1["flips_vs_plain"] = max(k1["flips_vs_plain"], fl)
        k1["equal_to_whole"] &= torch.equal(got, whole[:, rows[0]:rows[1]])
        k1["rows"].append(list(rows))
    require(k1["equal_to_whole"], "K1 on a band of rows differs from the "
            "whole call's rows")
    log(f"[spatial a] band calls: K2 {k2}; K1 {k1}")
    out["k2_band"], out["k1_band"] = k2, k1
    del whole, aug, x, img
    torch.cuda.empty_cache()
    out["seconds_a"] = time.perf_counter() - t_phase

    # ---- (b), (c) two ranks sharing the card over gloo --------------------
    t0 = time.perf_counter()
    ranks = dryrun.spawn(_spatial_rank, 2, (SPATIAL_MESH_HW, SPATIAL_BIG_HW,
                                            1.0, None), timeout_s=600)
    out["seconds_bc"] = time.perf_counter() - t0
    checks = ranks[0]["checks"]
    for r in ranks:
        log(f"[spatial b] rank {r['rank']} launches {r['launches']}")
        log(f"[spatial b] rank {r['rank']} seconds "
            + json.dumps({k: round(v, 3) for k, v in r["seconds"].items()}))
    for name, c in checks.items():
        log(f"[spatial b] {name}: {json.dumps(c)}")
    want_launches = {
        "spatial_pristine": {"block1_fused": 1, "szn_fused": 1},
        "spatial_trained": {"block1_fused": 1, "szn_fused": 2},
        "spatial_fcn8s": {"block1_fused": 1},
        "int8_dp2": {"szn_fused": 1}, "int8_tp2": {"szn_fused": 1},
        "int8_spatial": {"szn_fused": 1},
        "big_spatial": {"block1_fused": 1, "szn_fused": 1}}
    for r in ranks:
        for name, want in want_launches.items():
            got = {k: v for k, v in r["launches"][name].items()
                   if k in ("block1_fused", "szn_fused")}
            require(got == want, f"rank {r['rank']} {name}: launches "
                    f"{r['launches'][name]}, want {want}")
    for name in want_launches:
        if name == "big_spatial":
            continue
        c = checks[name]
        require(c["flips"] < 1e-4, f"two-rank {name} vs one device: {c}")
        if name.startswith("int8"):
            require(c["flips_vs_bf16"] < 0.08, f"{name} vs bf16: {c}")
    one = checks["peak_one_device"]
    peaks = {r["rank"]: r["peak_spatial"] for r in ranks}
    log(f"[spatial c] {card}: B=1 {SPATIAL_BIG_HW}x{SPATIAL_BIG_HW} bf16 "
        f"peak memory one device {one / 1e9:.3f} GB, spatial data=2 by rank "
        + ", ".join(f"{r}: {p / 1e9:.3f} GB ({p / one:.3f}x)"
                    for r, p in peaks.items())
        + "; labels vs one device "
        f"{checks['big_flips_vs_one_device_bf16']:.3g}")
    for r, p in peaks.items():
        require(p < SPATIAL_PEAK_SHARE * one,
                f"rank {r}'s peak {p} is not below {SPATIAL_PEAK_SHARE}x the "
                f"one-device peak {one}")
    out["b"] = {"launches": {r["rank"]: r["launches"] for r in ranks},
                "seconds": {r["rank"]: r["seconds"] for r in ranks},
                "checks": checks}
    out["c"] = {"peak_one_device": one, "peak_spatial": peaks}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[spatial] {card}: phase 23 {out['seconds']:.1f} s (a "
        f"{out['seconds_a']:.1f}, b and c {out['seconds_bc']:.1f})")
    return out


DECODE_LOOP_IMAGES = LOOP_IMAGES    # phase 24's timed epoch: 40 steps
DECODE_WARMUP_IMAGES = LOOP_WARMUP_IMAGES
DECODE_THREADS = (1, 2, 4, 8)       # (d)'s feed-alone thread counts
# (b): a decode's |err| from its seeded source, for JPEG qualities 85-95
# (the fixtures' libjpeg decodes: mean 0.34-1.33, max 5-34); a decoder
# other than libjpeg (nvJPEG) within DECODE_VS_LIBJPEG levels of
# libjpeg's pixels: its IDCT may round each of Y, Cb and Cr one level
# otherwise, which libjpeg's colour conversion (R = Y + 1.402 Cr, B = Y +
# 1.772 Cb) takes to at most 3
DECODE_MEAN_ERR = 2.0
DECODE_MAX_ERR = 48
DECODE_VS_LIBJPEG = 3
# the label classes of the tree's four label maps, by fixture: the first
# and third keep only classes seen in every split of preset 14, the
# second holds train_unseen 1, the fourth val_unseen 6 and 7
TREE_CLASSES = ((0, 3, 5, 8), (0, 1, 9, 11), (0, 2, 4, 12), (0, 6, 7))


@contextlib.contextmanager
def without_pillow():
    """`import PIL` fails inside: the native path must not need Pillow
    (the card's machine may have it; the port must not depend on it)."""
    saved = {k: v for k, v in sys.modules.items()
             if k == "PIL" or k.startswith("PIL.")}
    for k in saved:
        del sys.modules[k]
    sys.modules["PIL"] = None
    try:
        yield
    finally:
        del sys.modules["PIL"]
        sys.modules.update(saved)


def decode_checks(nl, fx, tmp: str, log, require) -> dict:
    """Phase 24 (b): the committed JPEG fixtures against their seeded
    sources (and libjpeg's recorded pixels), PNG and MAT labels written here
    from seeded arrays held exactly, and corrupt, truncated and oversized
    files to their error codes."""
    import scipy.io
    from zeroshotsemanticsegmentation_tpu_torch.data.native import (
        DecodeError)
    from zeroshotsemanticsegmentation_tpu_torch.data.transforms import (
        transform_image)
    out = {"images": {}, "labels": {}, "errors": {}}
    record = fx.load_record()
    for name, rec in sorted(record.items()):
        path = osp.join(fx.FIXTURE_DIR, rec["file"])
        h, w = rec["hw"]
        imgs, _, sizes = nl.load_batch([path], [None], (H, W), compact=True)
        require(sizes[0].tolist() == [h, w],
                f"fixture {name}: size {sizes[0].tolist()}, want {[h, w]}")
        dec = imgs[0, :h, :w]
        require(not imgs[0, h:].any() and not imgs[0, :, w:].any(),
                f"fixture {name}: the bucket's pad is not zero")
        err = np.abs(dec.astype(np.int32) - fx.as_rgb(fx.source_image(name)))
        vs = np.abs(dec.astype(np.int32) - fx.libjpeg_decode(name))
        fimg, _ = nl.decode_image(path, (H, W))
        want_f = transform_image(dec)
        row = {"hw": [h, w], "quality": rec["quality"],
               "subsampling": rec["subsampling"], "mode": rec["mode"],
               "mean_abs_err": float(err.mean()),
               "max_abs_err": int(err.max()),
               "libjpeg_mean_abs_err": rec["decode_mean_abs_err"],
               "libjpeg_max_abs_err": rec["decode_max_abs_err"],
               "vs_libjpeg_max": int(vs.max()),
               "vs_libjpeg_mean": float(vs.mean()),
               "vs_libjpeg_differ_share": float((vs > 0).mean()),
               "bit_equal_to_recorded_sha256":
                   fx.sha256(dec.tobytes()) == rec["decode_sha256"],
               "float_path_equal": bool(np.array_equal(fimg[:h, :w],
                                                       want_f))}
        out["images"][name] = row
        require(row["mean_abs_err"] <= DECODE_MEAN_ERR
                and row["max_abs_err"] <= DECODE_MAX_ERR,
                f"fixture {name}: |err| from its source {row}")
        require(row["vs_libjpeg_max"] <= DECODE_VS_LIBJPEG,
                f"fixture {name}: vs libjpeg's pixels {row}")
        require(row["float_path_equal"],
                f"fixture {name}: the float path is not the transformed "
                "uint8 decode")
    # labels, exact: PNG (stdlib writer) and MAT (scipy)
    cases = [("png8_gray", 8, False, False), ("png8_palette", 8, True, False),
             ("png1_gray", 1, False, False), ("png2_gray", 2, False, False),
             ("png4_gray", 4, False, False), ("png1_palette", 1, True, False),
             ("png2_palette", 2, True, False),
             ("png4_palette", 4, True, False),
             ("png8_gray_adam7", 8, False, True),
             ("png4_palette_adam7", 4, True, True)]
    for i, (name, depth, palette, interlace) in enumerate(cases):
        n_values = min(2 ** depth, 21)
        lbl = fx.label_array(100 + i, 375, 500, n_values,
                             boundary=255 if depth == 8 else n_values - 1)
        path = osp.join(tmp, f"{name}.png")
        fx.write_png(path, lbl, depth=depth, palette=palette,
                     interlace=interlace, seed=i)
        vals = fx.png_values(lbl, depth, palette)
        got, size = nl.decode_label(path, (H, W))
        ok = size == (375, 500) and np.array_equal(
            got[:375, :500], np.where(vals == 255, -1, vals)) and \
            (got[375:] == -1).all() and (got[:, 500:] == -1).all()
        got_c, _ = nl.decode_label(path, (H, W), value_offset=-1,
                                   map255_to_ignore=False)
        ok = ok and np.array_equal(got_c[:375, :500], vals - 1)
        out["labels"][name] = ok
        require(ok, f"label {name} is not its seeded array")
    for comp in (False, True):
        lbl = fx.label_array(200 + comp, 366, 500)
        path = osp.join(tmp, f"gtcls_{int(comp)}.mat")
        scipy.io.savemat(path, {"GTcls": {
            "Boundaries": np.zeros((1, 1)), "Segmentation": lbl,
            "CategoriesPresent": np.unique(lbl)}}, do_compression=comp)
        got, size = nl.decode_label(path, (H, W))
        _, labels, _ = nl.load_batch([fx.FIXTURE_DIR + "/landscape_420.jpg"],
                                     [path], (H, W), compact=True)
        want = np.where(lbl == 255, -1, lbl.astype(np.int32))
        ok = size == (366, 500) and np.array_equal(got[:366, :500], want) \
            and np.array_equal(labels[0, :366, :500], want)
        out["labels"][f"mat_{'compressed' if comp else 'plain'}"] = ok
        require(ok, f"MAT label (do_compression={comp}) is not its array")
    # error codes
    good_png = osp.join(tmp, "png8_gray.png")
    png = open(good_png, "rb").read()
    jpg = open(osp.join(fx.FIXTURE_DIR, "landscape_420.jpg"), "rb").read()
    bad = {"truncated.png": (png[:len(png) // 2], "label", -1),
           "bad_crc.png": (png[:30] + bytes([png[30] ^ 0xff]) + png[31:],
                           "label", -1),
           "garbage.mat": (b"MATLAB 5.0 MAT-file" + b" " * 105 + b"\x00\x01IM"
                           + b"\xff" * 64, "label", -3),
           "unknown.lbl": (b"GIF89a" + b"\x00" * 64, "label", -4),
           "not_a.jpg": (b"\xff\xd8" + b"\x00" * 64, "image", -1),
           "truncated.jpg": (jpg[:len(jpg) // 4], "image", None)}
    for name, (data, kind, want) in bad.items():
        path = osp.join(tmp, name)
        with open(path, "wb") as f:
            f.write(data)
        try:
            if kind == "label":
                nl.decode_label(path, (H, W))
            else:
                nl.decode_image(path, (H, W))
            rc = 0
        except DecodeError as e:
            rc = e.rc
        out["errors"][name] = rc
        # a truncated JPEG: libjpeg may pad a partial image (0), others fail
        require(rc == want or (want is None and rc in (0, -1)),
                f"{name}: rc {rc}, want {want}")
    big = osp.join(tmp, "big.png")
    fx.write_png(big, fx.label_array(5, 600, 520))
    try:
        nl.decode_label(big, (H, W))
        rc = size = 0
    except DecodeError as e:
        rc, size = e.rc, e.size
    out["errors"]["big.png"] = rc
    require(rc == -2 and size == (600, 520),
            f"a 600x520 label in a {H}x{W} bucket: rc {rc}, size {size}")
    wide = osp.join(tmp, "wide.mat")
    scipy.io.savemat(wide, {"GTcls": {"Segmentation": np.full((8, 8), 300,
                                                              np.uint16)}})
    try:
        nl.load_batch([fx.FIXTURE_DIR + "/gray.jpg"], [wide], (H, W),
                      compact=True)
        rc = 0
    except DecodeError as e:
        rc = e.rc
    out["errors"]["wide.mat (compact)"] = rc
    require(rc == -5, f"a label of 300 in the int8 feed: rc {rc}")
    return out


def build_tree(fx, root: str, n_train: int, n_val: int
               ) -> tuple[str, dict]:
    """A VOC2012 / SBD layout under `root`/data (JPEGImages and
    SegmentationClass PNGs for val, SBD img and compressed cls .mat for
    train): `n_train` train and `n_val` val ids, each a link to one of the
    fixtures and its label (`TREE_CLASSES`), and split lists in
    `root`/assets (the bundled embeddings linked in). Returns (data dir,
    {"assets": dir, "cli_assets": dir with 12 train and 4 val ids,
    "classes": each train id's label classes})."""
    import scipy.io
    data = osp.join(root, "data")
    voc = osp.join(data, "pascal", "VOCdevkit", "VOC2012")
    sbd = osp.join(data, "pascal", "benchmark_RELEASE", "dataset")
    dirs = {k: osp.join(*p) for k, p in (
        ("jpg", (voc, "JPEGImages")), ("png", (voc, "SegmentationClass")),
        ("img", (sbd, "img")), ("cls", (sbd, "cls")),
        ("src", (root, "labels")))}
    for d in dirs.values():
        os.makedirs(d)
    names = sorted(fx.SPECS)
    srcs, present = [], []
    for i, name in enumerate(names):
        h, w = fx.SPECS[name][:2]
        classes = np.array(TREE_CLASSES[i], np.uint8)
        lbl = fx.label_array(300 + i, h, w, len(classes))
        lbl = np.where(lbl == 255, 255, classes[lbl % len(classes)])
        present.append(set(np.unique(lbl).tolist()) - {255})
        png = osp.join(dirs["src"], f"{name}.png")
        fx.write_png(png, lbl.astype(np.uint8), palette=True, seed=i)
        mat = osp.join(dirs["src"], f"{name}.mat")
        scipy.io.savemat(mat, {"GTcls": {"Segmentation": lbl}},
                         do_compression=True)
        srcs.append((osp.join(fx.FIXTURE_DIR, f"{name}.jpg"), png, mat))
    train = [f"2008_{i:06d}" for i in range(n_train)]
    val = [f"2007_{i:06d}" for i in range(n_val)]
    for i, did in enumerate(train):
        jpg, _, mat = srcs[i % len(srcs)]
        os.symlink(jpg, osp.join(dirs["img"], f"{did}.jpg"))
        os.symlink(mat, osp.join(dirs["cls"], f"{did}.mat"))
    for i, did in enumerate(val):
        jpg, png, _ = srcs[i % len(srcs)]
        os.symlink(jpg, osp.join(dirs["jpg"], f"{did}.jpg"))
        os.symlink(png, osp.join(dirs["png"], f"{did}.png"))
    out = {"classes": [present[i % len(srcs)] for i in range(n_train)]}
    for key, tr, va in (("assets", train, val),
                        ("cli_assets", train[:12], val[:4])):
        d = osp.join(root, key, "pascal")
        os.makedirs(d)
        os.symlink(osp.join(ROOT, "assets", "pascal", "embeddings"),
                   osp.join(d, "embeddings"))
        for split, ids in (("train", tr), ("val", va)):
            with open(osp.join(d, f"{split}.txt"), "w") as f:
                f.write("\n".join(ids) + "\n")
        out[key] = osp.dirname(d)
    return data, out


def phase_decoder(dev, embed, loop20: dict, card: str, log,
                  require) -> dict:
    """Phase 24: the native decoder on the card's machine.

    (a) builds the decoder from csrc/zss_loader.cc (g++; libjpeg where the
        compiler finds jpeglib.h, else nvJPEG) and prints the toolchain;
    (b) `decode_checks`: the committed JPEG fixtures within the stated
        |err| of their seeded sources and of libjpeg's pixels (bit-equal to
        the recorded SHA-256 printed), PNG and MAT labels exact, corrupt,
        truncated and oversized files to their error codes;
    (c) a VOC/SBD-layout tree of links to the fixtures in the process's
        temporary directory (`build_tree`), 960 train and 96 val ids, and
        the native presence scan of preset 14's train_seen split timed;
    (d) the feed alone: BatchLoader(PascalVOC("train"), 24, compact, pinned)
        over the 960 images at 1, 2, 4 and 8 threads, and the host's cores;
    (e) the loop: FCNTrainer at B=24 over the tree (`time_loop`, as phase
        20's: a warm-up epoch on the val split, 40 timed steps with host
        syncs turned into errors between flushes) beside its bare step and
        phase 20's synthetic loop; every batch natively decoded;
    (f) the train CLI: `-c 14 -ve 1 -se 0` on the tree at full width (12
        train and 4 val ids; `num_viz` 0), its files and its log naming the
        native decoder.
    (c)-(f) run with `import PIL` failing.
    """
    import torch
    from zeroshotsemanticsegmentation_tpu_torch.cli import train as cli
    from zeroshotsemanticsegmentation_tpu_torch.configs import get_config
    from zeroshotsemanticsegmentation_tpu_torch.data import (
        BatchLoader, PascalVOC)
    from zeroshotsemanticsegmentation_tpu_torch.data import assets as passets
    from zeroshotsemanticsegmentation_tpu_torch.data import native
    from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
    from zeroshotsemanticsegmentation_tpu_torch.train import (
        FCNTrainer, make_fcn_optimizer)
    from zeroshotsemanticsegmentation_tpu_torch.utils import RunLogger

    t_phase = time.perf_counter()
    out = {}
    # (a) the toolchain
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    nl = native.NativeLoader.get()
    out["toolchain"] = {"g++": gxx, **nl.build_info(),
                        "build_s": native.build_log["seconds"],
                        "command": native.build_log["command"]}
    log(f"[decoder] {card}: {json.dumps(out['toolchain'])}")
    require(osp.samefile(native.SOURCE, osp.join(
        ROOT, "zeroshotsemanticsegmentation_tpu_torch", "csrc",
        "zss_loader.cc")), f"the decoder's source is {native.SOURCE}")
    fx = load_script("torch_make_decode_fixtures")
    with tempfile.TemporaryDirectory() as tmp:
        # (b) fixtures, labels, error codes
        out["checks"] = decode_checks(nl, fx, tmp, log, require)
        log(f"[decoder] checks: {json.dumps(out['checks'])}")
        with without_pillow():
            # (c) the tree, the presence scan
            t0 = time.perf_counter()
            data, trees = build_tree(fx, tmp, DECODE_LOOP_IMAGES,
                                     DECODE_WARMUP_IMAGES)
            out["tree_s"] = time.perf_counter() - t0
            cfg14 = get_config(14)
            kw = dict(data_dir=data, assets_dir=trees["assets"])
            t0 = time.perf_counter()
            seen = PascalVOC("train_seen", use_presence_cache=False,
                             train_unseen=list(cfg14.train_unseen),
                             val_unseen=list(cfg14.val_unseen), **kw)
            drop = set(cfg14.train_unseen) | set(cfg14.val_unseen)
            want = sum(not c & drop for c in trees["classes"])
            out["scan"] = {"labels": DECODE_LOOP_IMAGES,
                           "seconds": time.perf_counter() - t0,
                           "kept": len(seen), "want": want}
            require(len(seen) == want,
                    f"the scan kept {len(seen)} of {DECODE_LOOP_IMAGES}, "
                    f"want {want}")
            # (d) the feed alone, by thread count
            train_ds = PascalVOC("train", **kw)
            feed = {}
            for nt in DECODE_THREADS:
                loader = BatchLoader(train_ds, TRAIN_BATCH, bucket_hw=(H, W),
                                     shuffle=True, compact=True,
                                     num_threads=nt, pin_memory=True)
                t0 = time.perf_counter()
                n = sum(b["num_real"] for b in loader)
                feed[nt] = n / (time.perf_counter() - t0)
            out["feed_alone_images_per_s"] = feed
            out["cores"] = len(os.sched_getaffinity(0))
            log(f"[decoder] {card}: feed alone img/s by threads {feed}, "
                f"{out['cores']} usable cores; scan {out['scan']}")
            # (e) the loop
            lcfg = get_config(14, batch_size=TRAIN_BATCH,
                              eval_batch_size=TRAIN_BATCH)
            loader = BatchLoader(train_ds, TRAIN_BATCH, bucket_hw=(H, W),
                                 shuffle=True, seed=lcfg.seed, compact=True,
                                 pin_memory=True)
            warm = BatchLoader(PascalVOC("val", **kw), TRAIN_BATCH,
                               bucket_hw=(H, W), shuffle=True,
                               seed=lcfg.seed, compact=True, pin_memory=True)
            require(loader.decoder == warm.decoder == "native",
                    f"the loop's decoders: {loader.decoder}, {warm.decoder}")
            model = FCN32s(20, dtype=torch.bfloat16, fused_block1=True,
                           generator=torch.Generator().manual_seed(lcfg.seed),
                           device=dev)
            trainer = FCNTrainer(
                cfg=lcfg, model=model,
                optimizer=make_fcn_optimizer(model, optim="adam",
                                             lr=lcfg.fcn_lr),
                train_loader=warm, val_loader=loader,
                logger=RunLogger(osp.join(tmp, "loop"), tensorboard=False,
                                 verbose=False),
                embeddings=embed, target_embeddings=embed,
                upscore_trained=False)
            lp = time_loop(dev, trainer, loader, osp.join(tmp, "loop"),
                           require)
            require(lp["launches"]["native_batches"] == lp["steps"],
                    f"{lp['launches']['native_batches']} batches decoded "
                    f"natively in {lp['steps']} steps")
            out["loop"] = {
                **{k: v for k, v in lp.items() if k != "launches"},
                "native_batches": lp["launches"]["native_batches"],
                "synthetic_loop_images_per_s": loop20["images_per_s"],
                "synthetic_steady_over_bare": loop20["steady_over_bare"],
                "synthetic_loop_over_bare": loop20["loop_over_bare"],
                "syncs_between_flushes": 0}
            log(json.dumps({"decoded_loop": out["loop"]}))
            del trainer, model
            torch.cuda.empty_cache()
            # (f) the train CLI on the tree
            out["cli"] = decoded_cli(cli, tmp, data, trees["cli_assets"],
                                     passets, _kernels, log, require)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[decoder] {card}: phase 24 {out['seconds']:.1f} s; loop "
        f"{out['loop']['images_per_s']:.1f} img/s, "
        f"{out['loop']['loop_over_bare']:.3f}x its bare step (steady "
        f"{out['loop']['steady_over_bare']:.3f}x; synthetic loop "
        f"{loop20['steady_over_bare']:.3f}x)")
    return out


def decoded_cli(cli, tmp, data, assets, passets, kernels, log,
                require) -> dict:
    """Phase 24 (f): `-c 14 -ve 1 -se 0` through `cli.main` on the tree
    (its split lists `assets`), full width, `num_viz` 0; its files, finite
    losses, the native batches (every stage-1 step and validation batch)
    and its log naming the native decoder."""
    import io
    import torch
    real_run = cli.run_experiment

    def run_no_viz(cfg, **kw):
        return real_run(cfg.replace(num_viz=0), **kw)

    argv = ["-c", "14", "-ve", "1", "-se", "0", "-n", "decoded", "-dir",
            data]
    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            buf.write(s)
            return sys.__stdout__.write(s)

        def fileno(self):
            return sys.__stdout__.fileno()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(cli, "run_experiment", run_no_viz), \
            mock.patch.object(passets, "_ASSETS_DIR", assets), \
            contextlib.redirect_stdout(Tee()):
        summary = cli.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    got = dict(kernels.launch_counts)
    log_dir = summary["log_dir"]
    for name in ("config.yaml", "counts.csv", "train_log.csv",
                 "val_log.csv", "checkpoint"):
        require(osp.isfile(osp.join(log_dir, name)),
                f"the train CLI on the tree did not write {name}")
    counts = csv_rows(osp.join(log_dir, "counts.csv"))[0]
    steps = csv_rows(osp.join(log_dir, "train_log.csv"))
    losses = [float(r[2]) for r in steps]
    n_s1, n_val = int(counts[0]), int(counts[2])
    require(len(steps) == n_s1 and all(np.isfinite(losses)),
            f"the train CLI on the tree: {len(steps)} steps, {losses}")
    require(got["native_batches"] == n_s1 + n_val
            and got["costail_fwd"] == n_s1,
            f"the train CLI on the tree: launches {got} for {n_s1} steps "
            f"and {n_val} validation batches")
    line = [x for x in buf.getvalue().splitlines() if "decoded by" in x]
    require(len(line) == 1 and "the native decoder" in line[0],
            f"the train CLI's log on its decoder: {line}")
    shutil.rmtree(log_dir)
    out = {"seconds": run_s, "counts": counts, "steps": n_s1,
           "val_batches": n_val, "native_batches": got["native_batches"],
           "losses": losses, "log_line": line[0]}
    log(f"[decoder] train CLI {' '.join(argv[:-2])}: {json.dumps(out)}")
    return out


REMAT_TIMED = 3                  # phase 25's timed steps a variant
REMAT_UNPRUNED_BATCHES = (TRAIN_BATCH, 16, 12, 8)  # (b): the first that fits
REMAT_GRAD_BAR = 1e-4            # fp32, TF32 off: phase 9's gradient bar
FETCHES_REFUSED: list = []       # the URLs `_no_network` refused


def _no_network(url, *a, **k):
    """urllib.request.urlretrieve in this script: it reaches no network.
    A fetch the train CLI tries (the VGG16 of a fresh real-data run) fails
    here, and the CLI warns and goes on; the URLs are kept."""
    FETCHES_REFUSED.append(url)
    raise OSError(f"chip_smoke.py reaches no network: {url}")


def phase_remat(dev, embed, tmp: str, log, require) -> dict:
    """Phase 25: rematerialized conv blocks (`remat`), overlapped
    checkpoint saves and the decoder's device.

    (a) one stage-1 step of full-width FCN-32s (config 14's 20-dim heads,
        bf16, fused block 1, pruned, 512x512, B=24, Adam lr 1e-5, dropout
        0.5 from a seeded CUDA generator) with `remat=True` beside the same
        step without it (the same weights, batch and generator seed): every
        parameter's gradient bit-equal, or else within the stage-1 bf16 bar
        (at most 2x as far from the fp32 step's as the plain step's); the
        same pair in fp32, TF32 off, at the gradient bar (relative norm <
        1e-4); each step's launches (remat: K3 2, K4 1, K5 1, K6 1), its
        time over REMAT_TIMED steps (CUDA events) and the peak memory over
        them, whole and less what was allocated before the model was built
        (earlier phases' tensors);
    (b) the same pair on the unpruned geometry (`prune_pad=False`) at the
        first batch of REMAT_UNPRUNED_BATCHES whose plain step fits: times,
        peaks;
    (c) FCN-8s: the remat step beside its plain step, gradients as in (a),
        times and peaks;
    (d) the train CLI `-c 14 --synthetic --remat` for one epoch of each
        stage and its resume (`cli_run_and_resume`);
    (e) the overlapped save of (a)'s remat model and Adam state: how long
        a routine `save_checkpoint` takes to return and its
        `finish_pending`, beside a blocking (best) save; the two files
        equal;
    (f) `build_info()["device"]` is this card's ordinal after an nvJPEG
        decode (phase 24's, then one more), and an ordinal the machine
        lacks raises.
    """
    import torch
    from zeroshotsemanticsegmentation_tpu_torch.data import native
    from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
    from zeroshotsemanticsegmentation_tpu_torch.models.fcn8s import FCN8s
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
    from zeroshotsemanticsegmentation_tpu_torch.train import (
        TrainState, make_fcn_optimizer, make_fcn_train_step)
    from zeroshotsemanticsegmentation_tpu_torch.train import checkpoint as ck

    t_phase = time.perf_counter()
    k_cls = embed.shape[0]
    step = make_fcn_train_step(loss_name="cos", num_classes=k_cls,
                               embeddings=embed)

    def batch_of(b):
        r = np.random.RandomState(25)
        return {"image": torch.from_numpy(
                    r.randn(b, H, W, 3).astype(np.float32) * 40).to(dev),
                "label": torch.from_numpy(
                    r.randint(-1, k_cls, (b, H, W)).astype(np.int32)).to(dev),
                "sizes": torch.full((b, 2), H, dtype=torch.int32, device=dev),
                "num_real": torch.tensor(b, device=dev)}

    def run(arch, dtype, remat, prune=True, b=TRAIN_BATCH, timed=0,
            then=None):
        """One step from seed-0 weights: its launches and fp32 gradients;
        then `timed` steps timed, with the peak memory over them, also
        less what was allocated before the model was built (earlier
        phases' and variants' tensors: `step_peak_gb`); then
        `then(model, state)`. Returns (record, gradients); the model and
        its state go with the call."""
        cls = FCN8s if arch == "fcn8s" else FCN32s
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        model = cls(20, dtype=dtype, fused_block1=True, prune_pad=prune,
                    remat=remat, generator=torch.Generator().manual_seed(0),
                    dropout_rate=0.5, device=dev)
        state = TrainState.create(model, make_fcn_optimizer(
            model, optim="adam", lr=1e-5))
        batch = batch_of(b)
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        _, aux = step(state, batch, gen)
        torch.cuda.synchronize()
        rec = {"arch": arch, "remat": remat, "pruned": prune, "batch": b,
               "dtype": str(dtype).replace("torch.", ""),
               "launches": {k: v for k, v in _kernels.launch_counts.items()
                            if v},
               "loss": aux["loss"].item()}
        grads = {n: p.grad.detach().float().clone()
                 for n, p in model.named_parameters() if p.grad is not None}
        if timed:
            torch.cuda.reset_peak_memory_stats()
            rec["ms"] = time_ms(lambda: step(state, batch, gen),
                                iters=timed, warmup=1)
            peak = torch.cuda.max_memory_allocated()
            rec["peak_gb"] = peak / 1e9
            rec["step_peak_gb"] = (peak - before) / 1e9
            rec["allocated_before_gb"] = before / 1e9
        require(np.isfinite(rec["loss"]), f"remat phase loss: {rec}")
        log(f"[remat] {json.dumps(rec)}")
        if then is not None:
            then(model, state)
        return rec, grads

    def held(tag, plain, remat, fp32_plain, fp32_remat) -> dict:
        """remat's gradients against the plain step's: bit-equal, or
        within the bf16 bar against fp32; fp32 at the gradient bar."""
        require(set(plain) == set(remat) == set(fp32_plain)
                == set(fp32_remat), f"{tag}: gradient sets differ")
        differ = [n for n in plain if not torch.equal(remat[n], plain[n])]
        bar = {n: {"remat": rel(remat[n], fp32_plain[n]),
                   "plain": rel(plain[n], fp32_plain[n])} for n in differ}
        misses = [n for n, r in bar.items() if not r["remat"] <= 2 * r["plain"]]
        require(not misses, f"{tag}: remat gradients more than 2x the plain "
                f"step's error vs fp32: {misses} {bar}")
        f32 = {n: rel(fp32_remat[n], fp32_plain[n]) for n in fp32_plain}
        worst = max(f32, key=f32.get)
        require(f32[worst] < REMAT_GRAD_BAR,
                f"{tag}: fp32 remat gradient {worst} rel {f32[worst]}")
        out = {"bf16_bit_equal": len(plain) - len(differ),
               "bf16_differ": differ, "bf16_bar": bar,
               "fp32_worst_rel": f32[worst], "fp32_worst": worst,
               "fp32_bit_equal": sum(torch.equal(fp32_remat[n],
                                                 fp32_plain[n])
                                     for n in fp32_plain)}
        log(f"[remat] {tag} gradients: {json.dumps(out)}")
        return out

    def remat_launches(rec, k3):
        want = {"block1_train_fwd": k3, "block1_train_bwd": 1 if k3 else 0,
                "costail_fwd": 1, "costail_bwd": 1}
        got = {k: rec["launches"].get(k, 0) for k in want}
        require(got == want and not rec["launches"].get("block1_fused")
                and not rec["launches"].get("pdot"),
                f"remat launches {rec['launches']}, expected {want}")

    out = {}
    bf, f32 = torch.bfloat16, torch.float32

    def overlapped_save(model, state):
        """(e): a routine save of `model` and its Adam state, its
        `finish_pending`, and a blocking (best) save of the same; the two
        files equal."""
        kw = dict(model_state=model.state_dict(),
                  optim_state=state.optimizer.state_dict(), epoch=1,
                  iteration=4, best_mean_iu=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save_checkpoint(osp.join(tmp, "routine"), is_best=False, **kw)
        ret_s = time.perf_counter() - t0
        in_flight = ck._pending is not None
        t0 = time.perf_counter()
        ck.finish_pending()
        fin_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ck.save_checkpoint(osp.join(tmp, "blocking"), is_best=True, **kw)
        block_s = time.perf_counter() - t0
        require(in_flight and ck._pending is None,
                "a routine save did not overlap, or a best save left one in "
                "flight")
        files = [torch.load(osp.join(tmp, d, "checkpoint"),
                            map_location="cpu", weights_only=True)
                 for d in ("routine", "blocking")]
        require(_nested_equal(files[0], files[1]),
                "the overlapped save's file differs from the blocking save's")
        gb = osp.getsize(osp.join(tmp, "routine", "checkpoint")) / 1e9
        out["save"] = {"routine_return_s": ret_s, "finish_pending_s": fin_s,
                       "blocking_s": block_s, "gb": gb}
        log(f"[remat] overlapped save: {json.dumps(out['save'])}")
        for d in ("routine", "blocking"):
            shutil.rmtree(osp.join(tmp, d))

    # (a) pruned FCN-32s; (e) on its remat model after the timed steps
    a_plain, g_plain = run("fcn32s", bf, False, timed=REMAT_TIMED)
    a_remat, g_remat = run("fcn32s", bf, True, timed=REMAT_TIMED,
                           then=overlapped_save)
    remat_launches(a_plain, 1)
    remat_launches(a_remat, 2)
    _, g32_plain = run("fcn32s", f32, False)
    _, g32_remat = run("fcn32s", f32, True)
    out["a"] = {"plain": a_plain, "remat": a_remat,
                "grads": held("pruned FCN-32s", g_plain, g_remat, g32_plain,
                              g32_remat)}
    del g_plain, g_remat, g32_plain, g32_remat

    # (b) the unpruned geometry: the first batch whose plain step fits
    for b in REMAT_UNPRUNED_BATCHES:
        try:
            b_plain, _ = run("fcn32s", bf, False, prune=False, b=b,
                             timed=REMAT_TIMED)
            break
        except torch.cuda.OutOfMemoryError:
            log(f"[remat] unpruned B={b}: out of memory without remat")
    else:
        fail(f"no unpruned batch of {REMAT_UNPRUNED_BATCHES} fits")
    b_remat, _ = run("fcn32s", bf, True, prune=False, b=b,
                     timed=REMAT_TIMED)
    remat_launches(b_plain, 0)
    remat_launches(b_remat, 0)
    out["b"] = {"plain": b_plain, "remat": b_remat, "batch": b}

    # (c) FCN-8s
    c_plain, g_plain = run("fcn8s", bf, False, timed=REMAT_TIMED)
    c_remat, g_remat = run("fcn8s", bf, True, timed=REMAT_TIMED)
    remat_launches(c_plain, 1)
    remat_launches(c_remat, 2)
    _, g32_plain = run("fcn8s", f32, False)
    _, g32_remat = run("fcn8s", f32, True)
    out["c"] = {"plain": c_plain, "remat": c_remat,
                "grads": held("FCN-8s", g_plain, g_remat, g32_plain,
                              g32_remat)}
    del g_plain, g_remat, g32_plain, g32_remat
    torch.cuda.empty_cache()

    # (d) the train CLI with --remat, and its resume
    d = cli_run_and_resume(tmp, "fcn32s", log, require, remat=True)
    out["d"] = {"cli": d["cli"], "resume": d["resume"]}
    os.remove(d["checkpoint"])

    # (f) the decoder's device
    nl = native.NativeLoader.get()
    ordinal = torch.cuda.current_device()
    info = nl.build_info()
    fx = load_script("torch_make_decode_fixtures")
    name = sorted(fx.SPECS)[0]
    path = osp.join(fx.FIXTURE_DIR, fx.load_record()[name]["file"])
    imgs, _, sizes = nl.load_batch([path], [None], (512, 512), compact=True,
                                   device=ordinal)
    again = nl.build_info()
    refused = False
    try:
        nl.set_device(torch.cuda.device_count())
    except RuntimeError:
        refused = True
    nvjpeg = info["jpeg"] == "nvjpeg"
    want = ordinal if nvjpeg else None
    require(info["device"] == want and again["device"] == want,
            f"the decoder's device: {info['device']} after phase 24, "
            f"{again['device']} after one more decode, want {want}")
    require(refused or not nvjpeg, "an ordinal the machine lacks was taken")
    require(int(sizes[0].prod()) > 0 and imgs.any(), "the decode is empty")
    out["f"] = {"jpeg": info["jpeg"], "device_after_phase24": info["device"],
                "device_after_decode": again["device"], "ordinal": ordinal,
                "missing_ordinal_refused": refused,
                "fetches_refused": list(FETCHES_REFUSED)}
    log(f"[remat] decoder device: {json.dumps(out['f'])}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[remat] phase 25: {out['seconds']:.1f} s")
    return out


PARITY_GEOMETRY = dict(batches=4, batch_size=8, size=512, train_steps=12)
CONTEXT59_SHAPES = ((375, 500), (333, 500), (17, 9), (1, 1))


def context59_checks(tmp: str, log, require) -> dict:
    """Phase 26 (b): scripts/torch_make_context59_labels.py on seeded
    fixtures (a labels.txt of the 59 names at scattered raw ids and extras,
    `.mat` LabelMaps written by scipy.io, compressed and not), through its
    CLI in a fresh process and through `convert` here with `import PIL`
    failing; each PNG read back through `NativeLoader.decode_label` and
    through `PascalContext(n_classes=59)`'s label path, equal pixel for
    pixel to the remap. Notes whether Pillow is importable here."""
    import scipy.io
    from zeroshotsemanticsegmentation_tpu_torch.data.assets import (
        CONTEXT59_CLASS_NAMES)
    from zeroshotsemanticsegmentation_tpu_torch.data.context import (
        PascalContext)
    from zeroshotsemanticsegmentation_tpu_torch.data.native import (
        NativeLoader)

    t0 = time.perf_counter()
    rng = np.random.RandomState(59)
    raw_ids = rng.permutation(np.arange(2, 460))[:59]
    lines = [f"{r}: {n}" for r, n in zip(raw_ids, CONTEXT59_CLASS_NAMES)]
    lines += ["1: somethingrare", "459: anotherextra"]
    labels_txt = osp.join(tmp, "labels.txt")
    with open(labels_txt, "w") as f:
        f.write("\n".join(lines) + "\n")
    mat_dir = osp.join(tmp, "trainval")
    os.makedirs(mat_dir)
    lut = np.zeros(460, np.int64)
    lut[raw_ids] = np.arange(1, 60)
    pool = np.concatenate([raw_ids, [0, 1, 459]])
    want = {}
    for i, (h, w) in enumerate(CONTEXT59_SHAPES):
        raw = pool[rng.randint(0, len(pool), (h, w))].astype(np.uint16)
        did = f"2008_{i:06d}"
        scipy.io.savemat(osp.join(mat_dir, f"{did}.mat"), {"LabelMap": raw},
                         do_compression=bool(i % 2))
        want[did] = lut[raw]
    root = osp.join(tmp, "data")
    out_dir = osp.join(root, "context", "59_context_labels")
    script = osp.join(ROOT, "scripts", "torch_make_context59_labels.py")
    cli = subprocess.run([sys.executable, script, "--labels-txt", labels_txt,
                          "--mat-dir", mat_dir, "--out-dir", out_dir],
                         capture_output=True, text=True, timeout=300)
    require(cli.returncode == 0, f"the context-59 tool's CLI failed: "
            f"{cli.stdout}{cli.stderr}")
    require(f"wrote {len(want)} 59-class" in cli.stdout,
            f"the context-59 tool's CLI said: {cli.stdout}")
    tool = load_script("torch_make_context59_labels")
    again = osp.join(tmp, "again")
    with without_pillow():
        n = tool.convert(labels_txt, mat_dir, again)
    require(n == len(want), f"convert wrote {n} PNGs for {len(want)} .mat")
    for did in want:
        with open(osp.join(out_dir, f"{did}.png"), "rb") as a, \
                open(osp.join(again, f"{did}.png"), "rb") as b:
            require(a.read() == b.read(), f"{did}: the CLI's PNG and "
                    "convert's differ")
    assets = osp.join(tmp, "assets")
    os.makedirs(osp.join(assets, "context"))
    with open(osp.join(assets, "context", "val.txt"), "w") as f:
        f.write("\n".join(sorted(want)) + "\n")
    nl = NativeLoader.get()
    with without_pillow():
        ds = PascalContext("val", data_dir=root, assets_dir=assets,
                           n_classes=59)
        require(ds.ids == sorted(want), f"PascalContext ids {ds.ids}")
        pixels = 0
        for did, remap in want.items():
            lbl, size = nl.decode_label(osp.join(out_dir, f"{did}.png"),
                                        remap.shape, map255_to_ignore=False)
            require(tuple(size) == remap.shape
                    and np.array_equal(lbl, remap),
                    f"{did}: the native decoder's pixels differ from the "
                    "remap")
            require(np.array_equal(ds._scan_label(did), remap - 1),
                    f"{did}: PascalContext(n_classes=59) reads other labels")
            pixels += remap.size
    pil = importlib.util.find_spec("PIL") is not None
    out = {"files": len(want), "pixels": pixels,
           "classes_present": int(len(np.unique(np.concatenate(
               [w.ravel() for w in want.values()])))),
           "pillow_importable": pil, "seconds": time.perf_counter() - t0}
    log(f"[context59] {json.dumps(out)}")
    return out


def phase_parity(dev, tmp: str, card: str, log, require) -> dict:
    """Phase 26: (a) scripts/torch_parity_evidence.py's bf16 drift at
    PARITY_GEOMETRY (12 trained bf16 steps through K3-K6, then serving
    through K2 + K1, through their plain versions and in fp32): the serving
    bf16 bar and the launch counts held; (b) the context-59 tool
    (`context59_checks`)."""
    import torch
    t0 = time.perf_counter()
    pe = load_script("torch_parity_evidence")
    r = pe.run_bf16(**PARITY_GEOMETRY, log=lambda m: log(f"[parity] {m}"),
                    device=str(dev))
    for msg in r["bar_failures"]:
        log(f"[parity] bar: {msg}")
    require(not r["bar_failures"], f"the bf16 drift misses its bar: "
            f"{r['bar_failures']}")
    log(f"[parity] {card}: flips vs fp32 kernels "
        f"{r['flip_rate_kernels']:.5f}, plain {r['flip_rate_plain']:.5f} "
        f"(ratio {r['flip_ratio']}) over {r['pixels']} pixels")
    for g, d in r["metrics"].items():
        log(f"[parity] {card}: {g} |delta| vs fp32 kernels "
            f"{d['abs_delta_kernels']}, plain {d['abs_delta_plain']}")
    torch.cuda.empty_cache()
    ctx = context59_checks(tmp, log, require)
    out = {"bf16": r, "context59": ctx,
           "seconds": time.perf_counter() - t0}
    log(f"[parity] phase 26: {out['seconds']:.1f} s")
    return out


BENCH_KERNELS = ("szn_fused", "block1_fused", "block1_train_fwd",
                 "block1_train_bwd", "costail_fwd", "costail_bwd")
GATE_TIMEOUT_S = 300


def phase_bench(dev, tmp: str, card: str, log, require) -> dict:
    """Phase 27: the measurement programs at their real shapes (the bench's
    three modes, the trained-gate and stage-2 benches), their launches,
    checksums, mfu and peak memory, with no host sync in a timed chain;
    then the ratchet in fresh processes on a temporary record directory."""
    import torch
    from zeroshotsemanticsegmentation_tpu_torch import bench
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels, dotpolicy
    t0 = time.perf_counter()
    tg = load_script("torch_bench_trained_gate")
    s2 = load_script("torch_bench_seenmask_step")
    # the timed chains' guard must be live on this torch: a fetch raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.ones(1, device=dev).item()
        guard_raises = False
    except RuntimeError:
        guard_raises = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require(guard_raises, "set_sync_debug_mode('error') let a fetch pass: "
            "the timed chains' sync check would prove nothing")
    programs = {"serving": bench.bench_inference, "train": bench.bench_train,
                "loop": bench.bench_train_loop, "trained_gate": tg.run,
                "stage2": s2.run}
    lines, launches, fc6, ring, seconds = {}, {}, {}, {}, {}
    dotpolicy.set_dot_free(False)
    try:
        for name, fn in programs.items():
            torch.cuda.empty_cache()
            _kernels.reset_launch_counts()
            t = time.perf_counter()
            try:
                lines[name] = fn(dev)
            except RuntimeError as e:
                fail(f"phase 27: the {name} program failed (a host sync in "
                     f"a timed chain raises): {e}")
            seconds[name] = time.perf_counter() - t
            launches[name] = {k: _kernels.launch_counts[k]
                              for k in BENCH_KERNELS}
            fc6[name] = _kernels.launch_counts["conv7x7_igemm"]
            ring[name] = {k: _kernels.launch_counts[k]
                          for k in ("ring_pad", "ring_sum")}
            log(json.dumps(lines[name]))
    finally:
        dotpolicy.set_dot_free(None)
    # K1-K6's launches in each program's warm and timed runs
    k3_k6 = dict.fromkeys(BENCH_KERNELS[2:], 0)
    want = {name: {**dict.fromkeys(BENCH_KERNELS, 0), **counts} for name,
            counts in (
                ("serving", {"szn_fused": 2 * bench.CHAIN,
                             "block1_fused": 2 * bench.CHAIN}),
                ("train", {k: 2 * bench.TRAIN_CHAIN for k in k3_k6}),
                ("loop", {k: 2 * bench.LOOP_BATCHES for k in k3_k6}),
                # pristine: one K1 pass a step; trained: two
                ("trained_gate", {"szn_fused": 2 * 3 * tg.CHAIN,
                                  "block1_fused": 2 * 2 * tg.CHAIN}),
                ("stage2", {"block1_fused": 2 * s2.CHAIN}))}
    require(launches == want, f"phase 27 launches {launches}, want {want}")
    # fc6's forward on its kernel once a trunk forward: as often as K2
    # serving, K3 training
    want_fc6 = {name: launches[name]["block1_train_fwd" if name in (
        "train", "loop") else "block1_fused"] for name in programs}
    require(fc6 == want_fc6, f"phase 27 fc6 launches {fc6}, want {want_fc6}")
    checksums = [lines[n]["checksum"]
                 for n in ("serving", "train", "loop", "stage2")]
    checksums += [lines["trained_gate"][k]
                  for k in ("checksum_pristine", "checksum_trained")]
    require(all(np.isfinite(c) and c != 0 for c in checksums),
            f"phase 27 checksums {checksums}")
    require(0 < lines["train"]["mfu"] < 1.05,
            f"stage-1 mfu {lines['train']['mfu']}")
    require(all(lines[n]["peak_gb"] > 0
                for n in ("serving", "train", "loop", "stage2")),
            "phase 27 peak memory")
    require(all(line["card"] == card for line in lines.values()),
            f"phase 27 card lines {[v['card'] for v in lines.values()]}")

    # the ratchet: a fresh process each, the bench in another under it
    gate = osp.join(ROOT, "scripts", "torch_bench_gate.py")
    rec_dir = osp.join(tmp, "records")
    record = osp.join(rec_dir, "record_serving.json")

    def run_gate():
        return subprocess.run([sys.executable, gate, "--record-dir", rec_dir],
                              capture_output=True, text=True, cwd=ROOT,
                              timeout=GATE_TIMEOUT_S)

    t = time.perf_counter()
    first = run_gate()
    require(first.returncode == 0 and osp.exists(record),
            f"the gate's first run (no record): rc {first.returncode}\n"
            f"{first.stdout}{first.stderr}")
    with open(record) as f:
        rec = json.load(f)
    second = run_gate()
    require(second.returncode == 0, f"the gate against its own record: rc "
            f"{second.returncode}\n{second.stdout}{second.stderr}")
    with open(record, "w") as f:
        json.dump(dict(rec, value=10 * rec["value"]), f)
    forged = run_gate()
    require(forged.returncode == 1 and "REGRESSION" in forged.stderr,
            f"the gate against a record forged at 10x: rc "
            f"{forged.returncode}\n{forged.stdout}{forged.stderr}")
    seconds["gate"] = time.perf_counter() - t
    out = {"lines": lines, "launches": launches, "launches_fc6": fc6,
           "launches_ring": ring, "seconds": seconds,
           "gate": {"record_mp_s": rec["value"],
                    "rcs": [first.returncode, second.returncode,
                            forged.returncode]},
           "phase_seconds": time.perf_counter() - t0}
    log(f"[bench] {card}: serving {lines['serving']['value']:.2f} MP/s, "
        f"stage 1 {lines['train']['value']:.2f} img/s (mfu "
        f"{lines['train']['mfu']:.4f}), loop {lines['loop']['value']:.2f} "
        f"img/s, trained gate {lines['trained_gate']['trained_over_pristine']:.4f}"
        f"x pristine, stage 2 {lines['stage2']['step_ms']:.2f} ms a step; "
        f"gate rcs {out['gate']['rcs']}; phase 27 "
        f"{out['phase_seconds']:.1f} s")
    return out


FC6_BATCHES = (16, 24)   # phase 28: fc6 at serving's and training's batch
FC6_SHAPE = (512, 23, 23, 4096, 7)   # Cin, IH, IW, Cout, kernel (512x512)


def phase_fc6(dev, kernels, log, require) -> dict:
    """Phase 28: fc6's implicit-GEMM forward (`conv7x7_igemm`) alone at
    B=16 (serving) and B=24 (training), bf16: one launch a call, two calls
    bit-equal, every output within one bf16 ulp (2^-8 |ref|) plus 2^-13 of
    the output's scale of the exact (fp64) product, and its relative error
    norm at most 1.01x cuDNN's bf16 output's (tests/test_torch_cuda.py's
    bars); its time (CUDA events, device time) beside
    its bound (operations at the bf16 peak), cuDNN's bf16 F.conv2d and
    torch.matmul over the materialised bf16 patch matrix (the product
    alone)."""
    import torch
    import torch.nn.functional as F
    from zeroshotsemanticsegmentation_tpu_torch.ops import conv7x7 as c7
    t0 = time.perf_counter()
    ci, ih, iw, co, k = FC6_SHAPE
    rows = []
    for batch in FC6_BATCHES:
        gen = torch.Generator(device=dev).manual_seed(batch)
        x = torch.randn(batch, ih, iw, ci, device=dev, generator=gen).to(
            torch.bfloat16).permute(0, 3, 1, 2)
        w = (torch.randn(co, ci, k, k, device=dev, generator=gen)
             / (ci * k * k) ** 0.5).to(torch.bfloat16)
        wp = c7.pack_weight(w, torch.bfloat16)
        require(c7.igemm_route(x, co), "fc6's shape is off the kernel's route")
        kernels.reset_launch_counts()
        y = c7.conv7x7_igemm(x, wp)
        again = c7.conv7x7_igemm(x, wp)
        torch.cuda.synchronize()
        launched = kernels.launch_counts["conv7x7_igemm"]
        km = wp.permute(0, 2, 3, 1).reshape(co, -1)   # a view
        ref = (c7.patches(x.double(), k, k) @ km.double().t()).view(
            batch, ih - k + 1, iw - k + 1, co).permute(0, 3, 1, 2)
        lib = F.conv2d(x, w)
        bar = 2.0 ** -8 * ref.abs() + 2.0 ** -13 * ref.abs().max()
        ulp_misses = int(((y.double() - ref).abs() > bar).sum().item())
        bit_equal = torch.equal(y, again)
        m = batch * (ih - k + 1) * (iw - k + 1)
        flops = 2.0 * m * co * ci * k * k
        b_ms, b_by = bound((x.numel() + wp.numel() + y.numel()) * 2, flops,
                           PEAK_BF16_FLOP_S)
        row = {"batch": batch, "shape": [batch, ci, ih, iw, co, k], "m": m,
               "launches_two_calls": launched, "bit_equal": bit_equal,
               "ulp_misses": ulp_misses, "rel_vs_fp32": rel(y, ref),
               "cudnn_rel_vs_fp32": rel(lib, ref), "bound_ms": b_ms,
               "bound_by": b_by}
        del y, again, ref, lib, bar

        def kern():
            return c7.conv7x7_igemm(x, wp)

        def cudnn():
            return F.conv2d(x, w)

        row["ms"] = time_ms(kern, 10)
        row["device_ms"] = device_ms(kern, 10, "conv7x7_igemm")
        row["bound_share"] = b_ms / row["device_ms"]
        row["library_ms"] = time_ms(cudnn, 3)
        row["library_device_ms"] = device_ms(cudnn, 3)
        cols = c7.patches(x, k, k)   # (M, 49 * 512) bf16
        km = km.t()
        row["patch_matrix_gb"] = cols.numel() * 2 / 1e9
        row["patch_matmul_ms"] = time_ms(lambda: torch.matmul(cols, km), 10)
        row["patch_matmul_device_ms"] = device_ms(
            lambda: torch.matmul(cols, km), 10)
        del cols, km, x, w, wp
        torch.cuda.empty_cache()
        log(f"[fc6] B={batch}: conv7x7_igemm "
            f"{row['ms']:.4f} ms, device {row['device_ms']:.4f} "
            f"({100 * row['bound_share']:.2f}% of its {b_ms:.4f}-ms bound, "
            f"{b_by}); cuDNN {row['library_ms']:.3f} (device "
            f"{row['library_device_ms']:.3f}); torch.matmul over the "
            f"{row['patch_matrix_gb']:.3f}-GB patch matrix "
            f"{row['patch_matmul_ms']:.4f} (device "
            f"{row['patch_matmul_device_ms']:.4f}); rel vs fp32 "
            f"{row['rel_vs_fp32']:.4e} (cuDNN bf16 "
            f"{row['cudnn_rel_vs_fp32']:.4e}), ulp misses {ulp_misses}, "
            f"two calls bit-equal {bit_equal}, launches {launched}")
        require(launched == 2, f"fc6: {launched} launches in two calls")
        require(bit_equal, f"fc6 B={batch}: two calls differ")
        require(ulp_misses == 0, f"fc6 B={batch}: {ulp_misses} outputs "
                "more than one bf16 ulp from the exact product")
        require(row["rel_vs_fp32"] <= 1.01 * row["cudnn_rel_vs_fp32"],
                f"fc6 B={batch}: rel {row['rel_vs_fp32']} vs cuDNN's "
                f"{row['cudnn_rel_vs_fp32']}")
        rows.append(row)
    out = {"rows": rows, "seconds": time.perf_counter() - t0}
    log(f"[fc6] phase 28: {out['seconds']:.1f} s")
    return out


DEEPLAB_BATCH = 16
# VOC's sides: the long side 500, the short 281-500, half portrait
DEEPLAB_SIZES = [(375, 500), (500, 333), (333, 500), (500, 375),
                 (281, 500), (500, 500), (400, 500), (500, 300)] * 2


def phase_deeplab(dev, kernels, embed, flip_rate, log, require) -> dict:
    """29. DeepLab-v2 ResNet-101 served at B=16, and K1 at x8 alone (see
    the module docstring)."""
    import torch
    from benchmark import bounds
    from zeroshotsemanticsegmentation_tpu_torch.cli.predict import (
        predict_arrays)
    from zeroshotsemanticsegmentation_tpu_torch.models import (
        DeepLabV2ResNet101)
    from zeroshotsemanticsegmentation_tpu_torch.ops import szn_fused as sz
    from zeroshotsemanticsegmentation_tpu_torch.ops.metrics import (
        unseen_mask_vector)
    from zeroshotsemanticsegmentation_tpu_torch.serving import (
        make_szn_predictor)
    t0 = time.perf_counter()
    geo = DeepLabV2ResNet101.UPSAMPLE
    model = DeepLabV2ResNet101(
        embed.shape[1], dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(29), device=dev).eval()
    pred = make_szn_predictor(model, None, embed, UNSEEN,
                              upscore_trained=False, device=dev)
    rng = np.random.RandomState(29)
    images = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
              for h, w in DEEPLAB_SIZES]

    def serve():
        return predict_arrays(pred, images, bucket=(H, W),
                              batch_size=DEEPLAB_BATCH)

    serve()  # folds the batch norms, picks cuDNN's plans
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    requests = 4
    t = time.perf_counter()
    for _ in range(requests):
        labels = serve()
    request_ms = 1e3 * (time.perf_counter() - t) / requests
    launched = dict(kernels.launch_counts)
    log(f"[deeplab] B={DEEPLAB_BATCH} {H}x{W} bucket through predict_arrays:"
        f" {request_ms:.2f} ms a request, "
        f"{DEEPLAB_BATCH * H * W / request_ms / 1e3:.1f} Mpx/s computed; "
        f"over {requests} requests K1 {launched['szn_fused']}, batch-norm "
        f"folds {launched['bn_folds']}")
    require(launched["szn_fused"] == requests,
            f"DeepLab serving: K1 {launched['szn_fused']} launches in "
            f"{requests} requests")
    require(launched["bn_folds"] == 0,
            f"DeepLab serving folded batch norm {launched['bn_folds']} "
            "times after the first request")
    require([lb.shape for lb in labels] == DEEPLAB_SIZES
            and all(0 <= lb.min() and lb.max() < embed.shape[0]
                    for lb in labels), "DeepLab serving: labels malformed")
    batch = np.zeros((DEEPLAB_BATCH, H, W, 3), np.uint8)
    for j, img in enumerate(images):
        batch[j, :img.shape[0], :img.shape[1]] = img
    batch = torch.from_numpy(batch)
    got = pred(batch)
    with mock.patch.object(sz, "szn_labels", sz.szn_labels_plain):
        want = pred(batch)
    serve_flips = flip_rate(got, want)
    log(f"[deeplab] served labels, K1 vs its plain version on the model's "
        f"heads: flip rate {serve_flips:.3e}")
    require(serve_flips < 1e-4, f"DeepLab K1 flip rate {serve_flips}")
    del model, pred, got, want, batch
    torch.cuda.empty_cache()

    # K1 alone at x8
    uv = unseen_mask_vector(embed.shape[0], UNSEEN)
    h8 = w8 = H // geo[0]
    score = torch.randn(DEEPLAB_BATCH, h8, w8, embed.shape[1], device=dev)
    gate = torch.randn(DEEPLAB_BATCH, h8, w8, device=dev)
    aug = sz._aug(score, gate, sz._embed_scaled(embed, dev))
    parts = sz._partition(~uv, uv)
    kp1 = aug.shape[-1]

    def k1():
        return sz.szn_labels(aug, *parts, H, W, None, geo)

    kernels.reset_launch_counts()
    got, again = k1(), k1()
    k1_launches = kernels.launch_counts["szn_fused"]
    want = sz.szn_labels_plain(aug, *parts, H, W, None, geo)
    flips = flip_rate(got, want)
    require(k1_launches == 2, f"K1 x8: {k1_launches} launches in two calls")
    require(torch.equal(got, again), "K1 x8: two calls differ")
    require(flips < 1e-4, f"K1 x8 flip rate {flips}")
    row = {"ms": time_ms(k1, iters=20),
           "device_ms": device_ms(k1, 20, "szn_labels"),
           "plain_ms": time_ms(
               lambda: sz.szn_labels_plain(aug, *parts, H, W, None, geo), 3)}
    nbytes = aug.numel() * 4 + DEEPLAB_BATCH * H * W * 4
    b_s = bounds.k1_bound_s(DEEPLAB_BATCH, h8, w8, kp1, H, W)
    row.update(bound_ms=1e3 * b_s, bound_by=(
        "bytes" if b_s == nbytes / bounds.PEAK_BYTES_S else "operations"),
        flip_rate=flips, launches=k1_launches,
        shape=[DEEPLAB_BATCH, h8, w8, kp1, H, W], geometry=list(geo))
    log(f"[deeplab] K1 x8 B={DEEPLAB_BATCH} {h8}x{w8} -> {H}x{W} "
        f"K+1={kp1}: {row['ms']:.4f} ms by events, {row['device_ms']:.4f} "
        f"device; bound {row['bound_ms']:.4f} ({row['bound_by']}, "
        f"{row['bound_ms'] / row['device_ms']:.1%} of it reached); plain "
        f"{row['plain_ms']:.3f}; flip rate {flips:.3e}")
    out = {"request_ms": request_ms, "launches": launched,
           "serve_flip_rate": serve_flips, "k1": row,
           "seconds": time.perf_counter() - t0}
    log(f"[deeplab] phase 29: {out['seconds']:.1f} s")
    return out


RINGPAD_BATCHES = (16, 64)   # phase 30: serving's batches
RINGPAD_TRAIN_BATCH = 24     # ring_sum at stage 1's


def ringpad_geometry(dev) -> list:
    """The (C, h, w, (top, bottom, left, right)) of every pad of an FCN-32s
    forward at the 512 bucket (fused block 1, so blocks 2-4's), read from
    `run_pruned_blocks` at VGG16's widths on one zero image."""
    import torch
    from zeroshotsemanticsegmentation_tpu_torch.models import pruned
    widths = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512))
    kbs, cin = [], 3
    for blk in widths:
        kbs.append([])
        for co in blk:
            kbs[-1].append((torch.zeros(co, cin, 3, 3, device=dev),
                            torch.zeros(co, device=dev)))
            cin = co
    seen = []
    real = pruned._padc

    def spy(a, c, *pads):
        seen.append((a.shape[1], a.shape[2], a.shape[3], tuple(pads)))
        return real(a, c, *pads)

    with mock.patch.object(pruned, "_padc", spy), torch.no_grad():
        pruned.run_pruned_blocks(
            kbs, torch.zeros(1, H, W, 3, device=dev), 100, torch.bfloat16,
            fused_block1=True)
    return seen


def phase_ring_pad(dev, kernels, log, require) -> dict:
    """Phase 30: the ring pads alone (`ops.ring_pad`, `csrc/ring_pad.cu`),
    bf16, at the pads of an FCN-32s forward at the 512 bucket
    (`ringpad_geometry`), B=16 and 64: one launch a pad, each pad bit-equal
    to its plain version; the forward's pads in a row by CUDA events and
    device time beside their bound (each input byte read once, each output
    byte written once, at 3.35 TB/s) and the plain version's time (the two
    concatenations and the channels_last copy); each pad's device time; then
    `ring_sum` over the same pads' gradients at stage 1's B=24, each sum
    against `ring_sum_plain`'s fp32 sum (bf16's rounding plus 1e-5 of the
    ring's sum of magnitudes)."""
    import torch
    from zeroshotsemanticsegmentation_tpu_torch.ops import ring_pad as rp
    t0 = time.perf_counter()
    geometry = ringpad_geometry(dev)
    require(len(geometry) == 10, f"FCN-32s's pads at {H}: {geometry}")
    out = {"geometry": geometry, "rows": []}
    gen = torch.Generator(device=dev).manual_seed(30)
    for batch in RINGPAD_BATCHES:
        ins = [(torch.randn(batch, h, w, ch, device=dev, generator=gen).to(
            torch.bfloat16).permute(0, 3, 1, 2),
            torch.randn(ch, device=dev, generator=gen).to(torch.bfloat16),
            pads) for ch, h, w, pads in geometry]
        nbytes = sum(2 * a.numel() + 2 * a.shape[0] * a.shape[1]
                     * (a.shape[2] + p[0] + p[1]) * (a.shape[3] + p[2] + p[3])
                     for a, _, p in ins)
        kernels.reset_launch_counts()
        equal = all(torch.equal(rp.ring_pad(a, c, *p),
                                rp.ring_pad_plain(a, c, *p))
                    for a, c, p in ins)
        launched = kernels.launch_counts["ring_pad"]
        require(launched == len(ins), f"ring_pad: {launched} launches for "
                f"{len(ins)} pads")
        require(equal, f"ring_pad B={batch}: a pad differs from its plain "
                "version")

        def pads_kernel():
            for a, c, p in ins:
                rp.ring_pad(a, c, *p)

        def pads_plain():
            for a, c, p in ins:
                rp.ring_pad_plain(a, c, *p)

        b_ms, b_by = bound(nbytes, 0, PEAK_BF16_FLOP_S)
        row = {"batch": batch, "gb_moved": nbytes / 1e9, "bound_ms": b_ms,
               "bound_by": b_by, "ms": time_ms(pads_kernel, 10),
               "plain_ms": time_ms(pads_plain, 3)}
        # pad by pad: `device_ms` scales a kernel's mean by its launches a
        # call, which mixes the ten sizes when the profiler drops a record
        row["per_pad_device_ms"] = [
            device_ms(lambda a=a, c=c, p=p: rp.ring_pad(a, c, *p), 5,
                      "ring_pad_kernel") for a, c, p in ins]
        row["device_ms"] = sum(row["per_pad_device_ms"])
        row["bound_share"] = b_ms / row["device_ms"]
        log(f"[ring_pad] B={batch}: {len(ins)} pads, "
            f"{row['gb_moved']:.3f} GB moved: {row['ms']:.4f} ms by "
            f"events, device {row['device_ms']:.4f} "
            f"({100 * row['bound_share']:.2f}% of its {b_ms:.4f}-ms bound, "
            f"{b_by}); plain {row['plain_ms']:.3f} ms; per pad device "
            + ", ".join(f"{t:.4f}" for t in row["per_pad_device_ms"]))
        out["rows"].append(row)
        del ins
        torch.cuda.empty_cache()
    grads = [torch.randn(RINGPAD_TRAIN_BATCH, h + p[0] + p[1],
                         w + p[2] + p[3], ch, device=dev,
                         generator=gen).to(torch.bfloat16).permute(0, 3, 1, 2)
             for ch, h, w, p in geometry]

    def sums():
        return [rp.ring_sum(g, *p) for g, (_, _, _, p) in zip(grads, geometry)]

    kernels.reset_launch_counts()
    got = sums()
    require(kernels.launch_counts["ring_sum"] == len(grads),
            f"ring_sum: {kernels.launch_counts['ring_sum']} launches")
    # each pad's sum vs the plain version's fp32 sum of the same gradient:
    # within bf16's rounding (2^-8 of the sum) plus 1e-5 of the sum of
    # magnitudes over the ring (another order of fp32 additions)
    worst = 0.0
    for s_, g, (_, _, _, p) in zip(got, grads, geometry):
        want = rp.ring_sum_plain(g.float(), *p).double()
        scale = rp.ring_sum_plain(g.float().abs(), *p).double()
        err = (s_.double() - want).abs()
        bar = 2.0 ** -8 * want.abs() + 1e-5 * scale
        worst = max(worst, (err / bar).max().item())
    require(worst <= 1, f"ring_sum B={RINGPAD_TRAIN_BATCH}: off its plain "
            f"version by {worst:.3f} of the bar")
    out["ring_sum"] = {"batch": RINGPAD_TRAIN_BATCH,
                       "err_over_bar": worst, "ms": time_ms(sums, 10),
                       "device_ms": sum(
                           device_ms(lambda g=g, p=p: rp.ring_sum(g, *p), 5,
                                     "ring_sum")
                           for g, (_, _, _, p) in zip(grads, geometry))}
    log(f"[ring_pad] ring_sum B={RINGPAD_TRAIN_BATCH}, the {len(grads)} "
        f"pads: {out['ring_sum']['ms']:.4f} ms by events, device "
        f"{out['ring_sum']['device_ms']:.4f}; off the plain sums by "
        f"{worst:.4f} of the bar")
    del grads
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"[ring_pad] phase 30: {out['seconds']:.1f} s")
    return out


RING_KEYS = ("block1_fused", "block1_train_fwd", "block1_train_bwd",
             "ring_pad", "ring_sum")


def ring_launches(helpers: dict, parity: dict) -> dict:
    """K2, K3, K4, `ring_pad` and `ring_sum`'s launches on each path of
    phases 21-27: `helpers` maps a phase to its one-kernel launch function
    (a tree of counts by path), `parity` is phase 26's counts by part.
    Keyed by the path through the tree ("21/launches_int8_serve", ...)."""

    def leaves(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, tree

    table = {}
    for phase, fn in helpers.items():
        by_key = {k: dict(leaves(fn(k), phase)) for k in RING_KEYS}
        for path in by_key["ring_pad"]:
            table[path] = {k: by_key[k][path] for k in RING_KEYS}
    for part, counts in parity.items():
        table[f"26/{part}"] = {k: counts.get(k, 0) for k in RING_KEYS}
    return table


def main() -> None:
    try:
        import torch
        import torch.nn.functional as F
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    import urllib.request
    urllib.request.urlretrieve = _no_network
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
        from zeroshotsemanticsegmentation_tpu_torch.ops import conv7x7 as c7
        from zeroshotsemanticsegmentation_tpu_torch.ops import dotpolicy
        from zeroshotsemanticsegmentation_tpu_torch.ops import pdot as pd
        from zeroshotsemanticsegmentation_tpu_torch.ops import ring_pad as rp
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
    fc6_build = kernel_build_stats(_kernels, "conv7x7_igemm",
                                   ("conv7x7_igemm",))
    rp_build = kernel_build_stats(_kernels, "ring_pad", (
        "ring_pad_kernel", "ring_sum_partial", "ring_sum_finish"))
    for lib, built in (("block1_train", b1_build), ("block1_fused", k2_build),
                       ("pdot", k7_build), ("costail_fused", k56_build),
                       ("szn_fused", k1_build), ("conv1_1", k8_build),
                       ("conv7x7_igemm", fc6_build), ("ring_pad", rp_build)):
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
                        "pdot_narrow<24>")),
            (fc6_build, ("conv7x7_igemm",))):
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
        """Routes the predictor through the kernels' plain versions (fc6's
        forward through F.conv2d, the ring pads through the
        concatenations)."""
        with mock.patch.object(sz, "szn_labels", sz.szn_labels_plain), \
                mock.patch.object(b1, "block1_op", b1.block1_plain), \
                fc6_on_conv2d(), ring_pads_plain():
            yield

    @contextlib.contextmanager
    def ring_pads_plain():
        """Routes the ring pads through their plain version (the
        concatenations and autograd) in place of `ring_pad` / `ring_sum`."""
        with mock.patch.object(rp, "kernel_takes", lambda a: False):
            yield

    @contextlib.contextmanager
    def fc6_on_conv2d():
        """Routes fc6's forward through F.conv2d, off its kernel."""
        with mock.patch.object(c7, "igemm_route",
                               lambda h, cout: False):
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
        """Routes the train step through K3-K6's plain versions and the
        ring pads': the training form of block 1 with plain conv2_pool,
        the fused tail's plain version, the pads' concatenations."""
        with plain_block1_training(), ring_pads_plain(), mock.patch.object(
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
    require(launches["szn_fused"] > 0 and launches["block1_fused"] > 0
            and launches["conv7x7_igemm"] > 0 and launches["ring_pad"] > 0,
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
    require(sbar["block1_fused_launches"] > 0
            and sbar["conv7x7_igemm_launches"] > 0,
            f"the serving bar's kernel run did not launch K2 and fc6: {sbar}")
    require(sbar["flip_kernels"] <= 2 * sbar["flip_plain"],
            f"bf16 serving flips {sbar['flip_kernels']} vs fp32, more than "
            f"2x the plain run's {sbar['flip_plain']}")

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
    require(tlaunches["conv7x7_igemm"] == TRAIN_STEPS,
            f"fc6's forward not once a step on its kernel: {tlaunches}")
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
    # kernels and in bf16 with K3/K4 through their plain versions and fc6's
    # forward on F.conv2d, each parameter's gradient against the fp32
    # step's (TF32 off); the kernels may be at most 2x as far from fp32 as
    # the plain versions, parameter by parameter
    _, grads_bk = b2_step(torch.bfloat16, contextlib.nullcontext())
    with fc6_on_conv2d():
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
    pdot_rows, f32_rows = phase_pdot(dev, pd, _kernels, log, require)

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
        # one fp32 step at B=2, dot-free (K7's fp32 route, counted from 0)
        # vs default (cuBLAS, cuDNN)
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        aux_d, grads_d = fp32_step(False)
        torch.cuda.synchronize()
        f32_launches = {key: n for key, n in _kernels.launch_counts.items()
                        if key.startswith("pdot")}
        dotpolicy.set_dot_free(False)
        aux_c, grads_c = fp32_step(False)
    finally:
        dotpolicy.set_dot_free(None)
    torch.cuda.synchronize()
    log(f"[dot-free] K7 launches in the fp32 B=2 step: {f32_launches}")
    # fc6's input gradient and fc7's weight gradient on the wide fp32 tile,
    # score_fr's weight gradient (N = 20) on the narrow one
    require(f32_launches["pdot"] == 3 and f32_launches["pdot"] == sum(
        f32_launches[key] for key in F32_COUNTS),
            f"K7's fp32 route in the fp32 dot-free step: {f32_launches}")
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
    # the fp32 B=2 step's time in each mode, in turns, one state a mode
    f32_states = {}
    for mode in (False, True):
        mdl = train_model(torch.float32, seed=1)
        f32_states[mode] = (TrainState.create(mdl, make_fcn_optimizer(
            mdl, optim="adam", lr=1e-5)),
            torch.Generator(device=dev).manual_seed(1))
    b2_batch = train_batch(2, 1)
    f32_step_ms = {"default": [], "dot_free": []}
    try:
        for mode in (True, False, False, True):
            dotpolicy.set_dot_free(mode)
            st, gen = f32_states[mode]
            f32_step_ms["dot_free" if mode else "default"].append(time_ms(
                lambda: step(st, b2_batch, gen), iters=3, warmup=1))
    finally:
        dotpolicy.set_dot_free(None)
    del f32_states, b2_batch, st, gen, mdl
    log(f"[dot-free] fp32 B=2 step, ms in turns (dot-free, default, "
        f"default, dot-free): dot-free {f32_step_ms['dot_free']}, default "
        f"{f32_step_ms['default']}")

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
    log(json.dumps({"pdot": pdot_rows, "pdot_fp32": f32_rows}))
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

    with tempfile.TemporaryDirectory() as tmp:
        # ---- 20. the train CLI on the card --------------------------------
        tcli = phase_train_cli(dev, embed, img_s, tmp, log, require)
        cli_launches = tcli["launches"]

        # ---- 21. FCN-8s, the predict and export CLIs, int8 serving --------
        p21 = phase_fcn8s_int8(dev, embed, ms, tcli["checkpoint"], tmp,
                               train_batch, plain_training, flip_rate, log,
                               require)

        # ---- 22. multi-device -----------------------------------------------
        torch.cuda.empty_cache()
        p22 = phase_mesh(dev, tcli["checkpoint"], tmp, card, log, require)

    # ---- 23. height-sharded serving, int8 serving on a mesh -----------------
    torch.cuda.empty_cache()
    p23 = phase_spatial(dev, card, log, require)
    l21 = p21["launches"]

    # ---- 24. the native decoder: fixtures, the loop and the CLI ------------
    torch.cuda.empty_cache()
    p24 = phase_decoder(dev, embed, tcli["loop"], card, log, require)

    # ---- 25. remat, overlapped saves, the decoder's device -----------------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        p25 = phase_remat(dev, embed, tmp, log, require)

    # ---- 26. the bf16 drift on trained weights, the context-59 tool ------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        p26 = phase_parity(dev, tmp, card, log, require)
    l26 = p26["bf16"]["launches"]

    # ---- 27. the measurement programs and the ratchet --------------------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        p27 = phase_bench(dev, tmp, card, log, require)

    # ---- 28. fc6's implicit-GEMM forward alone ----------------------------
    torch.cuda.empty_cache()
    p28 = phase_fc6(dev, _kernels, log, require)

    # ---- 29. DeepLab-v2 ResNet-101 served, K1 at x8 ------------------------
    torch.cuda.empty_cache()
    p29 = phase_deeplab(dev, _kernels, embed, flip_rate, log, require)

    # ---- 30. the ring pads alone ------------------------------------------
    torch.cuda.empty_cache()
    p30 = phase_ring_pad(dev, _kernels, log, require)

    def launches27(key: str) -> dict:
        """One kernel's launches on phase 27's programs (warm and timed
        runs)."""
        return {"launches_bench": {
            name: {**counts, **p27["launches_ring"][name]}[key]
            for name, counts in p27["launches"].items()}}

    def launches26(key: str) -> dict:
        """One kernel's launches on phase 26's drift study: its training
        steps (K3-K6) or its kernels' serving run (K1, K2)."""
        part = "serve_kernels" if key in l26["serve_kernels"] else "train"
        return {"launches_parity": l26[part][key]}

    def launches25(key: str) -> dict:
        """One kernel's launches on phase 25's remat paths: one step of
        each variant (plain, remat), and the train CLI's run with --remat
        and its resume (K1 and K2 in their validations)."""
        return {"launches_remat": {
            "stage1_pruned": [p25["a"][v]["launches"].get(key, 0)
                              for v in ("plain", "remat")],
            "stage1_unpruned": [p25["b"][v]["launches"].get(key, 0)
                                for v in ("plain", "remat")],
            "fcn8s": [p25["c"][v]["launches"].get(key, 0)
                      for v in ("plain", "remat")],
            "train_cli": p25["d"]["cli"]["launches"].get(key, 0),
            "train_cli_resume": p25["d"]["resume"]["launches"].get(key, 0)}}

    def launches22(key: str) -> dict:
        """One kernel's launches on phase 22's paths: (a) the world-1 NCCL
        mesh's three steps, (b) each two-rank path by rank, (c) each rank's
        two-rank CLI run."""
        return {"launches_mesh": {
            "world1_nccl": p22["a"]["launches"].get(key, 0),
            "two_ranks_gloo": {str(r): {path: c.get(key, 0)
                                        for path, c in paths.items()}
                               for r, paths in p22["b"]["launches"].items()},
            "two_rank_cli": [c.get(key, 0)
                             for c in p22["c"]["launches_first"]]}}

    def launches23(key: str) -> dict:
        """One kernel's launches on phase 23's paths: (a) one spatial call
        on the world-1 NCCL mesh in fp32 and in bf16, (b) and (c) each
        two-rank path by rank."""
        return {"launches_spatial": {
            "world1_nccl": [p23["a"]["launches_fp32"].get(key, 0),
                            p23["a"]["launches_bf16"].get(key, 0)],
            "two_ranks_gloo": {str(r): {path: c.get(key, 0)
                                        for path, c in paths.items()}
                               for r, paths in p23["b"]["launches"].items()}}}

    def launches21(key: str) -> dict:
        """One kernel's launches on phase 21's paths."""
        return {f"launches_{path}": counts[key]
                for path, counts in l21.items()}

    ring = ring_launches(
        {"21": launches21, "22": launches22, "23": launches23,
         "25": launches25, "27": launches27}, l26)
    log("[ring_pad] phases 21-27 (K2 + K3 / K4 / ring_pad / ring_sum): "
        + "; ".join(f"{path} {n['block1_fused'] + n['block1_train_fwd']}"
                    f"/{n['block1_train_bwd']}/{n['ring_pad']}"
                    f"/{n['ring_sum']}" for path, n in ring.items()))
    missed = [path for path, n in ring.items()
              if (n["block1_fused"] or n["block1_train_fwd"]
                  or "int8" in path) and not n["ring_pad"]
              or n["block1_train_bwd"] and not n["ring_sum"]]
    require(not missed, f"the ring pads missed their kernels on {missed}")

    src = "zeroshotsemanticsegmentation_tpu_torch/csrc/"
    ref = "zeroshotsemanticsegmentation_tpu/ops/"
    kernels = [
        {"name": "szn_fused_labels", "route": "cuda",
         "source": src + "szn_fused.cu",
         "replaces": ref + "szn_fused.py:44",
         "launches": launches["szn_fused"],
         "launches_train_cli": cli_launches["szn_fused"],
         **launches21("szn_fused"), **launches22("szn_fused"),
         **launches23("szn_fused"), **launches25("szn_fused"),
         **launches26("szn_fused"),
         **launches27("szn_fused"),
         "band": p23["k1_band"],
         "launches_eval": evals["k1_launches"], "max_abs_err": k1_maxerr,
         "flip_rate": k1_flips, "flip_rate_k33": k33_flips,
         "flip_rate_ties": tie_flips, "ms": k1_ms,
         "device_ms": k1_device_ms, "plain_ms": k1_plain_ms,
         "device_ms_nne": k1_nne_device_ms,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "shape": [SERVE_BATCH, 17, 17, kp1, H, W], "build": k1_build},
        {"name": "szn_fused_labels (x8, DeepLab-v2)", "route": "cuda",
         "source": src + "szn_fused.cu",
         "replaces": ref + "szn_fused.py:44",
         "launches": p29["k1"]["launches"],
         "launches_deeplab_serving": p29["launches"]["szn_fused"],
         "flip_rate": p29["k1"]["flip_rate"],
         "flip_rate_serving": p29["serve_flip_rate"],
         **{k: p29["k1"][k] for k in ("ms", "device_ms", "plain_ms",
                                      "bound_ms", "bound_by", "shape",
                                      "geometry")},
         "library_ms": None, "build": k1_build},
        {"name": "block1_fused_forward", "route": "cuda",
         "source": src + "block1_fused.cu",
         "replaces": ref + "block1_fused.py:485",
         "launches": launches["block1_fused"],
         "launches_train_cli": cli_launches["block1_fused"],
         **launches21("block1_fused"), **launches22("block1_fused"),
         **launches23("block1_fused"), **launches25("block1_fused"),
         **launches26("block1_fused"),
         **launches27("block1_fused"),
         "band": p23["k2_band"],
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
         "launches_train_cli": cli_launches["block1_train_fwd"],
         **launches21("block1_train_fwd"), **launches22("block1_train_fwd"),
         **launches25("block1_train_fwd"),
         **launches26("block1_train_fwd"),
         **launches27("block1_train_fwd"),
         "max_abs_err": k3_err,
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
         "launches_train_cli": cli_launches["block1_train_bwd"],
         **launches21("block1_train_bwd"), **launches22("block1_train_bwd"),
         **launches25("block1_train_bwd"),
         **launches26("block1_train_bwd"),
         **launches27("block1_train_bwd"),
         "max_abs_err": k4_err,
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
         **launches21("costail_fwd"), **launches22("costail_fwd"),
         **launches25("costail_fwd"),
         **launches26("costail_fwd"),
         **launches27("costail_fwd"),
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
         **launches21("costail_bwd"), **launches22("costail_bwd"),
         **launches25("costail_bwd"),
         **launches26("costail_bwd"),
         **launches27("costail_bwd"),
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
        {"name": "conv7x7_igemm", "route": "cuda",
         "source": src + "conv7x7_igemm.cu",
         "replaces": "none (fc6's forward: cuDNN's precomputed sgemm; the "
                     "JAX package leaves it to XLA)",
         "launches": launches["conv7x7_igemm"],
         "launches_train": tlaunches["conv7x7_igemm"],
         "launches_train_cli": cli_launches["conv7x7_igemm"],
         **launches21("conv7x7_igemm"), **launches22("conv7x7_igemm"),
         **launches23("conv7x7_igemm"), **launches25("conv7x7_igemm"),
         "launches_parity": {part: l26[part]["conv7x7_igemm"]
                             for part in ("train", "serve_kernels",
                                          "serve_plain")},
         "launches_bench": p27["launches_fc6"],
         **{k: p28["rows"][0][k] for k in (
             "ms", "device_ms", "bound_ms", "bound_by", "bound_share",
             "library_ms", "library_device_ms", "patch_matmul_ms",
             "patch_matmul_device_ms", "rel_vs_fp32",
             "cudnn_rel_vs_fp32", "shape")},
         "dtype": "bfloat16", "serving_bar": sbar, "rows": p28["rows"],
         "design": "implicit GEMM, persistent: one producer warpgroup "
                   "gathers each tap's 128 pixel rows of 64 channels by "
                   "cp.async into the 128-byte swizzle and TMA-loads the "
                   "packed weight's box; two consumer warpgroups on wgmma "
                   "from shared memory on a 128 x 256 tile "
                   "(csrc/tma_wgmma.cuh, shared with pdot_tma); "
                   "N-panel-major tile walk",
         "build": fc6_build},
        {"name": "ring_pad", "route": "cuda", "source": src + "ring_pad.cu",
         "replaces": "none (the ring pads' two concatenations, "
                     "models/pruned.py _padc; the JAX package leaves them "
                     "to XLA)",
         "launches": launches["ring_pad"],
         "launches_train": {k: tlaunches[k] for k in ("ring_pad",
                                                      "ring_sum")},
         "launches_train_cli": {k: cli_launches[k] for k in ("ring_pad",
                                                             "ring_sum")},
         "launches_phases_21_27": {
             path: {k: n[k] for k in ("ring_pad", "ring_sum")}
             for path, n in ring.items()},
         **{k: p30["rows"][0][k] for k in (
             "ms", "device_ms", "bound_ms", "bound_by", "bound_share",
             "plain_ms")},
         "dtype": "bfloat16", "rows": p30["rows"],
         "ring_sum": p30["ring_sum"], "geometry": p30["geometry"],
         "design": "one block an output row, 16-byte vectors, loads before "
                   "stores, the constant staged in shared memory; ring_sum "
                   "in two passes of a fixed order",
         "build": rp_build},
        {"name": "pdot", "route": "cuda", "source": src + "pdot.cu",
         "replaces": ref + "pdot.py:47",
         "launches": dlaunches["pdot"],
         "launches_train_cli": cli_launches["pdot"],
         **launches21("pdot"), **launches22("pdot"),
         "launches_stage2_dot_free": STAGE2_STEPS,
         "max_abs_err": fc6_row["max_abs_err"], "ms": fc6_row["ms"],
         "plain_ms": fc6_row["plain_ms"], "bound_ms": fc6_row["bound_ms"],
         "bound_by": fc6_row["bound_by"],
         "library_ms": fc6_row["library_ms"],
         "shape": [fc6_row["m"], fc6_row["k"], fc6_row["n"]],
         "dtype": "bfloat16 in, float32 out", "variant": fc6_row["variant"],
         "launches_by_variant": {v: dlaunches[f"pdot_{v}"] for v in (
             "tma", "narrow", "wmma")},
         "design": "tma: TMA ring + wgmma, one producer and two consumer "
                   "warpgroups, persistent; narrow: wgmma n8/16/24, cp.async "
                   "ring, 512-deep K chunks + ordered reduce; wmma for the "
                   "other bf16 shapes; fp32 inputs on the fp32 route (next)",
         "build": k7_build, "shapes": pdot_rows},
        {"name": "pdot (fp32 route)", "route": "cuda",
         "source": src + "pdot.cu", "replaces": ref + "pdot.py:47",
         "launches": f32_launches["pdot"],
         "launches_by_variant": {key[len("pdot_"):]: f32_launches[key]
                                 for key in F32_COUNTS},
         **{key: f32_rows[0][key] for key in (
             "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
             "bound_by", "bound_share", "library_ms", "library_device_ms")},
         "shape": [f32_rows[0]["m"], f32_rows[0]["k"], f32_rows[0]["n"]],
         "dtype": "float32", "variant": f32_rows[0]["variant"],
         "fp32_b2_step_ms": f32_step_ms,
         "design": "full fp32 FFMA on CUDA cores: 128x128 (N > 32) or "
                   "256x32 tile, float4 fragments, cp.async ring (2 stages "
                   "of 32-deep K steps, or 4 of 16; 4-byte copies for "
                   "unaligned rows; a's stage transposed in shared memory "
                   "without trans_a), split K as one cluster of <= 8 "
                   "blocks reduced through distributed shared memory in "
                   "rank order",
         "build": {key: v for key, v in k7_build.items()
                   if key.startswith("pdot_f32")},
         "shapes": f32_rows},
        {"name": "conv1_1_pairs", "route": "cuda",
         "source": src + "conv1_1.cu",
         "replaces": ref + "block1_fused.py:201",
         "launches": c11["launches"],
         **launches21("conv1_1_pairs"),
         "max_abs_err": c11["max_abs_err"],
         "max_abs_err_fp32": c11["max_abs_err_fp32"], "ms": c11["ms"],
         "plain_ms": c11["plain_ms"], "bound_ms": c11["bound_ms"],
         "bound_by": c11["bound_by"], "library_ms": c11["library_ms"],
         "shape": c11["shape"], "dtype": "bfloat16",
         "device_ms": c11["device_ms"], "differ_share": c11["differ_share"],
         "rel_err_vs_fp32": c11["rel_err_vs_fp32"], "build": k8_build},
        {"name": "pool_bwd", "route": "cuda", "source": src + "pool_bwd.cu",
         "replaces": "scripts/experiments/pool_bwd_pallas.py:111",
         "launches": pool["launches"],
         **launches21("pool_bwd"),
         "max_abs_err": pool["max_abs_err"],
         **{k: pool["shapes"][0][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "shape", "dtype")},
         "shapes": pool["shapes"]},
        {"name": "rowdot", "route": "cuda", "source": src + "rowdot.cu",
         "replaces": "scripts/probe_h2d.py:763",
         "launches": probe["rowdot_pl"]["launches"]["rowdot"],
         **launches21("rowdot"),
         **{k: rdot[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "shape")}},
        {"name": "pdot (probe 512x512 fp32, K10a)", "route": "cuda",
         "source": src + "pdot.cu", "replaces": "scripts/probe_h2d.py:258",
         "launches": probe["pallas_dot"]["launches"]["pdot"],
         **launches21("pdot"),
         **rdot["k10a"], "dtype": "float32"},
    ]
    log(f"[times] K1 {k1_ms:.4f} ms (plain {k1_plain_ms:.3f}, bound "
        f"{k1_bound:.4f}); K2 {k2_ms:.3f} ms (plain {k2_plain_ms:.3f}, "
        f"cuDNN {k2_lib_ms:.3f}, bound {k2_bound:.3f})")
    log(f"[mesh] {card}: world-1 NCCL step {p22['a']['mesh_ms']:.2f} ms vs "
        f"bare {p22['a']['bare_ms']:.2f} ms; phase 22 "
        f"{p22['seconds']:.1f} s")
    log(f"[spatial] {card}: B=1 {SPATIAL_HW}x{SPATIAL_HW} bf16 "
        f"{p23['a']['spatial_ms']:.2f} ms spatial (world 1) vs "
        f"{p23['a']['one_device_ms']:.2f} ms one device; peaks at "
        f"{SPATIAL_BIG_HW}: {p23['c']}; phase 23 {p23['seconds']:.1f} s")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    decoder = {
        "name": "zss_loader (host C++, not a kernel)",
        "source": "zeroshotsemanticsegmentation_tpu_torch/csrc/zss_loader.cc",
        "jpeg": p24["toolchain"]["jpeg"],
        "native_batches_loop": p24["loop"]["native_batches"],
        "loop_steps": p24["loop"]["steps"],
        "native_batches_train_cli": p24["cli"]["native_batches"],
        "loop_images_per_s": p24["loop"]["images_per_s"],
        "loop_over_bare": p24["loop"]["loop_over_bare"],
        "steady_over_bare": p24["loop"]["steady_over_bare"],
        "feed_alone_images_per_s": p24["feed_alone_images_per_s"],
        "cores": p24["cores"]}
    decoder["device"] = p25["f"]
    remat = {k: {v: {f: p25[k][v].get(f) for f in (
        "batch", "ms", "peak_gb", "step_peak_gb")}
        for v in ("plain", "remat")} for k in ("a", "b", "c")}
    remat["save"] = p25["save"]
    log(f"[remat] {card}: pruned B={TRAIN_BATCH} "
        f"{p25['a']['plain']['ms']:.2f} -> {p25['a']['remat']['ms']:.2f} ms, "
        f"step peak {p25['a']['plain']['step_peak_gb']:.2f} -> "
        f"{p25['a']['remat']['step_peak_gb']:.2f} GB; unpruned "
        f"B={p25['b']['batch']} {p25['b']['plain']['step_peak_gb']:.2f} -> "
        f"{p25['b']['remat']['step_peak_gb']:.2f} GB; routine save returns in "
        f"{p25['save']['routine_return_s']:.3f} s vs "
        f"{p25['save']['blocking_s']:.3f} s blocking; phase 25 "
        f"{p25['seconds']:.1f} s")
    b16 = p26["bf16"]
    parity = {k: b16[k] for k in (
        "flip_rate_kernels", "flip_rate_plain", "flip_ratio", "pixels",
        "train_steps", "launches")}
    parity["metrics_abs_delta_kernels"] = {
        g: d["abs_delta_kernels"] for g, d in b16["metrics"].items()}
    parity["context59"] = p26["context59"]
    log(f"[parity] {card}: bf16 flips vs fp32 "
        f"{b16['flip_rate_kernels']:.5f} (plain "
        f"{b16['flip_rate_plain']:.5f}); context-59 tool "
        f"{p26['context59']['files']} files equal; Pillow importable: "
        f"{p26['context59']['pillow_importable']}; phase 26 "
        f"{p26['seconds']:.1f} s")
    log(json.dumps({"kernels": kernels, "decoder": decoder, "remat": remat,
                    "parity": parity,
                    "bench": {k: p27[k] for k in ("lines", "seconds",
                                                  "gate")}}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
