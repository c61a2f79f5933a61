#!/usr/bin/env python3
"""Host-to-device bandwidth before and after one program, on one GPU: the
PyTorch port's counterpart of the JAX package's H2D probe
(scripts/probe_h2d.py).

    python3 scripts/torch_probe_h2d.py <mode> [<mode> ...]
    python3 scripts/torch_probe_h2d.py --all

The JAX probe bisected a fault of a TPU host link, where host-to-device
bandwidth fell for the rest of a process after some programs. Each mode here
runs one program in a fresh process between two bandwidth readings, each the
best of 5 pageable copies of 25 MB from a numpy array to the card after a
warm-up copy, every copy ended by a synchronize. One JSON line per mode:
{"mode", "bw_before_mbs", "bw_after_mbs", "collapsed" (after < before / 4),
"launches" (the port's kernel launches in the program, by counter)}.

Modes:
  none        no program (the baseline)
  d2h_only    one device-to-host readback, no compute
  pallas_dot  a (512, 512) fp32 product on the port's matmul kernel K7
              (`ops.pdot.pdot`), which carries the JAX probe's Pallas dot
  rowdot_pl   the cosine-loss structure at (8, 512, 512, 21): the row-dot
              kernel K10b (`ops.rowdot.rowdot`), then the masked sums
  fwd         the FCN-32s forward, B=4, 512x512, bf16
  serve       make_szn_predictor with the fused block 1, B=8, 512x512
  full        the stage-1 train step (cos loss, Adam), B=8, 512x512
  head        the stage-2 seenmask train step, B=4, 512x512

With one mode the program runs in this process; with several, or `--all`,
each runs in a subprocess of its own, and the exit code is non-zero if any
failed. The JAX probe's other modes bisect XLA's compiler and its jit
closure constants and have no counterpart here (ROADMAP.md). Needs a GPU:
exits non-zero without one.
"""

from __future__ import annotations

import json
import os.path as osp
import subprocess
import sys
import time

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

MODES = ("none", "d2h_only", "pallas_dot", "rowdot_pl", "fwd", "serve",
         "full", "head")
UNSEEN = [1, 13]


def measure_bw(nbytes: int = 25 * 1024 * 1024, reps: int = 5) -> float:
    """Best-of-`reps` host-to-device bandwidth (MB/s) of a pageable uint8
    copy, after one untimed warm-up copy."""
    import numpy as np
    import torch
    host = np.random.randint(0, 255, (nbytes,), np.uint8)
    torch.from_numpy(host).to("cuda")
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        host[0] = i
        t0 = time.perf_counter()
        torch.from_numpy(host).to("cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return nbytes / min(times) / 1e6


def _batch(rng, b, hw):
    import numpy as np
    import torch
    return {"image": torch.from_numpy(
                rng.randn(b, hw, hw, 3).astype(np.float32)).cuda(),
            "label": torch.from_numpy(
                rng.randint(-1, 21, (b, hw, hw)).astype(np.int32)).cuda(),
            "sizes": torch.full((b, 2), hw, dtype=torch.int32,
                                device="cuda"),
            "num_real": torch.tensor(b, device="cuda")}


def run_program(mode: str) -> None:
    import numpy as np
    import torch

    from zeroshotsemanticsegmentation_tpu_torch.data.assets import (
        load_class_embeddings)
    from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
    from zeroshotsemanticsegmentation_tpu_torch.ops.metrics import (
        unseen_mask_vector)
    rng = np.random.RandomState(0)

    def model(**kw):
        return FCN32s(20, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0), **kw)

    if mode == "none":
        return
    if mode == "d2h_only":
        v = torch.from_numpy(np.float32(1.0) - unseen_mask_vector(21, UNSEEN))
        v.cuda().cpu()
        return
    if mode == "pallas_dot":
        from zeroshotsemanticsegmentation_tpu_torch.ops.pdot import pdot
        a = torch.from_numpy(rng.randn(512, 512).astype(np.float32)).cuda()
        pdot(a, a)
        torch.cuda.synchronize()
        return
    if mode == "rowdot_pl":
        from zeroshotsemanticsegmentation_tpu_torch.ops.rowdot import rowdot
        s = torch.from_numpy(
            rng.randn(8, 512, 512, 21).astype(np.float32)).cuda()
        t = torch.from_numpy(
            rng.randn(8, 512, 512, 21).astype(np.float32)).cuda()
        lbl = torch.from_numpy(
            rng.randint(-1, 21, (8, 512, 512)).astype(np.int32)).cuda()
        cos = rowdot(s, t)
        valid = lbl >= 0
        loss = valid.sum() - torch.where(valid, cos, 0.0).sum()
        torch.cuda.synchronize()
        del loss
        return
    if mode == "fwd":
        x = torch.from_numpy(rng.randn(4, 512, 512, 3).astype(np.float32))
        with torch.inference_mode():
            model()(x.cuda(), mode="raw")
        torch.cuda.synchronize()
        return
    if mode == "serve":
        from zeroshotsemanticsegmentation_tpu_torch.serving import (
            make_szn_predictor)
        predict = make_szn_predictor(model(fused_block1=True), None,
                                     load_class_embeddings("pascal", 20),
                                     UNSEEN)
        predict(torch.from_numpy(
            rng.randn(8, 512, 512, 3).astype(np.float32) * 40).cuda())
        torch.cuda.synchronize()
        return
    if mode not in ("full", "head"):
        raise ValueError(f"unknown mode {mode!r}; modes: {', '.join(MODES)}")

    from zeroshotsemanticsegmentation_tpu_torch.train import (
        TrainState, make_fcn_optimizer, make_fcn_train_step,
        make_seenmask_optimizer, make_seenmask_train_step)
    b = 4 if mode == "head" else 8
    m = model()
    batch = _batch(rng, b, 512)
    if mode == "head":
        seen = np.float32(1.0) - unseen_mask_vector(21, UNSEEN)
        state = TrainState.create(m, make_seenmask_optimizer(m, lr=1e-3))
        step = make_seenmask_train_step(seen_vec=seen)
    else:
        state = TrainState.create(m, make_fcn_optimizer(m, optim="adam",
                                                        lr=1e-5))
        step = make_fcn_train_step(loss_name="cos", num_classes=21,
                                   embeddings=load_class_embeddings(
                                       "pascal", 20))
    step(state, batch, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()


def probe(mode: str) -> dict:
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
    before = measure_bw()
    _kernels.reset_launch_counts()
    run_program(mode)
    launches = {k: v for k, v in _kernels.launch_counts.items() if v}
    after = measure_bw()
    return {"mode": mode, "bw_before_mbs": before, "bw_after_mbs": after,
            "collapsed": after < before / 4, "launches": launches}


def main() -> None:
    args = sys.argv[1:]
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_probe_h2d.py needs an NVIDIA GPU: "
                 "torch.cuda.is_available() is false")
    if len(args) == 1 and args[0] != "--all":
        print(json.dumps(probe(args[0])), flush=True)
        return
    modes = MODES if args in ([], ["--all"]) else args
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        sys.exit(f"unknown modes {unknown}; modes: {', '.join(MODES)}")
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
    _kernels.build()   # once, so that every subprocess loads the libraries
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    failed = []
    for m in modes:
        r = subprocess.run([sys.executable, osp.abspath(__file__), m],
                           capture_output=True, text=True, timeout=600)
        print((r.stdout.strip().splitlines() or ["<no output>"])[-1],
              flush=True)
        if r.returncode:
            failed.append(m)
            print(f"  {m}: rc={r.returncode} "
                  f"{r.stderr.strip().splitlines()[-3:]}", flush=True)
    if failed:
        sys.exit(f"modes failed: {failed}")


if __name__ == "__main__":
    main()
