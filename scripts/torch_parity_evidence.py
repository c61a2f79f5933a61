#!/usr/bin/env python3
"""Parity evidence for the PyTorch port: the bf16 drift on the card, and
the report.

    python3 scripts/torch_parity_evidence.py bf16 [--batches 4]
        [--batch_size 8] [--train_steps 12] [--size 512] [--seed 0]
        [--labels random|coherent] [--out_dir DIR]
    python3 scripts/torch_parity_evidence.py render [--out_dir DIR]

bf16 (needs a card; exits non-zero without one): trains the full-width
bf16 FCN-32s of the port (support-pruned, fused block 1, dropout 0.5) from
its seeded init for `--train_steps` stage-1 steps (Adam lr 1e-4, cosine
loss, 21 random unit embeddings of 20 dims; K3-K6 once a step), then serves
`--batches` x `--batch_size` images of `--size`² three ways on the trained
weights:

  kernels  the production predictor, `serving.make_szn_predictor` (K2, K1)
  plain    the same bf16 model and geometry, K1 and K2 through their plain
           versions and fc6's forward through F.conv2d
  fp32     fp32 with TF32 off, unpruned, both full-resolution heads, then
           `ops.nne.infer_labels_szn`

and reports each bf16 run's label flip rate against fp32's, their ratio,
the overall / seen / unseen metric quadruples (`ops.metrics`) of all three
against the labels with their |delta| from fp32's, and K1-K6's
launches. The bar (PERF.md's serving bf16 bar): flips(kernels) <= 2 x
flips(plain); K3-K6 and fc6's implicit-GEMM forward >= train_steps
launches each, K1, K2 and fc6 >= batches.
Images are `RandomState(seed)` normals x 40, labels uniform in [-1, 21)
(the JAX record's data; on it a short run may predict one class
everywhere, so the report also counts the classes predicted and the raw
heads' relative drift), or with `--labels coherent` constant over 64x64
cells whose class color is added to the image (10% ignored); val unseen
classes those of config 14. Writes bf16.json (bf16_coherent.json) into
`--out_dir` (docs/parity_torch by default) and renders; exits 1 when the
bar fails.

render: writes docs/PARITY_EVIDENCE_TORCH.md from
docs/parity_torch/{lockstep,bf16,bf16_coherent}.json (the lockstep comes from
tests/torch_parity_lockstep.py on the CPU); every number from the card
carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import sys
import time
from unittest import mock

import numpy as np

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

OUT_DIR = osp.join(ROOT, "docs", "parity_torch")
DOC = osp.join(ROOT, "docs", "PARITY_EVIDENCE_TORCH.md")
N_CLASS = 21
VAL_UNSEEN = (6, 7, 10, 14, 15, 16, 17, 18, 19, 20)  # config 14
METRIC_ORDER = ["pxl_acc", "class_acc", "mean_iu", "fwavacc"]
TRAIN_KEYS = ("block1_train_fwd", "block1_train_bwd", "costail_fwd",
              "costail_bwd", "conv7x7_igemm")
SERVE_KEYS = ("szn_fused", "block1_fused", "conv7x7_igemm")
# "coherent" labels: one class a PATCH x PATCH cell, its color (uniform in
# [-COLOR, COLOR] a channel, from RandomState(seed + 1)) added to the image
LABELS = ("random", "coherent")
PATCH = 64
COLOR = 60.0
KERNEL_NAMES = {"szn_fused": "K1", "block1_fused": "K2",
                "block1_train_fwd": "K3", "block1_train_bwd": "K4",
                "costail_fwd": "K5", "costail_bwd": "K6",
                "conv7x7_igemm": "fc6"}


def card_line() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`'s
    first line, None where it fails."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = smi.stdout.strip().splitlines()
    return lines[0].strip() if smi.returncode == 0 and lines else None


def run_bf16(batches: int = 4, batch_size: int = 8, size: int = 512,
             train_steps: int = 12, seed: int = 0, log=print, *,
             labels: str = "random", device: str = "cuda",
             channel_scale: float = 1.0) -> dict:
    """The drift study on the card (see the module's docstring); returns
    the report. The launch counts are set to 0 before the training and
    before each serving run and read after it. `device="cpu"` and a
    narrow `channel_scale` run the same study on the kernels' plain
    versions (the tests' size; its launches stay 0). `labels`: "random"
    (the JAX record's data) or "coherent" (`LABELS`)."""
    if labels not in LABELS:
        raise ValueError(f"labels must be one of {LABELS}, not {labels!r}")
    import torch

    from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
    from zeroshotsemanticsegmentation_tpu_torch.ops import (
        block1_fused as b1)
    from zeroshotsemanticsegmentation_tpu_torch.ops import conv7x7 as c7
    from zeroshotsemanticsegmentation_tpu_torch.ops import szn_fused as sz
    from zeroshotsemanticsegmentation_tpu_torch.ops.metrics import (
        hist_to_metrics, unseen_mask_vector, zeroshot_hists)
    from zeroshotsemanticsegmentation_tpu_torch.ops.nne import (
        infer_labels_szn)
    from zeroshotsemanticsegmentation_tpu_torch.serving import (
        make_szn_predictor)
    from zeroshotsemanticsegmentation_tpu_torch.train import (
        TrainState, make_fcn_optimizer, make_fcn_train_step)

    t_start = time.perf_counter()
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(seed)
    e = rng.randn(N_CLASS, 20).astype(np.float32)
    embeddings = e / np.linalg.norm(e, axis=1, keepdims=True)
    uv = unseen_mask_vector(N_CLASS, list(VAL_UNSEEN))
    uv_dev = torch.as_tensor(uv, device=dev)
    emb_dev = torch.as_tensor(embeddings, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    colors = np.random.RandomState(seed + 1).uniform(
        -COLOR, COLOR, (N_CLASS, 3)).astype(np.float32)

    def draw(n):
        img = rng.randn(n, size, size, 3).astype(np.float32) * 40
        if labels == "random":
            lbl = rng.randint(-1, N_CLASS, (n, size, size)).astype(np.int32)
        else:
            cells = -(-size // PATCH)
            cls = rng.randint(0, N_CLASS, (n, cells, cells))
            lbl = np.repeat(np.repeat(cls, PATCH, 1), PATCH, 2)[
                :, :size, :size].astype(np.int32)
            img += colors[lbl]
            lbl[rng.rand(n, size, size) < 0.1] = -1
        return (torch.from_numpy(img).to(dev), torch.from_numpy(lbl).to(dev))

    def counts(keys):
        return {k: _kernels.launch_counts[k] for k in keys}

    # ---- 12 stage-1 steps of the production bf16 model (K3-K6)
    model = FCN32s(20, dtype=torch.bfloat16, prune_pad=True,
                   fused_block1=True, channel_scale=channel_scale,
                   generator=torch.Generator().manual_seed(seed), device=dev)
    state = TrainState.create(model, make_fcn_optimizer(model, optim="adam",
                                                        lr=1e-4))
    step = make_fcn_train_step(loss_name="cos", num_classes=N_CLASS,
                               embeddings=embeddings)
    dropout = torch.Generator(device=dev).manual_seed(seed)
    sizes = np.full((batch_size, 2), size, np.int32)
    losses = []
    _kernels.reset_launch_counts()
    for _ in range(train_steps):
        img, lbl = draw(batch_size)
        state, aux = step(state, {"image": img, "label": lbl, "sizes": sizes,
                                  "num_real": batch_size}, dropout)
        losses.append(aux["loss"])
    sync()
    train_launches = counts(TRAIN_KEYS)
    losses = [float(x.item()) for x in losses]
    log(f"trained {train_steps} steps at B={batch_size} {size}x{size}: "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches "
        f"{train_launches}")

    # ---- the three serving runs on the trained weights
    fp32 = FCN32s(20, dtype=torch.float32, prune_pad=False,
                  channel_scale=channel_scale,
                  generator=torch.Generator().manual_seed(seed), device=dev)
    fp32.load_state_dict(model.state_dict(), strict=True)
    fp32.eval()
    predict = make_szn_predictor(model, None, embeddings, list(VAL_UNSEEN),
                                 device=dev)

    @torch.inference_mode()
    def predict_fp32(images):
        f, s = fp32(images, mode="both")
        return infer_labels_szn(f, s, emb_dev, uv_dev)

    def predict_plain(images):
        with mock.patch.object(sz, "szn_labels", sz.szn_labels_plain), \
                mock.patch.object(b1, "block1_op", b1.block1_plain), \
                mock.patch.object(c7, "igemm_route",
                                  lambda h, cout: False):
            return predict(images)

    runs = {"kernels": predict, "plain": predict_plain, "fp32": predict_fp32}
    hists = {r: np.zeros((3, N_CLASS, N_CLASS), np.int64) for r in runs}
    launches = {r: dict.fromkeys(SERVE_KEYS, 0) for r in runs}
    flips = {"kernels": 0, "plain": 0, "kernels_vs_plain": 0}
    total = 0
    # the raw 1/32 heads' drift, bf16 (through the kernels) vs fp32
    head_err = {"fcn": [0.0, 0.0], "seenmask": [0.0, 0.0]}
    classes = {r: set() for r in runs}
    for bi in range(batches):
        img, lbl = draw(batch_size)
        preds = {}
        for r, fn in runs.items():
            _kernels.reset_launch_counts()
            preds[r] = fn(img)
            sync()
            for k, v in counts(SERVE_KEYS).items():
                launches[r][k] += v
            hists[r] += zeroshot_hists(lbl, preds[r], N_CLASS,
                                       uv_dev).cpu().numpy()
        with torch.inference_mode():
            for name, a, b in zip(("fcn", "seenmask"),
                                  model(img, mode="raw"),
                                  fp32(img, mode="raw")):
                a, b = a.double(), b.double()
                head_err[name][0] += float(((a - b) ** 2).sum())
                head_err[name][1] += float((b ** 2).sum())
        for r in runs:
            classes[r].update(preds[r].unique().tolist())
        flips["kernels"] += int((preds["kernels"] != preds["fp32"]).sum())
        flips["plain"] += int((preds["plain"] != preds["fp32"]).sum())
        flips["kernels_vs_plain"] += int(
            (preds["kernels"] != preds["plain"]).sum())
        total += preds["fp32"].numel()
        log(f"batch {bi}: cumulative flip rate vs fp32: kernels "
            f"{flips['kernels'] / total:.5f}, plain "
            f"{flips['plain'] / total:.5f}")

    metrics = {}
    for gi, g in enumerate(("overall", "seen", "unseen")):
        m = {r: np.asarray(hist_to_metrics(hists[r][gi]), np.float64)
             for r in runs}
        metrics[g] = {r: [round(float(v), 6) for v in m[r]] for r in runs}
        for r in ("kernels", "plain"):
            with np.errstate(invalid="ignore"):
                metrics[g][f"abs_delta_{r}"] = [
                    round(float(abs(a - b)), 6)
                    for a, b in zip(m[r], m["fp32"])]
    rate = {k: v / total for k, v in flips.items()}
    out = {"flip_rate_kernels": rate["kernels"],
           "flip_rate_plain": rate["plain"],
           "flip_rate_kernels_vs_plain": rate["kernels_vs_plain"],
           "flip_ratio": (rate["kernels"] / rate["plain"]
                          if rate["plain"] > 0 else None),
           "head_rel_l2": {k: (v[0] / max(v[1], 1e-300)) ** 0.5
                           for k, v in head_err.items()},
           "classes_predicted": {r: len(c) for r, c in classes.items()},
           "labels": labels,
           "pixels": total, "batches": batches, "batch_size": batch_size,
           "size": size, "train_steps": train_steps, "seed": seed,
           "lr": 1e-4, "train_losses": losses,
           "metric_order": METRIC_ORDER, "metrics": metrics,
           "launches": {"train": train_launches, **{
               f"serve_{r}": launches[r] for r in runs}},
           "channel_scale": channel_scale,
           "card": card_line() if dev.type == "cuda" else None,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "seconds": round(time.perf_counter() - t_start, 1)}
    out["bar_failures"] = bar_failures(out)
    log(f"flip rates vs fp32: kernels {rate['kernels']:.5f}, plain "
        f"{rate['plain']:.5f} (ratio {out['flip_ratio']}); kernels vs plain "
        f"{rate['kernels_vs_plain']:.5f}; classes predicted "
        f"{out['classes_predicted']}; raw heads' rel-L2 bf16 vs fp32 "
        f"{out['head_rel_l2']}; serving launches {out['launches']}")
    return out


def bar_failures(r: dict) -> list:
    """What of the bar a bf16 report misses (empty: it holds)."""
    out = []
    if r["flip_rate_kernels"] > 2 * r["flip_rate_plain"]:
        out.append(f"bf16 serving flips {r['flip_rate_kernels']} vs fp32, "
                   f"more than 2x the plain versions' "
                   f"{r['flip_rate_plain']}")
    for k in TRAIN_KEYS:
        n = r["launches"]["train"][k]
        if n < r["train_steps"]:
            out.append(f"{KERNEL_NAMES[k]} ({k}) launched {n} times in "
                       f"{r['train_steps']} training steps")
    for k in SERVE_KEYS:
        n = r["launches"]["serve_kernels"][k]
        if n < r["batches"]:
            out.append(f"{KERNEL_NAMES[k]} ({k}) launched {n} times in "
                       f"{r['batches']} serving calls")
        if r["launches"]["serve_plain"][k]:
            out.append(f"{KERNEL_NAMES[k]} launched on the plain run")
    return out


def _fmt(v) -> str:
    return "nan" if v is None or v != v else f"{v:.6f}"


def json_name(labels: str) -> str:
    """The file a bf16 study on `labels` writes."""
    return "bf16.json" if labels == "random" else f"bf16_{labels}.json"


def _bf16_section(r: dict) -> list:
    """The document's lines for one bf16 study."""
    card = f"[{r['card'] or r['device']}]"
    bar = ("held" if not r["bar_failures"]
           else "FAILED: " + "; ".join(r["bar_failures"]))
    coherent = r.get("labels") == "coherent"
    data = (f"labels constant over {PATCH}x{PATCH} cells, each class's "
            "color added to its cells" if coherent
            else "labels uniform in [-1, 21), the JAX record's data")
    lines = [
        "## bf16 drift of the port on the card"
        + (", coherent labels" if coherent else ""),
        "",
        f"Card: {r['card'] or r['device']} (torch {r['torch']}, CUDA "
        f"{r['cuda']}). Every number in this section was taken on it.",
        "",
        f"- weights: the full-width bf16 FCN-32s (support-pruned, fused "
        f"block 1) trained {r['train_steps']} stage-1 steps at "
        f"B={r['batch_size']}, {r['size']}², Adam lr {r['lr']}, cos loss; "
        f"images randn x 40, {data}; loss {r['train_losses'][0]:.4f} -> "
        f"{r['train_losses'][-1]:.4f} {card}",
        f"- served {r['batches']} x {r['batch_size']} images of "
        f"{r['size']}² ({r['pixels']:,} pixels) three ways: kernels (K2 + "
        f"K1), plain (K1, K2 through their plain versions), fp32 "
        f"(unpruned, TF32 off, unfused NNE) {card}",
        f"- label flip rate vs fp32: kernels "
        f"**{r['flip_rate_kernels']:.5f}**, plain "
        f"{r['flip_rate_plain']:.5f}, ratio {_fmt(r['flip_ratio'])} (bar: "
        f"<= 2); kernels vs plain {r['flip_rate_kernels_vs_plain']:.5f} "
        f"{card}",
        "- classes predicted: " + ", ".join(
            f"{k} {v}" for k, v in r["classes_predicted"].items())
        + f"; the raw 1/32 heads' rel-L2, bf16 vs fp32: fcn "
        f"{r['head_rel_l2']['fcn']:.3e}, seenmask "
        f"{r['head_rel_l2']['seenmask']:.3e} {card}",
        "- launches: " + ", ".join(
            f"{KERNEL_NAMES[k]} {r['launches'][part][k]}"
            for part, keys in (("serve_kernels", SERVE_KEYS),
                               ("train", TRAIN_KEYS)) for k in keys
            if k in r["launches"][part])
        + f" (plain run: K1 {r['launches']['serve_plain']['szn_fused']}, "
        f"K2 {r['launches']['serve_plain']['block1_fused']}) {card}",
        f"- bar: {bar} {card}",
        f"- metric quadruples {r['metric_order']} against the labels, and "
        "|Δ| from fp32:"]
    for g, d in r["metrics"].items():
        lines.append(
            f"  - {g}: kernels {d['kernels']} (|Δ| {d['abs_delta_kernels']})"
            f", plain {d['plain']} (|Δ| {d['abs_delta_plain']}), fp32 "
            f"{d['fp32']} {card}")
    return lines + [""]


def render(out_dir: str = OUT_DIR, doc: str = DOC) -> str:
    """Writes `doc` from `out_dir`'s lockstep.json and bf16 studies (any
    may be missing); returns the text."""
    parts = ["# Parity evidence of the PyTorch port",
             "",
             "Generated by `scripts/torch_parity_evidence.py render` from "
             "`docs/parity_torch/` (the CPU lockstep from "
             "`tests/torch_parity_lockstep.py`, the bf16 drift from "
             "`scripts/torch_parity_evidence.py bf16` on the card). The JAX "
             "package's own record, against the torch oracle and on its "
             "TPU, is `docs/PARITY_EVIDENCE.md`; no figure of it is "
             "repeated here.",
             ""]
    lp = osp.join(out_dir, "lockstep.json")
    if osp.exists(lp):
        with open(lp) as f:
            r = json.load(f)
        parts += [
            "## Full-width fp32 lockstep, the port against the JAX package "
            "(CPU)",
            "",
            f"- geometry: channel_scale={r['scale']}, {r['size']}² single "
            f"images, {r['steps']} steps per stage; both sides on the CPU, "
            f"one thread ({r.get('host', 'host not recorded')})",
            "- bars (scripts/parity_evidence.py:55-370, unchanged): loss "
            "rel < 1e-3 per step, NNE flips <= 0.5% of pixels, Adam global "
            "delta rel-L2 <= 5e-2, SGD <= 5e-3, stage-2 head <= 5e-2, eval "
            "loss rel < 1e-3, metric quadruples within 5e-3"]
        if "adam" in r:
            a = r["adam"]
            parts.append(
                f"- stage 1, Adam + cos (config 14, lr {a['lr']}): max loss "
                f"rel {a['max_loss_rel']:.2e}, max NNE flip fraction "
                f"{a['max_pred_flip_frac']:.2e}; end-state delta global "
                f"rel-L2 {a['global_delta_rel_l2']:.2e}, worst leaf "
                f"{a['worst_param_delta_rel_l2']:.2e} "
                f"({a['worst_rel_l2_param']}); {a['wall_s']} s")
        if "sgd" in r:
            s = r["sgd"]
            parts.append(
                f"- stage 1, SGD + summed CE (config 1, lr {s['lr']}): max "
                f"loss rel {s['max_loss_rel']:.2e}; end-state delta global "
                f"rel-L2 {s['global_delta_rel_l2']:.2e}, worst leaf "
                f"{s['worst_param_delta_rel_l2']:.2e} "
                f"({s['worst_rel_l2_param']}); {s['wall_s']} s")
        if "stage2" in r:
            s = r["stage2"]
            parts.append(
                f"- stage 2 (seenmask head, lr {s['lr']}): max loss rel "
                f"{s['max_loss_rel']:.2e}; head delta global rel-L2 "
                f"{s['head_delta_global_rel_l2']:.2e} (elementwise outlier "
                f"fraction {s['head_delta_outlier_frac']:.2e}), upscore "
                f"delta rel-L2 {s['upscore_delta_rel_l2']:.2e}; "
                f"{s['wall_s']} s")
        if "eval" in r:
            v = r["eval"]
            parts.append(
                f"- test_all eval ({v['images']} images): loss rel "
                f"{v['val_loss_rel']:.2e}, 3-histogram L1 {v['hist_l1']}, "
                f"{v['pred_flips']} label flips; metric quadruples "
                f"{METRIC_ORDER}:")
            for g, d in v["metrics"].items():
                parts.append(f"  - {g}: port {d['port']} vs JAX {d['jax']} "
                             f"(max |Δ| {d['max_abs_delta']:.2e})")
        parts.append("")
    for labels in LABELS:
        bp = osp.join(out_dir, json_name(labels))
        if osp.exists(bp):
            with open(bp) as f:
                parts += _bf16_section(json.load(f))
    text = "\n".join(parts)
    with open(doc, "w") as f:
        f.write(text)
    print(f"wrote {osp.relpath(doc, ROOT)}")
    return text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["bf16", "render"])
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--train_steps", type=int, default=12)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--labels", choices=LABELS, default="random")
    ap.add_argument("--out_dir", default=OUT_DIR,
                    help="where bf16 writes its JSON and render reads "
                    "them (default docs/parity_torch)")
    a = ap.parse_args(argv)
    if a.mode == "render":
        render(a.out_dir)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_parity_evidence.py bf16 needs an NVIDIA GPU "
              "(torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    res = run_bf16(a.batches, a.batch_size, a.size, a.train_steps, a.seed,
                   labels=a.labels)
    os.makedirs(a.out_dir, exist_ok=True)
    path = osp.join(a.out_dir, json_name(a.labels))
    with open(path, "w") as f:
        json.dump(res, f, indent=1, sort_keys=True)
    print(f"wrote {path}")
    render(a.out_dir)
    for msg in res["bar_failures"]:
        print(f"FAIL: {msg}", file=sys.stderr)
    return 1 if res["bar_failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
