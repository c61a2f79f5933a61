#!/usr/bin/env python3
"""Serving on the trained-upscore route beside the bilinear gate, on one
NVIDIA GPU.

    python3 scripts/torch_bench_trained_gate.py

The port's counterpart of scripts/bench_trained_gate.py. The headline
serving line (`python -m zeroshotsemanticsegmentation_tpu_torch.bench`)
measures the pristine route: the fused labels kernel (K1) upsamples the
seenmask gate with fixed bilinear taps. After stage 2 has trained
`seenmask_upscore`, serving takes the trained route (serving.py's
`predict`): the gate goes through the model's ConvTranspose at full
resolution and the classes through two K1 passes, an always-seen and an
always-unseen one, stitched by the gate. Both routes run through the
bench's serving chain (`bench.serving_chain`, B=64, 512x512, a chain of 8)
on one seeded bf16 model; the trained route's upscore kernel is its
bilinear init plus 0.01 x randn, drawn in the JAX layout (the JAX script
draws it from the stream of its images, this script from RandomState(1)).
Prints one JSON line: both rates, their ratio and the card's name and
power limit. Needs a card: exits non-zero without one.
"""

from __future__ import annotations

import json
import os.path as osp
import sys

import numpy as np

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

H = W = 512
BATCH = 64
CHAIN = 8


def perturbed_upscore(weight, seed: int = 1):
    """`weight` (the port's ConvTranspose layout (Cin, Cout, K, K)) plus
    0.01 x randn from `seed`, drawn in the JAX kernel's layout (K, K, Cin,
    Cout), as the JAX script perturbs its kernel
    (bench_trained_gate.py:55-57)."""
    import torch
    up = weight.detach().to("cpu", torch.float32).permute(2, 3, 0, 1).numpy()
    noise = np.random.RandomState(seed).randn(*up.shape).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(
        (up + 0.01 * noise).transpose(2, 3, 0, 1))).to(weight.device)


def trained_labels(up_trained):
    """The trained route's label function (the JAX script's
    `label_trained`, serving.py's trained branch) for the upscore kernel
    `up_trained`, with `bench.label_pristine`'s arguments."""
    import torch
    from zeroshotsemanticsegmentation_tpu_torch.ops.bilinear import (
        upscore_conv_transpose_cropped)
    from zeroshotsemanticsegmentation_tpu_torch.ops.szn_fused import (
        infer_labels_szn_fused)

    def label_trained(f_raw, s_raw, embed, unseen_vec, out_hw):
        gate = upscore_conv_transpose_cropped(
            s_raw, up_trained, stride=32, crop_offset=19, out_h=out_hw[0],
            out_w=out_hw[1])
        pixel_unseen = torch.argmax(gate, dim=-1) == 0
        always_seen = torch.zeros_like(s_raw)
        always_seen[..., 1] = 1.0
        always_unseen = torch.zeros_like(s_raw)
        always_unseen[..., 0] = 1.0
        seen_lbl = infer_labels_szn_fused(f_raw, always_seen, embed,
                                          unseen_vec, out_hw)
        unseen_lbl = infer_labels_szn_fused(f_raw, always_unseen, embed,
                                            unseen_vec, out_hw)
        return torch.where(pixel_unseen, unseen_lbl, seen_lbl)

    return label_trained


def run(device="cuda", batch: int = BATCH, hw: int = H,
        chain: int = CHAIN) -> dict:
    """Both routes' timed serving chains on the card (`bench.time_chain`,
    host syncs inside an error): the line this script prints."""
    from zeroshotsemanticsegmentation_tpu_torch import bench
    dev = bench.require_card(device)
    card = bench.card_line(dev)
    model = bench.seeded_model(dev)
    up_trained = perturbed_upscore(model.seenmask_upscore.weight)
    mp_s, checksums = {}, {}
    for name, label_fn in (("pristine", bench.label_pristine),
                           ("trained", trained_labels(up_trained))):
        t = bench.time_chain(bench.serving_chain(
            dev, batch, hw, chain, model=model, label_fn=label_fn))
        mp_s[name] = batch * hw * hw / (t["seconds"] / chain) / 1e6
        checksums[name] = t["checksum"]
    return {"metric": "szn_trained_gate_serving",
            "pristine_mp_s": mp_s["pristine"],
            "trained_mp_s": mp_s["trained"],
            "trained_over_pristine": mp_s["trained"] / mp_s["pristine"],
            "batch": batch, "hw": hw,
            "checksum_pristine": checksums["pristine"],
            "checksum_trained": checksums["trained"], "card": card}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_bench_trained_gate.py needs an NVIDIA GPU "
              "(torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
