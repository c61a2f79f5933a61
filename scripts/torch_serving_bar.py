#!/usr/bin/env python3
"""The serving bf16 bar: how far bf16 serving's labels move from fp32's,
through the kernels and through the plain block 1.

    python3 scripts/torch_serving_bar.py [--images 8] [--seed 0]

Serves the full-width FCN-32s SZN predictor of the PyTorch port (20-dim
pascal embeddings, unseen classes [1, 13], seeded random weights) on the
same 512x512 images three times: in bf16 through the kernels, in bf16 with
block 1 through its plain version (`block1_plain`) and fc6's forward
through F.conv2d (everything else as before) and in fp32 with TF32 off.
Prints one JSON line with each bf16 run's label flip rate against the fp32
labels and their ratio, and the kernel run's K2 and fc6 launches;
chip_smoke.py holds the kernels to at most 2x the plain run's rate. Needs
a card: exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import sys
from unittest import mock

import numpy as np

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

H = W = 512
UNSEEN = [1, 13]


def run(images: int = 8, seed: int = 0, log=print) -> dict:
    """The three serving runs on `images` images from `seed`: flip rates of
    the bf16 kernels' and the bf16 plain run's (block 1's plain version,
    fc6 on F.conv2d) labels against fp32's, and the kernels' K2 and fc6
    launches."""
    import torch
    from zeroshotsemanticsegmentation_tpu_torch.data.assets import (
        load_class_embeddings)
    from zeroshotsemanticsegmentation_tpu_torch.data.transforms import (
        transform_image)
    from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
    from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
    from zeroshotsemanticsegmentation_tpu_torch.ops import (
        block1_fused as b1)
    from zeroshotsemanticsegmentation_tpu_torch.ops import conv7x7 as c7
    from zeroshotsemanticsegmentation_tpu_torch.serving import (
        make_szn_predictor)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    embed = load_class_embeddings("pascal", 20)
    raw = np.random.RandomState(seed).randint(
        0, 256, (images, H, W, 3)).astype(np.uint8)
    x = torch.from_numpy(np.stack([transform_image(r) for r in raw]))

    def labels(dtype):
        model = FCN32s(20, dtype=dtype, fused_block1=True,
                       generator=torch.Generator().manual_seed(seed),
                       device=dev)
        out = make_szn_predictor(model, None, embed, UNSEEN)(x)
        torch.cuda.synchronize()
        return out

    ref = labels(torch.float32)
    _kernels.reset_launch_counts()
    kern = labels(torch.bfloat16)
    k2 = _kernels.launch_counts["block1_fused"]
    fc6 = _kernels.launch_counts["conv7x7_igemm"]
    with mock.patch.object(b1, "block1_op", b1.block1_plain), \
            mock.patch.object(c7, "igemm_route", lambda h, cout: False):
        plain = labels(torch.bfloat16)
    res = {"images": images, "hw": [H, W], "seed": seed,
           "flip_kernels": (kern != ref).float().mean().item(),
           "flip_plain": (plain != ref).float().mean().item(),
           "flip_kernels_vs_plain": (kern != plain).float().mean().item(),
           "block1_fused_launches": k2, "conv7x7_igemm_launches": fc6}
    res["ratio"] = (res["flip_kernels"] / res["flip_plain"]
                    if res["flip_plain"] > 0 else float("inf"))
    log(f"bf16 label flips vs fp32: kernels {res['flip_kernels']:.4e}, "
        f"plain {res['flip_plain']:.4e} (ratio {res['ratio']:.3f}); "
        f"kernels vs plain {res['flip_kernels_vs_plain']:.4e}; K2 launches "
        f"{k2}, fc6 {fc6}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_serving_bar.py needs an NVIDIA GPU "
              "(torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    print(json.dumps(run(args.images, args.seed, log=lambda m: None)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
