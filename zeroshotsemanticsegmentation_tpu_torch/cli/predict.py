"""Batch SZN inference CLI: images in, per-pixel label maps out (the JAX
package's cli/predict.py).

Point it at a trained checkpoint and a directory of images; it writes one
label PNG per image (pixel value = class id, cropped to the image's size)
and, with --viz, a color overlay:

    python -m zeroshotsemanticsegmentation_tpu_torch.cli.predict \\
        --checkpoint <log dir>/best --images <dir> --out <dir> \\
        -c 15 [--viz] [--batch_size 8] [--int8] [--device cuda]
        [--arch fcn32s|fcn8s|deeplabv2_r101]

The preset (-c) supplies the dataset, embeddings and unseen split, as in
training; the checkpoint's `upscore_trained` routes the seenmask gate
(resolved from the weights for a file that does not record it). Checkpoints
are the port's own files and the reference's ``torch.save`` files. The JAX
package's orbax checkpoint directories are not read (that needs orbax):
convert one with the JAX package's cli.export first.

The batching works on arrays (`predict_arrays`: pad each image to the
static bucket, pad the tail batch to the static batch, predict, crop), so
it runs without Pillow; only the PNG reading and writing around it needs
Pillow, imported when `run_predict` runs.

`--arch deeplabv2_r101` serves DeepLab-v2 ResNet-101 with the SZN heads
(`models/deeplab.py`) from a file holding its state dict (bare, or under
``model_state_dict``; torchvision's module names), in a bucket whose sides
are multiples of 8 (its output stride); the reference's FCN checkpoints do
not apply to it.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys

import numpy as np
import torch

from zeroshotsemanticsegmentation_tpu_torch import resolve_device
from zeroshotsemanticsegmentation_tpu_torch.cli.train import _merge_params
from zeroshotsemanticsegmentation_tpu_torch.configs import get_config
from zeroshotsemanticsegmentation_tpu_torch.data.assets import (
    class_names, load_class_embeddings)
from zeroshotsemanticsegmentation_tpu_torch.models import (
    DeepLabV2ResNet101, FCN8s, FCN32s)
from zeroshotsemanticsegmentation_tpu_torch.models.ref_import import (
    is_reference_checkpoint, load_reference_checkpoint)
from zeroshotsemanticsegmentation_tpu_torch.serving import make_szn_predictor
from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import span
from zeroshotsemanticsegmentation_tpu_torch.viz import label2rgb

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


class _StdoutLogger:
    """The logger protocol of `_merge_params`' partial-load report."""

    def stdout(self, msg: str) -> None:
        print(msg)


def _list_images(path: str) -> list[str]:
    if osp.isfile(path):
        return [path]
    files = [osp.join(path, f) for f in sorted(os.listdir(path))
             if f.lower().endswith(_IMG_EXTS)]
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    return files


def build_predictor(cfg, checkpoint_path: str, *, int8: bool = False,
                    device: str | torch.device = "cuda"):
    """(predict, class_names, upscore_trained) from a config and a
    checkpoint file (the port's or the reference's), on `device`."""
    dev = resolve_device(device)
    if not is_reference_checkpoint(checkpoint_path):
        raise FileNotFoundError(
            f"{checkpoint_path} is not a checkpoint file: the port reads "
            "its own checkpoints and the reference's torch.save files; the "
            "JAX package's orbax directories are not read (convert one "
            "with its cli.export)")
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else \
        torch.float32
    embeddings = load_class_embeddings(cfg.dataset, cfg.embed_dim,
                                       n_classes=cfg.num_classes)
    names = class_names(cfg.dataset, cfg.num_classes)
    if cfg.arch == "deeplabv2_r101":
        if cfg.bucket[0] % 8 or cfg.bucket[1] % 8:
            raise ValueError(f"deeplabv2_r101 serves buckets whose sides are "
                             f"multiples of 8 (its output stride), got "
                             f"{tuple(cfg.bucket)}")
        model = DeepLabV2ResNet101(
            cfg.head_channels, dtype=dtype, channel_scale=cfg.channel_scale,
            generator=torch.Generator().manual_seed(cfg.seed), device=dev)
        blob = torch.load(checkpoint_path, map_location="cpu",
                          weights_only=True)
        merged = _merge_params(model.state_dict(),
                               blob.get("model_state_dict", blob),
                               logger=_StdoutLogger())
        predict = make_szn_predictor(model, merged, embeddings,
                                     list(cfg.val_unseen), int8=int8,
                                     device=dev)
        return predict, names, False
    model_cls = FCN8s if cfg.arch == "fcn8s" else FCN32s
    model = model_cls(cfg.head_channels, dtype=dtype,
                      channel_scale=cfg.channel_scale,
                      prune_pad=cfg.prune_pad,
                      fused_block1=cfg.fused_block1 == "on" or (
                          cfg.fused_block1 == "auto" and dev.type == "cuda"),
                      generator=torch.Generator().manual_seed(cfg.seed),
                      device=dev)
    restored = load_reference_checkpoint(checkpoint_path, model.state_dict())
    if restored["skipped_keys"]:
        print("skipped unknown checkpoint keys: "
              + ", ".join(restored["skipped_keys"]))
    # strict=False merge with shape checks and a report of what it skipped:
    # a checkpoint of another width or architecture fails loudly here
    merged = _merge_params(model.state_dict(), restored["params"],
                           logger=_StdoutLogger())
    upscore_trained = restored["upscore_trained"]
    predict = make_szn_predictor(
        model, merged, embeddings, list(cfg.val_unseen), int8=int8,
        upscore_trained=upscore_trained, device=dev)
    return predict, names, bool(upscore_trained)


def predict_arrays(predict, images, *, bucket, batch_size: int,
                   names=None) -> list[np.ndarray]:
    """Labels of uint8 RGB (h, w, 3) `images` of any size within `bucket`:
    each is zero-padded bottom/right to the static bucket (the convolutions'
    zero padding keeps the interior as it is), the batches are filled to
    `batch_size` with zero images so one static shape serves them all, and
    each image's int32 (h, w) labels are cropped back. An image larger than
    the bucket raises before anything of its batch is predicted; `names`
    label the images in that message. Each batch is one `serve.request`
    span (`utils.profiling`) counting its images' own pixels and the
    pixels computed."""
    bh, bw = bucket
    names = names or [f"image {i}" for i in range(len(images))]
    out = []
    for i in range(0, len(images), batch_size):
        chunk = images[i:i + batch_size]
        with span("serve.request", images=len(chunk),
                  real_px=sum(img.shape[0] * img.shape[1] for img in chunk),
                  computed_px=batch_size * bh * bw):
            with span("serve.pad"):
                batch = np.zeros((batch_size, bh, bw, 3), np.uint8)
                for j, img in enumerate(chunk):
                    if img.shape[0] > bh or img.shape[1] > bw:
                        raise ValueError(
                            f"{names[i + j]}: {img.shape[:2]} exceeds the "
                            f"bucket {(bh, bw)} — raise it with --bucket")
                    batch[j, :img.shape[0], :img.shape[1]] = img
            labels = predict(torch.from_numpy(batch))
            with span("serve.d2h"):
                labels = labels.cpu().numpy()
            with span("serve.crop"):
                out.extend(lb[:img.shape[0], :img.shape[1]]
                           for img, lb in zip(chunk, labels))
    return out


def run_predict(cfg, *, checkpoint: str, images: str, out_dir: str,
                batch_size: int = 8, viz: bool = False, int8: bool = False,
                verbose: bool = True,
                device: str | torch.device = "cuda") -> list[str]:
    """Predict label maps for every image; returns the written paths."""
    import PIL.Image

    predict, names, trained = build_predictor(cfg, checkpoint, int8=int8,
                                              device=device)
    if verbose:
        print(f"predictor ready ({len(names)} classes, "
              f"upscore_trained={trained})")
    files = _list_images(images)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for i in range(0, len(files), batch_size):
        chunk = files[i:i + batch_size]
        imgs = [np.asarray(PIL.Image.open(f).convert("RGB"), np.uint8)
                for f in chunk]
        labels = predict_arrays(predict, imgs, bucket=cfg.bucket,
                                batch_size=batch_size, names=chunk)
        for f, img, lb in zip(chunk, imgs, labels):
            stem = osp.splitext(osp.basename(f))[0]
            pred = lb.astype(np.uint8)
            p = osp.join(out_dir, f"{stem}_pred.png")
            PIL.Image.fromarray(pred).save(p)
            written.append(p)
            if viz:
                ov = label2rgb(pred.astype(np.int32), img,
                               n_labels=len(names))
                pv = osp.join(out_dir, f"{stem}_viz.png")
                PIL.Image.fromarray(ov.astype(np.uint8)).save(pv)
                written.append(pv)
        if verbose:
            print(f"  {min(i + batch_size, len(files))}/{len(files)}")
    return written


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Batch SZN inference: images -> label PNGs")
    p.add_argument("-c", "--config", type=int, default=15,
                   help="preset supplying dataset/embeddings/unseen split")
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint file: the port's (<log dir>/best) or a "
                        "reference torch.save file; JAX orbax directories "
                        "are not read")
    p.add_argument("--images", required=True, help="image file or directory")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--bucket", type=int, default=None,
                   help="static HxW bucket (default: preset's)")
    p.add_argument("--context_classes", type=int, choices=[33, 59])
    p.add_argument("--arch", type=str,
                   choices=["fcn32s", "fcn8s", "deeplabv2_r101"],
                   help="model architecture (default: preset's; must match "
                        "the checkpoint)")
    p.add_argument("--viz", action="store_true",
                   help="also write color overlays")
    p.add_argument("--int8", action="store_true",
                   help="opt-in int8 quantized serving path (FCN-32s)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to run on (default cuda; cpu runs the "
                        "kernels' plain versions)")
    args = p.parse_args(argv)

    overrides = {"load_fcn_path": args.checkpoint}
    if args.bucket is not None:
        overrides["bucket"] = (args.bucket, args.bucket)
    if args.context_classes is not None:
        overrides["context_classes"] = args.context_classes
    if args.arch is not None:
        overrides["arch"] = args.arch
    cfg = get_config(args.config, **overrides)
    written = run_predict(cfg, checkpoint=args.checkpoint, images=args.images,
                          out_dir=args.out, batch_size=args.batch_size,
                          viz=args.viz, int8=args.int8, device=args.device)
    print(f"wrote {len(written)} files to {args.out}")


if __name__ == "__main__":
    sys.exit(main())
