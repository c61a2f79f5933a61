"""Checkpoint-export CLI: a port checkpoint -> a reference checkpoint file
(the JAX package's cli/export.py).

Writes a ``torch.save`` file the reference codebase resumes from directly
(train.py:110-136: load_state_dict(strict=False) + optim.load_state_dict):
the weights in the reference's layout (`models.ref_export`) with a fresh
optimizer state in the reference's 16+16 groups, without the port's own
metadata:

    python -m zeroshotsemanticsegmentation_tpu_torch.cli.export \\
        <log dir>/best -o exported_best [--fcn_optim sgd --fcn_lr 1e-10]

``--fcn_optim/--fcn_lr`` default from the run's ``config.yaml`` beside the
checkpoint; they must match the config the reference will resume under (its
loader swaps the saved group hyperparameters in wholesale). The written
file is read back and checked tensor for tensor before the summary line is
printed. An FCN-8s checkpoint is refused: the reference has no FCN-8s.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import sys

import torch

from zeroshotsemanticsegmentation_tpu_torch.models.ref_export import (
    save_reference_checkpoint)
from zeroshotsemanticsegmentation_tpu_torch.models.ref_import import (
    load_reference_checkpoint)
from zeroshotsemanticsegmentation_tpu_torch.train import checkpoint as ckpt


def read_run_config(path: str) -> dict:
    """The run's flat ``config.yaml`` (`utils.logging.dump_yaml`: one
    ``key: value`` a line, strings JSON-quoted) as raw strings, without a
    YAML parser; {} when there is no file."""
    out = {}
    if not osp.isfile(path):
        return out
    with open(path) as f:
        for line in f:
            if ":" not in line or line.lstrip().startswith("#"):
                continue
            k, v = line.split(":", 1)
            v = v.strip()
            out[k.strip()] = json.loads(v) if v.startswith('"') else v
    return out


def export_checkpoint(ckpt_path: str, out_path: str, *,
                      fcn_optim: str | None = None,
                      fcn_lr: float | None = None) -> dict:
    """Port checkpoint file -> reference file at `out_path`; returns the
    saved dict. Epoch, iteration and best mean IoU carry through."""
    if not ckpt.checkpoint_exists(ckpt_path):
        raise FileNotFoundError(f"no checkpoint file at {ckpt_path}")
    restored = ckpt.restore_checkpoint(ckpt_path)
    if fcn_optim is None or fcn_lr is None:
        cfg = read_run_config(osp.join(osp.dirname(osp.abspath(ckpt_path)),
                                       "config.yaml"))
        fcn_optim = fcn_optim or cfg.get("fcn_optim", "sgd")
        fcn_lr = fcn_lr if fcn_lr is not None else float(
            cfg.get("fcn_lr", 1e-10))
    blob = save_reference_checkpoint(
        out_path, restored["params"], epoch=restored["epoch"],
        iteration=restored["iteration"],
        best_mean_iu=restored["best_mean_iu"], fcn_optim=fcn_optim,
        fcn_lr=fcn_lr)
    # the written file must read back to the exact weights before the
    # export counts as done
    back = load_reference_checkpoint(out_path)["params"]
    for key, want in restored["params"].items():
        if key not in back or not torch.equal(back[key], want):
            raise AssertionError(
                f"export round-trip mismatch at {key} — refusing to ship a "
                "corrupt checkpoint")
    return blob


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Export a port checkpoint as a reference torch file")
    p.add_argument("checkpoint",
                   help="port checkpoint file (<log dir>/best or /checkpoint)")
    p.add_argument("-o", "--out", required=True,
                   help="output path for the torch.save file")
    p.add_argument("--fcn_optim", choices=["sgd", "adam"], default=None,
                   help="optimizer the reference will resume with "
                        "(default: the run's config.yaml)")
    p.add_argument("--fcn_lr", type=float, default=None,
                   help="lr for the exported optimizer groups "
                        "(default: the run's config.yaml)")
    args = p.parse_args(argv)

    blob = export_checkpoint(args.checkpoint, args.out,
                             fcn_optim=args.fcn_optim, fcn_lr=args.fcn_lr)
    n_tensors = len(blob["model_state_dict"])
    print(f"exported {args.checkpoint} -> {args.out} "
          f"(epoch {blob['epoch']}, iteration {blob['iteration']}, "
          f"best_mean_iu {blob['best_mean_iu']:.4f}, {n_tensors} tensors; "
          "round-trip verified)")


if __name__ == "__main__":
    sys.exit(main())
