"""Reference SZN checkpoints into the port (the JAX package's
models/ref_import.py).

The reference saves ``{epoch, iteration, arch, optim_state_dict,
model_state_dict, best_mean_iu}`` with ``torch.save`` after every validation
(trainer_fcn.py:281-288) and resumes with
``model.load_state_dict(..., strict=False)`` (train.py:110-116). The port's
own checkpoints (`train/checkpoint.py`) are files of that format, so one
reader serves both.

The port's FCN32s keeps the reference's module names and layouts (Conv2d
weights OIHW, the seenmask ConvTranspose2d IOHW), so no layout surgery is
needed. One key differs: the reference registers the FCN ``upscore`` as a
ConvTranspose2d weight its optimizer never updates (train.py:324-327); the
port computes that upsample as a fixed bilinear function. The import
therefore checks that ``upscore.weight`` still equals its bilinear init and
refuses the checkpoint otherwise, as the JAX import does.

FCN-8s (no ``seenmask_upscore``, two skip heads) reads the same files: a
reference FCN-32s file merged into an FCN8s state dict leaves the skip
heads as they are and drops a ``seenmask_upscore`` still at its bilinear
init, which FCN-8s computes as a fixed function; a stage-2-trained one it
refuses (JAX ref_import.py:130-152). The port's FCN-8s checkpoints carry
``score_pool3`` / ``score_pool4`` too; merged into a state dict without
them, they are reported as skipped.

Unlike the JAX import, the optimizer state comes back as it was saved:
torch's own ``state_dict()``, which the port's torch optimizers load as
they are (the JAX package cannot convert torch's Adam moments).
"""

from __future__ import annotations

import os.path as osp
from typing import Any, Mapping

import numpy as np
import torch

from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import (
    CONV_MODULES)
from zeroshotsemanticsegmentation_tpu_torch.models.fcn8s import SKIP_MODULES
from zeroshotsemanticsegmentation_tpu_torch.ops.bilinear import (
    bilinear_upsampling_kernel)
from zeroshotsemanticsegmentation_tpu_torch.serving import (
    upscore_trained_numeric)

_UPSCORE = "upscore.weight"
_SEEN_UPSCORE = "seenmask_upscore.weight"
# FCN-8s's skip heads, in the port's FCN-8s checkpoints
SKIP_KEYS = frozenset(f"{m}.{s}" for m in SKIP_MODULES
                      for s in ("weight", "bias"))
KNOWN_KEYS = frozenset(
    [f"{m}.{s}" for m in CONV_MODULES for s in ("weight", "bias")]
    + [_UPSCORE, _SEEN_UPSCORE]) | SKIP_KEYS


def is_reference_checkpoint(path: str) -> bool:
    """Reference checkpoints are single ``torch.save`` files named
    ``checkpoint`` / ``best`` (trainer_fcn.py:281-292); so are the port's."""
    return osp.isfile(path)


def _bilinear_iohw(channels: int, kernel_size: int) -> np.ndarray:
    return bilinear_upsampling_kernel(
        channels, kernel_size).transpose(2, 3, 0, 1)


def szn_params_from_reference_state_dict(
        state_dict: Mapping[str, Any],
        params: Mapping[str, torch.Tensor] | None = None
) -> tuple[dict, bool]:
    """Merge a reference ``model_state_dict`` into the port's state dict
    `params` (None: start from nothing and take every known key).

    Returns ``(merged, upscore_trained)``. Mirrors
    ``load_state_dict(strict=False)`` (train.py:114): only keys present in
    the state dict are overwritten; a shape that differs from `params`'
    raises. ``upscore.weight`` is checked and dropped.
    """
    out = dict(params) if params is not None else {}
    for key in sorted(KNOWN_KEYS - {_UPSCORE}):
        if key not in state_dict:
            continue
        new = state_dict[key].detach().to("cpu", torch.float32)
        if params is not None:
            if key not in out:
                if key == _SEEN_UPSCORE:
                    _check_gate_droppable(new)
                    continue
                if key in SKIP_KEYS:  # reported by the caller
                    continue
                raise KeyError(f"model params missing {key!r} present in "
                               "the reference checkpoint")
            cur = out[key]
            if tuple(cur.shape) != tuple(new.shape):
                raise ValueError(
                    f"{key}: model shape {tuple(cur.shape)} != reference "
                    f"checkpoint shape {tuple(new.shape)} — architecture "
                    "mismatch (check num_classes/embed_dim and "
                    "channel_scale=1.0)")
            new = new.to(cur.dtype)
        out[key] = new
    if _UPSCORE in state_dict:
        up = state_dict[_UPSCORE].detach().to("cpu", torch.float32).numpy()
        if not np.allclose(up, _bilinear_iohw(up.shape[0], up.shape[2]),
                           rtol=0, atol=1e-6):
            raise ValueError(
                "reference checkpoint's `upscore.weight` differs from its "
                "bilinear init — the reference optimizer never trains it "
                "(train.py:324-327) so this checkpoint was hand-modified; "
                "the port computes the FCN upscore as a fixed bilinear "
                "function and cannot represent a trained kernel")
    return out, upscore_trained_numeric(state_dict)


def _check_gate_droppable(up: torch.Tensor) -> None:
    """A `seenmask_upscore` the target architecture lacks (FCN8s: a fixed
    bilinear seenmask upsample) may be dropped only at its bilinear
    init."""
    k = up.numpy()
    if not np.array_equal(k, _bilinear_iohw(k.shape[0], k.shape[2])):
        raise ValueError(
            "reference checkpoint carries a stage-2-trained "
            "`seenmask_upscore` but the target architecture has no such "
            "parameter (fixed bilinear upsample) — its gate outputs "
            "cannot be reproduced; import into FCN32s instead")


def load_reference_checkpoint(path: str,
                              params: Mapping[str, torch.Tensor] | None = None
                              ) -> dict:
    """Read a ``torch.save`` checkpoint file (the reference's or the
    port's) into ``{arch, epoch, iteration, best_mean_iu, params, opt_state,
    upscore_trained, skipped_keys}``: `params` is the port state dict
    (merged into `params` when given), `opt_state` the file's
    ``optim_state_dict`` (None for a bare state dict). `upscore_trained`
    is the file's own record where it has one (the port's), else read from
    the values. Accepts the full checkpoint dict and a bare
    ``model_state_dict``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if "model_state_dict" in blob:
        state_dict, meta = blob["model_state_dict"], blob
    else:  # bare state dict (keys like 'conv1_1.weight')
        state_dict, meta = blob, {}
    merged, numeric = szn_params_from_reference_state_dict(state_dict,
                                                           params)
    skipped = set(state_dict) - KNOWN_KEYS
    if params is not None:  # skip heads the target has no place for
        skipped |= (set(state_dict) & SKIP_KEYS) - set(params)
    return {
        "arch": str(meta.get("arch", "FCN32s")),
        "epoch": int(meta.get("epoch", 0)),
        "iteration": int(meta.get("iteration", 0)),
        "best_mean_iu": float(meta.get("best_mean_iu", 0.0)),
        "params": merged,
        "opt_state": meta.get("optim_state_dict"),
        "upscore_trained": bool(meta.get("upscore_trained", numeric)),
        "skipped_keys": sorted(skipped),
    }
