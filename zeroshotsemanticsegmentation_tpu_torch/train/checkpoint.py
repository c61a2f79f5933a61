"""Checkpoints in the reference's ``torch.save`` format, with its
every-eval + best semantics (the JAX package's train/checkpoint.py, which
writes orbax directories instead).

Reference (trainer_fcn.py:274-292): after every validation, save
``{epoch, iteration, arch, optim_state_dict, model_state_dict,
best_mean_iu}`` to ``<log_dir>/checkpoint`` and copy it to
``<log_dir>/best`` when mean IoU improved; a resume restores the model, the
optimizer and the counters (train.py:110-116).

Here the file also records ``upscore_trained``: whether stage 2 has trained
``seenmask_upscore`` (reference train.py:304-307), which decides whether
validation may take the fused bilinear-gate kernel. It is metadata because
reading the weight's values back from the card would make the host wait.

``model_state_dict`` is the reference's (`models.ref_export`), and
``optim_state_dict`` is torch's own optimizer state: for stage 1 the
reference's 16+16 param groups, so a resume restores Adam's moments
exactly. Tensors are copied to the CPU once per save; the file is written
under a temporary name and renamed, and ``best`` is a hard link to it, so a
later save (a new file) never changes ``best``. Being single ``torch.save``
files, these checkpoints are what the JAX package reads as reference
checkpoints (its ref_import.is_reference_checkpoint).
"""

from __future__ import annotations

import os
import os.path as osp
import shutil
from typing import Mapping

import torch

from zeroshotsemanticsegmentation_tpu_torch.models.ref_export import (
    ARCH, reference_state_dict_from_params)
from zeroshotsemanticsegmentation_tpu_torch.models.ref_import import (
    load_reference_checkpoint)


def _to_cpu(obj):
    """Every tensor in a nest of dicts, lists and tuples as a CPU copy."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _link_copy(src: str, dst: str) -> None:
    """`dst` becomes a hard link to `src` (a copy where the file system has
    no hard links), replacing what was there."""
    tmp = dst + ".tmp"
    if osp.lexists(tmp):
        os.remove(tmp)
    try:
        os.link(src, tmp)
    except OSError:
        shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def save_checkpoint(log_dir: str, *, model_state: Mapping[str, torch.Tensor],
                    optim_state: dict, epoch: int, iteration: int,
                    best_mean_iu: float, is_best: bool,
                    upscore_trained: bool = False) -> None:
    """Write ``<log_dir>/checkpoint`` and, when `is_best`, link ``best``
    to it. `model_state` is the port's FCN32s state dict, `optim_state` an
    optimizer's ``state_dict()``."""
    blob = {
        "epoch": int(epoch),
        "iteration": int(iteration),
        "arch": ARCH,
        "optim_state_dict": _to_cpu(optim_state),
        "model_state_dict": reference_state_dict_from_params(model_state),
        "best_mean_iu": float(best_mean_iu),
        "upscore_trained": bool(upscore_trained),
    }
    base = osp.abspath(log_dir)
    os.makedirs(base, exist_ok=True)
    path = osp.join(base, "checkpoint")
    torch.save(blob, path + ".tmp")
    os.replace(path + ".tmp", path)
    if is_best:
        _link_copy(path, osp.join(base, "best"))


def restore_checkpoint(path: str) -> dict:
    """'<log_dir>/best' or '<log_dir>/checkpoint' (or a reference file) as
    ``{arch, epoch, iteration, best_mean_iu, params, opt_state,
    upscore_trained, skipped_keys}``, `params` the port's state dict (CPU
    tensors)."""
    return load_reference_checkpoint(osp.abspath(path))


def checkpoint_exists(path: str) -> bool:
    return osp.isfile(osp.abspath(path))
