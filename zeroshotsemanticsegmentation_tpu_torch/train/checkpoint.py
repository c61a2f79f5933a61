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

An FCN-8s run writes the same dict with ``arch: "FCN8s"``: its
``model_state_dict`` holds the reference's key names plus ``score_pool3.*``
and ``score_pool4.*``, with no upscore weights (`ref_export.fcn8s_state_dict`),
and its optimizer state has FCN-8s's parameter groups.

Saves overlap training, as the JAX package's do (its `_save_one`,
`finish_pending`): a save first waits for the previous one, then copies
every tensor to the CPU before it returns (the next optimizer step updates
the weights and Adam's moments in place). A routine save
(``is_best=False``) hands ``torch.save`` and the rename to one background
writer thread and returns; a best save writes in the caller's thread, then
links ``best``. `finish_pending()` waits for the save in flight and raises
its writer's exception, if it had one (a writer error is never lost: the
next save, which calls it first, raises it). It runs at exit, and
`restore_checkpoint` and `checkpoint_exists` call it for a path inside a
log directory with a save in flight; a caller that reads the file any
other way calls it first.

On a mesh (`parallel.mesh`) a save gathers fc6 / fc7 and their optimizer
moments over 'model' on every rank, rank 0 alone writes the same file a
one-device run writes (it owns the writer), and every rank then waits at a
barrier, so no rank reads or links a file rank 0 is still linking.
`finish_pending(mesh)` waits for rank 0's writer and then meets every rank
at a barrier; the exit hook is local (the process group may be gone). A
restore reads the full file on every rank and keeps this rank's shards.
"""

from __future__ import annotations

import atexit
import os
import os.path as osp
import shutil
import threading
from typing import Mapping

import torch
import torch.distributed as dist

from zeroshotsemanticsegmentation_tpu_torch.models.ref_export import (
    ARCH, ARCH_FCN8S, fcn8s_state_dict, reference_state_dict_from_params)
from zeroshotsemanticsegmentation_tpu_torch.models.ref_import import (
    load_reference_checkpoint)
from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
    TP_RULES, gather_opt_state, gather_params, shard_params)


def _to_cpu(obj):
    """Every tensor in a nest of dicts, lists and tuples as a CPU copy."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


# the save in flight: {"thread", "dir", "error"}, or None
_pending: dict | None = None


def finish_pending(mesh=None) -> None:
    """Waits until the save in flight (if any) is on disk, and raises the
    exception its writer raised. With `mesh`, every rank then meets at a
    barrier (rank 0 owns the writer)."""
    global _pending
    pending, _pending = _pending, None
    if pending is not None:
        pending["thread"].join()
        if pending["error"] is not None:
            raise pending["error"]
    if mesh is not None:
        dist.barrier()


# a process that exits with a save in flight still leaves a whole file
atexit.register(finish_pending)


def _write(blob: dict, path: str) -> None:
    torch.save(blob, path + ".tmp")
    os.replace(path + ".tmp", path)


def _start_writer(blob: dict, path: str) -> None:
    """Writes `blob` to `path` on the background writer thread."""
    global _pending
    pending = {"dir": osp.dirname(path), "error": None}

    def run():
        try:
            _write(blob, path)
        except BaseException as e:  # noqa: BLE001 — raised by finish_pending
            pending["error"] = e

    pending["thread"] = threading.Thread(target=run, name="checkpoint-writer",
                                         daemon=True)
    _pending = pending
    pending["thread"].start()


def _finish_for(path: str) -> None:
    """finish_pending() when `path` lies inside the directory of the save
    in flight."""
    pending = _pending
    if pending is not None and (path == pending["dir"] or path.startswith(
            pending["dir"] + os.sep)):
        finish_pending()


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
                    upscore_trained: bool = False, mesh=None,
                    optim_param_names=None) -> None:
    """Write ``<log_dir>/checkpoint`` and, when `is_best`, link ``best``
    to it; a routine save returns once its tensors are copied to the CPU
    and writes the file in the background (`finish_pending`). `model_state`
    is the port's FCN32s or FCN8s state dict (told apart by the skip
    heads), `optim_state` an optimizer's ``state_dict()``. With `mesh`,
    every rank calls it with its shards; `optim_param_names`
    (`parallel.mesh.opt_param_names`) names the optimizer's parameters,
    None for a state without TP shards."""
    finish_pending()  # the previous save lands (or raises) first
    if mesh is not None:
        model_state = gather_params(model_state, mesh)
        if optim_param_names is not None:
            optim_state = gather_opt_state(optim_state, optim_param_names,
                                           mesh)
        if mesh.rank == 0:
            save_checkpoint(log_dir, model_state=model_state,
                            optim_state=optim_state, epoch=epoch,
                            iteration=iteration, best_mean_iu=best_mean_iu,
                            is_best=is_best, upscore_trained=upscore_trained)
        dist.barrier()
        return
    fcn8s = "score_pool3.weight" in model_state
    blob = {
        "epoch": int(epoch),
        "iteration": int(iteration),
        "arch": ARCH_FCN8S if fcn8s else ARCH,
        "optim_state_dict": _to_cpu(optim_state),
        "model_state_dict": (fcn8s_state_dict(model_state) if fcn8s else
                             reference_state_dict_from_params(model_state)),
        "best_mean_iu": float(best_mean_iu),
        "upscore_trained": bool(upscore_trained),
    }
    base = osp.abspath(log_dir)
    os.makedirs(base, exist_ok=True)
    path = osp.join(base, "checkpoint")
    if not is_best:
        _start_writer(blob, path)
        return
    # the link needs the whole file: a best save blocks
    _write(blob, path)
    _link_copy(path, osp.join(base, "best"))


def restore_checkpoint(path: str,
                       params: Mapping[str, torch.Tensor] | None = None,
                       mesh=None) -> dict:
    """'<log_dir>/best' or '<log_dir>/checkpoint' (or a reference file) as
    ``{arch, epoch, iteration, best_mean_iu, params, opt_state,
    upscore_trained, skipped_keys}``, `params` the port's state dict (CPU
    tensors), merged into the model's state dict `params` when given
    (`models.ref_import.load_reference_checkpoint`). With `mesh`, `params`
    holds this rank's shards, and so do the merged fc6 / fc7; `opt_state`
    stays full (`parallel.mesh.shard_opt_state` shards it)."""
    path = osp.abspath(path)
    _finish_for(path)
    if mesh is None or params is None:
        return load_reference_checkpoint(path, params)
    # full-shape stand-ins (no memory: expanded zeros) for the shape check
    full = {k: (v.new_zeros(()).expand(
        *[n * (mesh.model_size if d == TP_RULES[k] else 1)
          for d, n in enumerate(v.shape)]) if k in TP_RULES else v)
        for k, v in params.items()}
    out = load_reference_checkpoint(path, full)
    loaded = {k: v for k, v in out["params"].items()
              if k in TP_RULES and v is not full[k]}
    out["params"] = {**out["params"], **{k: params[k] for k in TP_RULES
                                         if k in params},
                     **shard_params(loaded, mesh)}
    return out


def checkpoint_exists(path: str) -> bool:
    path = osp.abspath(path)
    _finish_for(path)
    return osp.isfile(path)
