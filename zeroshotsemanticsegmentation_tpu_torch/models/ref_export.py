"""The port's weights as a reference SZN checkpoint (the JAX package's
models/ref_export.py).

The reference's checkpoint format is ``{epoch, iteration, arch,
optim_state_dict, model_state_dict, best_mean_iu}`` (trainer_fcn.py:281-288),
resumed by ``torch.load`` + ``model.load_state_dict(strict=False)`` +
``optim.load_state_dict`` (train.py:110-136). The port's state dict already
has the reference's key names and layouts; the export adds the one key the
port lacks, ``upscore.weight``: the reference registers the FCN upscore as a
ConvTranspose2d(n, n, 64) weight its optimizer never updates
(train.py:324-327), so it holds its bilinear init, and that is what is
written. Keys come in the reference's registration order (models.py:43-98).

The reference's optimizer has two param groups: the 16 Conv2d weights, then
the 16 biases at 2x lr (train.py:125-133, 316-327), which is the order of the
port's `make_fcn_optimizer`, so its ``state_dict()`` is in that layout as it
is.
"""

from __future__ import annotations

from typing import Mapping

import torch

from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import (
    CONV_MODULES)
from zeroshotsemanticsegmentation_tpu_torch.ops.bilinear import (
    bilinear_upsampling_kernel)

ARCH = "FCN32s"
# reference FCN32s registration order (models.py:43-98)
_STATE_DICT_ORDER = CONV_MODULES[:-1] + ("upscore",) + CONV_MODULES[-1:] + (
    "seenmask_upscore",)
# the two trained param groups: every Conv2d but the seenmask head
# (train.py:317-318); 16 modules -> 16 weights + 16 biases
_OPTIM_MODULES = tuple(m for m in CONV_MODULES if m != "seenmask_score")


def reference_state_dict_from_params(
        state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The port's FCN32s `state_dict` -> the reference's
    ``model_state_dict``: fp32 CPU copies in the reference's order, plus
    ``upscore.weight`` at its bilinear init."""
    want = {f"{m}.{s}" for m in CONV_MODULES for s in ("weight", "bias")}
    want.add("seenmask_upscore.weight")
    if set(state_dict) != want:
        raise ValueError(
            "not an FCN32s state dict: missing "
            f"{sorted(want - set(state_dict))}, extra "
            f"{sorted(set(state_dict) - want)}")
    sd = {}
    for name in _STATE_DICT_ORDER:
        if name == "upscore":
            n = int(state_dict["score_fr.weight"].shape[0])
            sd["upscore.weight"] = torch.from_numpy(
                bilinear_upsampling_kernel(n, 64).transpose(2, 3, 0, 1)
                .copy())
            continue
        for leaf in ("weight",) if name == "seenmask_upscore" else (
                "weight", "bias"):
            sd[f"{name}.{leaf}"] = state_dict[f"{name}.{leaf}"].detach().to(
                "cpu", torch.float32, copy=True)
    return sd


def reference_optim_state_dict(fcn_optim: str, fcn_lr: float) -> dict:
    """A state dict the reference's freshly built optimizer accepts
    (train.py:125-133): empty state, the 16+16 groups with the
    reference's hyperparameters."""
    weights = [torch.zeros(1, requires_grad=True) for _ in _OPTIM_MODULES]
    biases = [torch.zeros(1, requires_grad=True) for _ in _OPTIM_MODULES]
    if fcn_optim == "sgd":
        optim = torch.optim.SGD(
            [{"params": weights},
             {"params": biases, "lr": fcn_lr * 2, "weight_decay": 0}],
            lr=fcn_lr, momentum=.99, weight_decay=0.0005)
    elif fcn_optim == "adam":
        optim = torch.optim.Adam(
            [{"params": weights}, {"params": biases, "lr": fcn_lr * 2}],
            lr=fcn_lr)
    else:
        raise ValueError(f"fcn_optim must be 'sgd' or 'adam', got "
                         f"{fcn_optim!r}")
    return optim.state_dict()


def save_reference_checkpoint(path: str,
                              state_dict: Mapping[str, torch.Tensor], *,
                              epoch: int = 0, iteration: int = 0,
                              best_mean_iu: float = 0.0,
                              fcn_optim: str = "sgd",
                              fcn_lr: float = 1e-10) -> dict:
    """Write a reference-format checkpoint file with a fresh optimizer
    state (trainer_fcn.py:281-288); returns the saved dict."""
    blob = {
        "epoch": int(epoch),
        "iteration": int(iteration),
        "arch": ARCH,
        "optim_state_dict": reference_optim_state_dict(fcn_optim, fcn_lr),
        "model_state_dict": reference_state_dict_from_params(state_dict),
        "best_mean_iu": float(best_mean_iu),
    }
    torch.save(blob, path)
    return blob
