"""The stage-1 optimizer with the reference's parameter groups
(train.py:126-133, 302-331; the JAX package's train/optim.py):

* conv kernels ("weight"): the base lr; under SGD also weight decay 5e-4;
* conv biases: 2x lr, never decayed;
* `seenmask_score` and `seenmask_upscore`: in no group, so stage 1 leaves
  them exactly as they are (the reference skips the seenmask head and every
  ConvTranspose weight).

torch's Adam (eps outside the square root, bias-corrected) and SGD (momentum
into the buffer, lr applied after, decay added to the gradient) follow the
same update rules as optax's `adam` and `add_decayed_weights` + `sgd`.
"""

from __future__ import annotations

import torch

FROZEN_MODULES = ("seenmask_score", "seenmask_upscore")


def make_fcn_optimizer(model: torch.nn.Module, *, optim: str, lr: float,
                       momentum: float = 0.99,
                       weight_decay: float = 5e-4) -> torch.optim.Optimizer:
    """Stage-1 optimizer (reference train.py:126-133)."""
    weights, biases = [], []
    for name, p in model.named_parameters():
        if name.split(".")[0] not in FROZEN_MODULES:
            (biases if name.endswith("bias") else weights).append(p)
    if optim == "sgd":
        return torch.optim.SGD(
            [{"params": weights, "lr": lr, "weight_decay": weight_decay},
             {"params": biases, "lr": lr * 2.0, "weight_decay": 0.0}],
            lr=lr, momentum=momentum)
    if optim == "adam":
        return torch.optim.Adam(
            [{"params": weights, "lr": lr},
             {"params": biases, "lr": lr * 2.0}], lr=lr)
    raise ValueError(f"unknown optimizer {optim!r}")
