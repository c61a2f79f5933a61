"""Train state: the model, its optimizer and the iteration counter."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    """What a train step reads and advances. The model's parameters and the
    optimizer's moments are updated in place; `step` counts the steps taken
    (the reference's 'iteration')."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module,
               optimizer: torch.optim.Optimizer) -> "TrainState":
        return cls(model=model, optimizer=optimizer, step=0)
