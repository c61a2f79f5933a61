"""Training: the stage-1 optimizer, train state and train step."""

from zeroshotsemanticsegmentation_tpu_torch.train.optim import (
    make_fcn_optimizer)
from zeroshotsemanticsegmentation_tpu_torch.train.state import TrainState
from zeroshotsemanticsegmentation_tpu_torch.train.steps import (
    make_fcn_train_step)

__all__ = ["make_fcn_optimizer", "TrainState", "make_fcn_train_step"]
