"""Training: the optimizers, train state, the train and eval steps of both
stages, checkpoints and the two trainers."""

from zeroshotsemanticsegmentation_tpu_torch.train.optim import (
    make_fcn_optimizer, make_seenmask_optimizer)
from zeroshotsemanticsegmentation_tpu_torch.train.state import TrainState
from zeroshotsemanticsegmentation_tpu_torch.train.steps import (
    make_fcn_eval_step, make_fcn_train_step, make_seenmask_eval_step,
    make_seenmask_train_step, make_szn_eval_step)
from zeroshotsemanticsegmentation_tpu_torch.train.trainer_fcn import (
    FCNTrainer)
from zeroshotsemanticsegmentation_tpu_torch.train.trainer_seenmask import (
    SeenmaskTrainer)

__all__ = ["make_fcn_optimizer", "make_seenmask_optimizer", "TrainState",
           "make_fcn_train_step", "make_seenmask_train_step",
           "make_fcn_eval_step", "make_szn_eval_step",
           "make_seenmask_eval_step", "FCNTrainer", "SeenmaskTrainer"]
