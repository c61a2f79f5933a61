"""Run logging (stdout, CSV, TensorBoard) and step timing."""

from zeroshotsemanticsegmentation_tpu_torch.utils.logging import RunLogger
from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import (
    StepTimer, profile_trace)

__all__ = ["RunLogger", "StepTimer", "profile_trace"]
