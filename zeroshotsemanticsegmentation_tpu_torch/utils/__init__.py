"""Run logging (stdout, CSV, TensorBoard) and tracing."""

from zeroshotsemanticsegmentation_tpu_torch.utils.logging import RunLogger
from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import (
    profile_trace)

__all__ = ["RunLogger", "profile_trace"]
