"""Experiment configuration: `Config`, the reference presets and their
validation."""

from zeroshotsemanticsegmentation_tpu_torch.configs.presets import (
    PRESETS, Config, get_config, run_name, validate_config)

__all__ = ["Config", "PRESETS", "get_config", "validate_config", "run_name"]
