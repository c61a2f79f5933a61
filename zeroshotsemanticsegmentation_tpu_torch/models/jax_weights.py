"""Weights from the JAX package's parameter trees.

The tree is a mapping {module: {"kernel": HWIO array, "bias": array}} of
numpy arrays (convert a flax tree with `jax.tree.map(np.asarray, params)`
first; this module never imports JAX). Layout rules (the JAX package's
models/ref_export.py):

  Conv2d weight          (O, I, kh, kw) = kernel.transpose(3, 2, 0, 1)
  ConvTranspose2d weight (I, O, kh, kw) = kernel.transpose(2, 3, 0, 1)
    (`seenmask_upscore`, whose kernel is HWIO (64, 64, 2, 2))
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def state_dict_from_jax_params(params: Mapping[str, Mapping]) -> dict:
    """JAX FCN32s param tree (numpy leaves) -> the port's `state_dict`."""
    sd = {}
    for name, leaves in params.items():
        kernel = np.asarray(leaves["kernel"], dtype=np.float32)
        if name == "seenmask_upscore":
            sd[f"{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(kernel.transpose(2, 3, 0, 1)))
            continue
        sd[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.asarray(leaves["bias"], dtype=np.float32).copy())
    return sd


def load_jax_params(model: torch.nn.Module,
                    params: Mapping[str, Mapping]) -> torch.nn.Module:
    """Load a JAX param tree into `model` with `strict=True`: a missing or
    an unexpected key raises."""
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return model
