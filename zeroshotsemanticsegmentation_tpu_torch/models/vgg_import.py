"""VGG16 pretrained weights into the port's FCN32s (the JAX package's
models/vgg_import.py).

The reference initializes its conv stack from a caffe-converted torchvision
VGG16 (models.py:162-210): conv weights are copied 1:1, and the fc6/fc7
linear layers (25088 -> 4096, 4096 -> 4096) are viewed as 7x7 / 1x1 convs
(models.py:189-193). The port keeps torch's OIHW layout, so the surgery is
the two views. The caffe-lineage weights expect BGR input with the mean
subtracted, which is what the data pipeline produces.

The loader takes a local ``.pth`` path or a ``{key: tensor}`` mapping and
downloads nothing itself; `models.pretrained.cached_download_vgg16` fetches
the file (the train CLI calls it for a fresh run without ``--vgg16``).
"""

from __future__ import annotations

from typing import Mapping

import torch

# torchvision vgg16.features indices of the 13 convs, in FCN32s order
_FEATURE_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_CONV_NAMES = (
    "conv1_1", "conv1_2",
    "conv2_1", "conv2_2",
    "conv3_1", "conv3_2", "conv3_3",
    "conv4_1", "conv4_2", "conv4_3",
    "conv5_1", "conv5_2", "conv5_3",
)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", torch.float32)


def vgg16_params_from_torch_state_dict(
        state_dict: Mapping[str, torch.Tensor]) -> dict:
    """A torchvision-style VGG16 state dict -> the FCN32s backbone's
    state-dict entries (conv1_1 ... conv5_3, fc6, fc7; the heads stay as
    they are, as in the reference, models.py:93-98)."""
    out = {}
    for name, idx in zip(_CONV_NAMES, _FEATURE_CONV_INDICES):
        out[f"{name}.weight"] = _f32(state_dict[f"features.{idx}.weight"])
        out[f"{name}.bias"] = _f32(state_dict[f"features.{idx}.bias"])
    out["fc6.weight"] = _f32(
        state_dict["classifier.0.weight"]).reshape(4096, 512, 7, 7)
    out["fc6.bias"] = _f32(state_dict["classifier.0.bias"])
    out["fc7.weight"] = _f32(
        state_dict["classifier.3.weight"]).reshape(4096, 4096, 1, 1)
    out["fc7.bias"] = _f32(state_dict["classifier.3.bias"])
    return out


def load_vgg16_into_params(params: Mapping[str, torch.Tensor],
                           source) -> dict:
    """A copy of the state dict `params` with the VGG16 backbone
    overwritten. `source` is a path to a torch ``.pth`` state dict or a
    mapping of tensors; every tensor is shape-checked against `params`."""
    if isinstance(source, (str, bytes)) or hasattr(source, "__fspath__"):
        source = torch.load(source, map_location="cpu", weights_only=True)
    out = dict(params)
    for key, new in vgg16_params_from_torch_state_dict(source).items():
        if key not in out:
            raise KeyError(f"model params missing {key!r}")
        if tuple(out[key].shape) != tuple(new.shape):
            raise ValueError(f"{key}: model shape {tuple(out[key].shape)} "
                             f"!= import shape {tuple(new.shape)}")
        out[key] = new.to(out[key].dtype)
    return out
