"""zeroshotsemanticsegmentation_tpu_torch — the SZN system in PyTorch for one
NVIDIA H100.

The PyTorch/CUDA counterpart of ``zeroshotsemanticsegmentation_tpu``: same
module names (``data/``, ``ops/``, ``models/``, ``serving.py``), same public
layouts (images ``(B,H,W,3)`` and heads ``(B,h,w,C)``, NHWC), and hand-written
CUDA kernels (``csrc/``) where the JAX package has Pallas kernels. It imports
``torch``, numpy and the standard library only.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

PAD_LABEL = -1  # ignore label: the reference maps 255 -> -1


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.

    Raises when a CUDA device is asked for and no card is present: the port
    never falls back to the CPU on its own; the CPU runs only when asked for.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


_DEVICE_CONSTS: dict = {}
_DEVICE_CONSTS_MAX = 256


def device_const(key, make, device) -> torch.Tensor:
    """The host data `make()` returns (a numpy array or CPU tensor) as a
    tensor on `device`, copied there once per (key, device) and kept: a copy
    from host memory on every call would wait for the device. Made outside
    inference mode, so one copy serves inference and training. The oldest
    entry goes once 256 are kept."""
    k = (key, str(device))
    t = _DEVICE_CONSTS.get(k)
    if t is None:
        with torch.inference_mode(False):
            t = torch.as_tensor(make(), device=device)
        if len(_DEVICE_CONSTS) >= _DEVICE_CONSTS_MAX:
            del _DEVICE_CONSTS[next(iter(_DEVICE_CONSTS))]
        _DEVICE_CONSTS[k] = t
    return t
