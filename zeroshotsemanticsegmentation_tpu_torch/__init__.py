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
