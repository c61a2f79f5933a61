"""Image transforms (reference pascal_dataset.py:39,138-154).

RGB -> BGR, subtract the caffe BGR mean, keep HWC. `prepare_images` is the
device-side form used by serving: a uint8 RGB batch is normalized on the
device, float32 input passes through unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from zeroshotsemanticsegmentation_tpu_torch import device_const

# reference pascal_dataset.py:39 / context_dataset.py:51
MEAN_BGR = np.array([104.00698793, 116.66876762, 122.67891434])


def transform_image(img_rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB HWC -> float32 BGR mean-subtracted HWC."""
    img = img_rgb[:, :, ::-1].astype(np.float64)
    img -= MEAN_BGR
    return img.astype(np.float32)


def prepare_images(images: torch.Tensor) -> torch.Tensor:
    """(B,H,W,3) uint8 RGB -> float32 BGR mean-subtracted; other dtypes
    pass through. Matches `transform_image` to float32 precision (uint8 minus
    the float32 mean is one rounding, as in the JAX package)."""
    if images.dtype == torch.uint8:
        mean = device_const("mean_bgr", lambda: MEAN_BGR.astype(np.float32),
                            images.device)
        return images.flip(-1).to(torch.float32) - mean
    return images
