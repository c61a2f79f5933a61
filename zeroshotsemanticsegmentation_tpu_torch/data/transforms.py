"""Image transforms (reference pascal_dataset.py:39,138-154) and bucketing.

RGB -> BGR, subtract the caffe BGR mean, keep HWC. `prepare_images` is the
device-side form used by serving and the steps: a uint8 RGB batch is
normalized on the device, float32 input passes through unchanged.
`pad_to_bucket` zero-pads an image (after mean subtraction, so value 0 is
the convolutions' zero padding) and (-1)-pads its label to one static
bucket shape; every loss and metric masks label -1, so padding changes
nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from zeroshotsemanticsegmentation_tpu_torch import PAD_LABEL, device_const

# reference pascal_dataset.py:39 / context_dataset.py:51
MEAN_BGR = np.array([104.00698793, 116.66876762, 122.67891434])

# VOC/SBD/Context images are at most 500 px on a side: one 512 bucket
# covers them (h5 = 23 -> fc6 output 17)
DEFAULT_BUCKET = (512, 512)


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


def batch_image_rgb(image_hwc: np.ndarray) -> np.ndarray:
    """One host batch image (either feed dtype) -> uint8 RGB for viz."""
    img = np.asarray(image_hwc)
    if img.dtype == np.uint8:
        return img
    return untransform_image(img)


def untransform_image(img_bgr: np.ndarray) -> np.ndarray:
    """float32 BGR mean-subtracted HWC -> uint8 RGB HWC (visualization)."""
    img = img_bgr.astype(np.float64) + MEAN_BGR
    # rint: the float32 image is ~1e-5 off integer values
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img[:, :, ::-1]


def pad_to_bucket(img: np.ndarray, lbl: np.ndarray,
                  bucket_hw: tuple[int, int] = DEFAULT_BUCKET
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad image / (-1)-pad label to (bucket_h, bucket_w), top-left
    anchored."""
    bh, bw = bucket_hw
    h, w = lbl.shape
    if h > bh or w > bw:
        raise ValueError(f"image ({h},{w}) exceeds bucket ({bh},{bw})")
    pimg = np.zeros((bh, bw, img.shape[2]), dtype=img.dtype)
    pimg[:h, :w] = img
    plbl = np.full((bh, bw), PAD_LABEL, dtype=lbl.dtype)
    plbl[:h, :w] = lbl
    return pimg, plbl
