"""Serving: batched zero-shot segmentation, images in, int32 labels out.

`make_szn_predictor` returns a function from an image batch to label maps
through the fastest pipeline: the model's raw (1/32-resolution) heads feed
the fused projection + upsample + argmax kernel (`ops.szn_fused`), so the
full-resolution score volumes never reach device memory. It runs under
`torch.inference_mode()`.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from zeroshotsemanticsegmentation_tpu_torch import resolve_device
from zeroshotsemanticsegmentation_tpu_torch.data.transforms import (
    prepare_images)
from zeroshotsemanticsegmentation_tpu_torch.ops.bilinear import (
    bilinear_upsampling_kernel, upscore_conv_transpose_cropped)
from zeroshotsemanticsegmentation_tpu_torch.ops.metrics import (
    unseen_mask_vector)
from zeroshotsemanticsegmentation_tpu_torch.ops.szn_fused import (
    infer_labels_szn_fused)

_UPSCORE_KEY = "seenmask_upscore.weight"


def upscore_trained_numeric(state_dict: Mapping[str, torch.Tensor]) -> bool:
    """Whether `seenmask_upscore` drifted from its bilinear init (True) or
    still equals it (False). A state dict without the weight (an
    architecture with a fixed bilinear gate) answers False."""
    up = state_dict.get(_UPSCORE_KEY)
    if up is None:
        return False
    up = up.detach().to("cpu", torch.float32).numpy()
    init = bilinear_upsampling_kernel(up.shape[0], up.shape[2])
    return not np.array_equal(up, init.transpose(2, 3, 0, 1))


def make_szn_predictor(model: torch.nn.Module,
                       params: Mapping[str, torch.Tensor] | None,
                       embeddings, unseen_classes, *,
                       upscore_trained: bool | None = None,
                       device: str | torch.device = "cuda",
                       mesh=None, spatial: bool = False, int8: bool = False):
    """Returns predict(images (B,H,W,3)) -> (B,H,W) int32 labels.

    images: float32 BGR mean-subtracted, or uint8 RGB (normalized on the
    device); a tensor or a numpy array. `params` is a `state_dict` loaded into
    `model` with strict=True (None keeps the model's weights).
    `unseen_classes`: class ids routed to the unseen partition; the seenmask
    head gates per pixel.

    `upscore_trained` (tri-state): the fused kernel upsamples the seenmask
    gate with fixed bilinear taps, exact only while `seenmask_upscore`
    equals its bilinear init. Stage-2-trained weights route the gate through
    the model's own ConvTranspose instead. True / False state it; None
    detects it from the values. An explicit False that the values
    contradict raises.

    `mesh`, `spatial` and `int8` serving are not ported yet (ROADMAP.md).
    """
    if mesh is not None or spatial or int8:
        raise NotImplementedError(
            "make_szn_predictor: mesh, spatial and int8 serving are not "
            "ported yet; see ROADMAP.md queue 1")
    if not getattr(model, "RAW_HEADS", False):
        raise NotImplementedError(
            "make_szn_predictor: only architectures with raw heads (FCN32s) "
            "are ported yet; see ROADMAP.md queue 1")
    dev = resolve_device(device)
    model = model.to(dev).eval()
    if params is not None:
        model.load_state_dict(params, strict=True)
    state = model.state_dict()
    numeric = upscore_trained_numeric(state)
    if upscore_trained is None:
        upscore_trained = numeric
    elif numeric and not upscore_trained:
        raise ValueError(
            "make_szn_predictor: upscore_trained=False but the "
            "`seenmask_upscore` kernel differs from its bilinear init; the "
            "fused bilinear-gate shortcut would produce wrong labels. Pass "
            "upscore_trained=True (or None to detect it).")

    embed = torch.as_tensor(np.asarray(embeddings, np.float32), device=dev)
    unseen_vec = unseen_mask_vector(embed.shape[0], list(unseen_classes))
    upscore_w = state.get(_UPSCORE_KEY)

    @torch.inference_mode()
    def predict(images) -> torch.Tensor:
        images = prepare_images(torch.as_tensor(images, device=dev))
        f_raw, s_raw = model(images, mode="raw")
        out_hw = (images.shape[1], images.shape[2])
        if not upscore_trained:
            return infer_labels_szn_fused(f_raw, s_raw, embed, unseen_vec,
                                          out_hw)
        # trained upscore: the exact gate at full resolution through the
        # model's own ConvTranspose; the classes still take the fused kernel
        # (an always-seen / always-unseen gate restricts its partition)
        gate = upscore_conv_transpose_cropped(
            s_raw, upscore_w, stride=32, crop_offset=19,
            out_h=out_hw[0], out_w=out_hw[1])
        pixel_unseen = torch.argmax(gate, dim=-1) == 0
        always_seen = torch.zeros_like(s_raw)
        always_seen[..., 1] = 1.0
        always_unseen = torch.zeros_like(s_raw)
        always_unseen[..., 0] = 1.0
        seen_lbl = infer_labels_szn_fused(f_raw, always_seen, embed,
                                          unseen_vec, out_hw)
        unseen_lbl = infer_labels_szn_fused(f_raw, always_unseen, embed,
                                            unseen_vec, out_hw)
        return torch.where(pixel_unseen, unseen_lbl, seen_lbl)

    return predict
