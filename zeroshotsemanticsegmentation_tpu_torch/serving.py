"""Serving: batched zero-shot segmentation, images in, int32 labels out.

`make_szn_predictor` returns a function from an image batch to label maps
through the fastest pipeline: the model's raw heads (FCN-32s's at 1/32 of
the image, DeepLab-v2's at 1/8) feed the fused projection + upsample +
argmax kernel (`ops.szn_fused`) with the model's upsample geometry
(`UPSAMPLE`: stride, kernel, crop), so the full-resolution score volumes
never reach device memory. An architecture without raw heads (FCN-8s,
whose fcn head fuses the pool3/pool4 skips at several resolutions) takes
the unfused route: its full-resolution heads, then the NNE of `ops.nne`.
`int8=True` swaps the FCN-32s backbone for the int8 forward of
`models.quantized`. It runs under `torch.inference_mode()`.

`mesh=` (`parallel.mesh`) serves a batch sharded over the data axes with
fc6 / fc7 split over 'model': every rank is given the same global batch,
runs its rows through the same route and kernels, and gets the global
labels back (an all-reduce over the data group). `spatial=True` splits
each image's height over 'data' instead (`parallel.spatial`): every rank
runs its band of rows through the trunk, the 1/32 heads (or FCN-8s's
score maps) are gathered, each rank labels its rows of the output through
the same kernels, and the labels are gathered.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from zeroshotsemanticsegmentation_tpu_torch import resolve_device
from zeroshotsemanticsegmentation_tpu_torch.data.transforms import (
    prepare_images)
from zeroshotsemanticsegmentation_tpu_torch.models.deeplab import (
    DeepLabV2ResNet101)
from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
from zeroshotsemanticsegmentation_tpu_torch.models.quantized import (
    quantized_raw_forward)
from zeroshotsemanticsegmentation_tpu_torch.ops.bilinear import (
    bilinear_upsampling_kernel, upscore_conv_transpose_cropped)
from zeroshotsemanticsegmentation_tpu_torch.ops.metrics import (
    unseen_mask_vector)
from zeroshotsemanticsegmentation_tpu_torch.ops.nne import infer_labels_szn
from zeroshotsemanticsegmentation_tpu_torch.ops.szn_fused import (
    FCN32S_GEOMETRY, infer_labels_szn_fused)
from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
    DATA_AXIS, gather_height, gather_rows, shard_batch, shard_model,
    shard_params)
from zeroshotsemanticsegmentation_tpu_torch.parallel.spatial import (
    Bands, plan_bands)
from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import span

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

    `int8=True` takes the int8 forward (`models.quantized`: opt-in and
    approximate; check its label flips against the bf16 route on your data
    first); FCN32s only, on one device or a mesh (its scales are the
    one-device ones there). An architecture without raw heads serves
    through the unfused full-resolution route. `DeepLabV2ResNet101`
    serves on one device, without int8: its 1/8 heads take the fused
    kernel at x8 (its `UPSAMPLE`); int8, `mesh` and `spatial` raise
    ValueError for it.

    `mesh`: the model is sharded over it (`parallel.shard_model`) unless
    it already is, `params` is a full state dict, the device is the
    mesh's, and every rank calls `predict` with the same global batch (its
    size divisible by the data axes). `spatial=True` (a mesh and the
    support-pruned geometry, `prune_pad`) splits each image's height over
    'data' instead of the batch (`parallel.spatial.plan_bands`, which
    raises for a geometry it cannot split); the labels are those of one
    device, whole on every rank. Without a mesh `spatial=True` raises
    ValueError (the JAX package ignores the flag there).
    """
    if isinstance(model, DeepLabV2ResNet101) and (
            int8 or mesh is not None or spatial):
        raise ValueError(
            "make_szn_predictor: DeepLabV2ResNet101 serves on one device in "
            "its compute dtype; int8, mesh and spatial serving are "
            "implemented for FCN-32s / FCN-8s only")
    if spatial and mesh is None:
        raise ValueError("make_szn_predictor: spatial=True shards the "
                         "height over a mesh's 'data' axis; pass `mesh`")
    raw_heads = getattr(model, "RAW_HEADS", False)
    if int8 and not isinstance(model, FCN32s):
        raise ValueError(
            "int8 serving implements only the raw-heads (FCN32s) forward "
            "(models/quantized.py); it is unavailable for this architecture")
    if spatial and not getattr(model, "prune_pad", False):
        raise ValueError("make_szn_predictor: spatial serving splits the "
                         "support-pruned geometry; build the model with "
                         "prune_pad=True")
    dev = resolve_device(device) if mesh is None else mesh.device
    model = model.to(dev).eval()
    if mesh is not None and getattr(model, "mesh", None) is None:
        if params is not None:
            model.load_state_dict(params, strict=True)
            params = None
        shard_model(model, mesh)
    if getattr(model, "mesh", None) is not mesh:
        raise ValueError("make_szn_predictor: the model is sharded over "
                         "another mesh than `mesh`")
    if params is not None:
        model.load_state_dict(
            params if mesh is None else shard_params(params, mesh),
            strict=True)
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
    unseen_vec_dev = torch.as_tensor(unseen_vec, device=dev)
    upscore_w = state.get(_UPSCORE_KEY)
    if raw_heads and upscore_trained and upscore_w is None:
        raise ValueError("make_szn_predictor: upscore_trained=True, but "
                         "the model has no `seenmask_upscore`: its gate "
                         "takes the fixed bilinear upsample")
    geometry = getattr(model, "UPSAMPLE", FCN32S_GEOMETRY)

    def labels(f_raw, s_raw, out_hw, rows) -> torch.Tensor:
        """Labels from the raw heads (FCN32s, DeepLabV2ResNet101)."""
        if not upscore_trained:
            return infer_labels_szn_fused(f_raw, s_raw, embed, unseen_vec,
                                          out_hw, rows, geometry)
        # trained upscore: the exact gate at full resolution through the
        # model's own ConvTranspose; the classes still take the fused kernel
        # (an always-seen / always-unseen gate restricts its partition)
        gate = upscore_conv_transpose_cropped(
            s_raw, upscore_w, stride=32, crop_offset=19,
            out_h=out_hw[0], out_w=out_hw[1], rows=rows)
        pixel_unseen = torch.argmax(gate, dim=-1) == 0
        always_seen = torch.zeros_like(s_raw)
        always_seen[..., 1] = 1.0
        always_unseen = torch.zeros_like(s_raw)
        always_unseen[..., 0] = 1.0
        seen_lbl = infer_labels_szn_fused(f_raw, always_seen, embed,
                                          unseen_vec, out_hw, rows)
        unseen_lbl = infer_labels_szn_fused(f_raw, always_unseen, embed,
                                            unseen_vec, out_hw, rows)
        return torch.where(pixel_unseen, unseen_lbl, seen_lbl)

    @torch.inference_mode()
    def predict(images, bands=None) -> torch.Tensor:
        """Labels of `images`; with `bands` this rank's rows of them."""
        with span("serve.h2d", device=True):
            images = prepare_images(torch.as_tensor(images, device=dev))
        rows = None if bands is None else bands.out_rows()
        if not raw_heads:
            with span("model.forward", device=True):
                f_full, s_full = model(images, mode="both", bands=bands)
            with span("serve.labels", device=True):
                return infer_labels_szn(f_full.to(torch.float32),
                                        s_full.to(torch.float32), embed,
                                        unseen_vec_dev)
        with span("model.forward", device=True):
            if int8:
                f_raw, s_raw = quantized_raw_forward(state, images, mesh=mesh,
                                                     bands=bands)
            else:
                f_raw, s_raw = model(images, mode="raw", bands=bands)
        with span("serve.labels", device=True):
            return labels(f_raw, s_raw, (images.shape[1], images.shape[2]),
                          rows)

    if mesh is None:
        return predict

    @torch.inference_mode()
    def predict_sharded(images) -> torch.Tensor:
        rows = shard_batch({"image": torch.as_tensor(images)}, mesh)["image"]
        return gather_rows(predict(rows), mesh)

    if not spatial:
        return predict_sharded

    @torch.inference_mode()
    def predict_spatial(images) -> torch.Tensor:
        images = torch.as_tensor(images)
        plan = plan_bands(images.shape[1], images.shape[2],
                          mesh.shape[DATA_AXIS], model.PRUNED_DEPTH)
        return gather_height(predict(images, Bands(plan, mesh)), mesh,
                             plan.out_rows, dim=1)

    return predict_spatial
