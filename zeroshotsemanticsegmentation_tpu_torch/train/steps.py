"""The stage-1 train step (the JAX package's train/steps.py
`make_fcn_train_step`).

One call runs forward, loss, backward and the optimizer update, and returns
the step's metrics as device tensors: nothing inside the step waits for the
device. Per-sample losses generalise the reference's batch-size-1 losses:
the step averages per-image losses over the batch's real samples, so dummy
padding samples (all labels -1) add nothing.

The default branch for the cosine loss is the fused tail
(`ops.costail_fused.fused_cos_tail`): loss, NNE confusion histogram and
score sum from one pass over the full-resolution score, K5/K6 on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from zeroshotsemanticsegmentation_tpu_torch import device_const
from zeroshotsemanticsegmentation_tpu_torch.data.transforms import (
    prepare_images)
from zeroshotsemanticsegmentation_tpu_torch.ops.bilinear import (
    upsample_bilinear_cropped)
from zeroshotsemanticsegmentation_tpu_torch.ops.costail_fused import (
    fused_cos_tail)
from zeroshotsemanticsegmentation_tpu_torch.ops.losses import (
    cosine_loss, cross_entropy2d, embed_targets, mse_loss)
from zeroshotsemanticsegmentation_tpu_torch.ops.metrics import (
    confusion_matrix)
from zeroshotsemanticsegmentation_tpu_torch.ops.nne import (
    infer_labels, infer_labels_forced_unseen)
from zeroshotsemanticsegmentation_tpu_torch.train.state import TrainState


def _per_sample_fcn_loss(loss_name: str):
    """(H, W, C) score, (H, W) label, target embeddings -> scalar loss
    (reference semantics)."""
    if loss_name not in ("cross_entropy", "cos", "mse"):
        raise ValueError(loss_name)

    def loss_one(score, label, target_embeddings):
        score, label = score[None], label[None]
        if loss_name == "cross_entropy":
            return cross_entropy2d(score, label, size_average=False)
        target = embed_targets(label, target_embeddings)
        if loss_name == "cos":
            return cosine_loss(score, label, target)
        return mse_loss(score, label, target)
    return loss_one


def _pad_mask(sizes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W) bool: True where the pixel is bucket padding, outside the
    per-sample (h, w) in `sizes`."""
    rows = torch.arange(h, device=sizes.device)[None, :, None]
    cols = torch.arange(w, device=sizes.device)[None, None, :]
    return (rows >= sizes[:, 0, None, None]) | (cols >= sizes[:, 1, None, None])


def _prepare_batch(batch, device):
    """(fp32 BGR mean-subtracted images, int32 labels) on `device` from
    either feed. The compact feed (uint8 RGB images, int8 labels, `sizes`)
    is normalised here; its bucket pad is zeroed again afterwards, since a
    uint8 zero would become -mean and break the equivalence of padding with
    the convolutions' zero padding."""
    image = torch.as_tensor(batch["image"], device=device)
    images = prepare_images(image)
    labels = torch.as_tensor(batch["label"], device=device).to(torch.int32)
    if image.dtype == torch.uint8:
        pad = _pad_mask(torch.as_tensor(batch["sizes"], device=device),
                        labels.shape[1], labels.shape[2])
        images = torch.where(pad[..., None], torch.zeros_like(images), images)
    return images, labels


def make_fcn_train_step(*, loss_name: str, num_classes: int,
                        embeddings=None, target_embeddings=None,
                        forced_unseen: bool = False, all_unseen_vec=None,
                        chunked_loss: bool = False, grad_accum: int = 1,
                        fused_tail: bool | None = None):
    """Stage-1 train step: returns `train_step(state, batch, generator)` ->
    (state, aux). The model and optimizer travel in the `TrainState`.

    batch: {"image" (B, H, W, 3) fp32 or uint8, "label" (B, H, W) int,
    "sizes" (B, 2) int (the compact feed), "num_real" int}, tensors or
    numpy arrays (a batch already on the device keeps the step free of
    host syncs). `generator` drives the dropout masks; it lives on the
    model's device. aux: {"loss", "hist" (n, n) int32, "score_sum",
    "score_fr_grad_sum"}, device tensors.

    `embeddings` drive NNE inference for the histogram (None: argmax of the
    score); `target_embeddings` (default: the same) drive the regression
    targets. `forced_unseen` stitches the NNE from ground-truth membership
    (`all_unseen_vec`). `chunked_loss` computes the loss from the raw 1/32
    head, upsampling one sample at a time (numerically the same).
    `grad_accum` = k splits the batch into k microbatches whose backward
    passes run in turn; each loss is normalised by the whole batch, so the
    summed gradient is the whole batch's. `fused_tail` (None means on) takes
    `fused_cos_tail` where it applies: cos loss, NNE embeddings with
    num_classes rows, no forced_unseen, no chunked_loss.
    """
    embeddings = None if embeddings is None else torch.as_tensor(
        np.asarray(embeddings, np.float32))
    target_embeddings = embeddings if target_embeddings is None else \
        torch.as_tensor(np.asarray(target_embeddings, np.float32))
    all_unseen_vec = None if all_unseen_vec is None else torch.as_tensor(
        np.asarray(all_unseen_vec, bool))
    loss_one = _per_sample_fcn_loss(loss_name)
    if fused_tail is None:
        fused_tail = True
    use_fused_tail = (
        fused_tail and loss_name == "cos" and embeddings is not None
        and not forced_unseen and not chunked_loss
        and embeddings.shape[0] == num_classes
        and target_embeddings.shape[0] == num_classes)

    host_consts = (embeddings, target_embeddings, all_unseen_vec)
    const_keys = [None if t is None else (
        str(t.dtype), tuple(t.shape), t.numpy().tobytes())
        for t in host_consts]

    def consts(dev):
        """(embeddings, target embeddings, unseen vector) on `dev`, each
        copied there once and keyed by its contents."""
        return tuple(None if t is None else device_const(k, lambda t=t: t, dev)
                     for k, t in zip(const_keys, host_consts))

    def infer_hist(score, label):
        emb, _, unseen = consts(score.device)
        if emb is None:
            pred = torch.argmax(score, dim=-1).to(torch.int32)
        elif forced_unseen:
            pred = infer_labels_forced_unseen(score, label, emb, unseen)
        else:
            pred = infer_labels(score, emb)
        return confusion_matrix(label, pred, num_classes)

    def value_grad_one(model, image, label, denom, generator):
        """(loss, score_sum, hist) of one (micro)batch, after its backward;
        the loss is its sum over the microbatch over the WHOLE batch's
        denom."""
        out_h, out_w = label.shape[1], label.shape[2]
        emb, temb, _ = consts(image.device)
        if chunked_loss:
            f_small = model(image, mode="raw", train=True,
                            generator=generator)[0]
            losses, ssum, hist = [], 0.0, 0
            for fs, lbl in zip(f_small, label):
                score = upsample_bilinear_cropped(
                    fs[None], stride=32, kernel_size=64, crop_offset=19,
                    out_h=out_h, out_w=out_w)
                losses.append(loss_one(score[0], lbl, temb))
                ssum = ssum + score.detach().sum()
                hist = hist + infer_hist(score.detach(), lbl[None])
            loss = torch.stack(losses).sum() / denom
        elif use_fused_tail:
            score = model(image, mode="fcn", train=True, generator=generator)
            losses, hist, ssum = fused_cos_tail(score, label, temb, emb,
                                                num_classes)
            loss = losses.sum() / denom
        else:
            score = model(image, mode="fcn", train=True, generator=generator)
            loss = torch.stack([loss_one(s, lbl, temb) for s, lbl in
                                zip(score, label)]).sum() / denom
            ssum = score.detach().to(torch.float32).sum()
            hist = infer_hist(score.detach(), label)
        loss.backward()
        return loss.detach(), ssum.detach(), hist

    def train_step(state: TrainState, batch, generator=None):
        model, optimizer = state.model, state.optimizer
        dev = next(model.parameters()).device
        images, labels = _prepare_batch(batch, dev)
        num_real = batch["num_real"]
        denom = (num_real.to(dev).clamp(min=1).to(torch.float32)
                 if torch.is_tensor(num_real) else
                 torch.full((), max(float(num_real), 1.0), device=dev))
        b = images.shape[0]
        if b % grad_accum:
            raise ValueError(
                f"batch {b} not divisible by grad_accum {grad_accum}")
        m = b // grad_accum
        optimizer.zero_grad(set_to_none=True)
        loss = score_sum = hist = 0
        for i in range(grad_accum):
            sl = slice(i * m, (i + 1) * m)
            mloss, mssum, mhist = value_grad_one(model, images[sl],
                                                 labels[sl], denom, generator)
            loss, score_sum, hist = loss + mloss, score_sum + mssum, \
                hist + mhist
        aux = {"loss": loss, "hist": hist, "score_sum": score_sum,
               # reference per-iter stdout prints these
               "score_fr_grad_sum": model.score_fr.weight.grad.sum()}
        optimizer.step()
        return dataclasses.replace(state, step=state.step + 1), aux

    return train_step
