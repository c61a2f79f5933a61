"""The train and eval steps of both stages (the JAX package's
train/steps.py): `make_fcn_train_step` (stage 1), `make_seenmask_train_step`
(stage 2), `make_fcn_eval_step`, `make_szn_eval_step` and
`make_seenmask_eval_step`.

A train step runs forward, loss, backward and the optimizer update, and
returns the step's metrics as device tensors: nothing inside the step waits
for the device. Per-sample losses generalise the reference's batch-size-1
losses: the step averages per-image losses over the batch's real samples,
so dummy padding samples (all labels -1) add nothing.

The default branch for the stage-1 cosine loss is the fused tail
(`ops.costail_fused.fused_cos_tail`): loss, NNE confusion histogram and
score sum from one pass over the full-resolution score, K5/K6 on the card.
Stage 2 trains the seenmask head on a frozen backbone: the trunk runs
without autograd (`FCN32s.forward(frozen_trunk=True)`), so no backbone
backward exists. An eval step takes `(model, batch)` and runs without
autograd; with `fused=True` its labels come from the raw 1/32 heads
through the fused SZN-labels kernel (K1) and its loss from a per-sample
upsample, so no full-resolution score volume is kept.

Every factory takes `mesh=` (`parallel.mesh`): the step then runs this
rank's rows of the global batch (`shard_batch`; "num_real" stays global),
each kernel on the local batch, and fc6 / fc7 split over 'model'. A train
step sums the gradients over the data group (`all_reduce_grads`) after
the last microbatch (the loss is over the global "num_real", so the sum is
the global gradient), and its "loss", "hist" and "score_sum" in one
all-reduce;
an eval step sums "loss_sum", "hists" and "score_sum", and its "pred" is
the local rows.
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
    confusion_matrix, zeroshot_hists)
from zeroshotsemanticsegmentation_tpu_torch.ops.nne import (
    infer_labels, infer_labels_forced_unseen, infer_labels_szn)
from zeroshotsemanticsegmentation_tpu_torch.ops.szn_fused import (
    infer_labels_nne_fused, infer_labels_szn_fused)
from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
    all_reduce_grads, reduce_sums, shard_batch)
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


def _host(x, dtype):
    """A factory's constant as a host tensor (None stays None)."""
    return None if x is None else torch.as_tensor(np.asarray(x, dtype))


def _device_consts(*host):
    """consts(dev) -> the host tensors `host` on `dev`, each copied there
    once and keyed by its contents (None stays None)."""
    keys = [None if t is None else (str(t.dtype), tuple(t.shape),
                                    t.numpy().tobytes()) for t in host]

    def consts(dev):
        return tuple(None if t is None else device_const(k, lambda t=t: t,
                                                         dev)
                     for k, t in zip(keys, host))
    return consts


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


def _fcn_infer(score, label, embeddings, forced_unseen, unseen_vec):
    """Stage-1 labels: argmax of the score without embeddings, else NNE
    (oracle-stitched from the true labels when `forced_unseen`)."""
    if embeddings is None:
        return torch.argmax(score, dim=-1).to(torch.int32)
    if forced_unseen:
        return infer_labels_forced_unseen(score, label, embeddings,
                                          unseen_vec)
    return infer_labels(score, embeddings)


def _local_rows(model, batch, mesh, chunks: int = 1):
    """This rank's rows of the global batch (of each of its `chunks`
    microbatches; the batch itself off a mesh). The model must be sharded
    over the same mesh."""
    if mesh is None:
        return batch
    if getattr(model, "mesh", None) is not mesh:
        raise ValueError("a mesh step needs the model sharded over its mesh: "
                         "parallel.shard_model(model, mesh)")
    return shard_batch(batch, mesh, chunks)


def _denom(num_real, dev) -> torch.Tensor:
    """max(num_real, 1) as an fp32 device scalar, without a host sync."""
    if torch.is_tensor(num_real):
        return num_real.to(dev).clamp(min=1).to(torch.float32)
    return torch.full((), max(float(num_real), 1.0), device=dev)


def _sum_over_data(out: dict, keys, mesh) -> dict:
    """`out` with its `keys` summed over the mesh's data group (no mesh:
    as it is)."""
    if mesh is None:
        return out
    return {**out, **reduce_sums({k: out[k] for k in keys}, mesh)}


def make_fcn_train_step(*, loss_name: str, num_classes: int,
                        embeddings=None, target_embeddings=None,
                        forced_unseen: bool = False, all_unseen_vec=None,
                        chunked_loss: bool = False, grad_accum: int = 1,
                        fused_tail: bool | None = None, mesh=None):
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
    summed gradient is the whole batch's; on a mesh microbatch i is the
    global batch's i-th, each rank running its rows of it (`shard_batch`'s
    `chunks`), as the JAX step splits it. `fused_tail` (None means on) takes
    `fused_cos_tail` where it applies: cos loss, NNE embeddings with
    num_classes rows, no forced_unseen, no chunked_loss.
    """
    embeddings = _host(embeddings, np.float32)
    target_embeddings = embeddings if target_embeddings is None else \
        _host(target_embeddings, np.float32)
    all_unseen_vec = _host(all_unseen_vec, bool)
    loss_one = _per_sample_fcn_loss(loss_name)
    if fused_tail is None:
        fused_tail = True
    use_fused_tail = (
        fused_tail and loss_name == "cos" and embeddings is not None
        and not forced_unseen and not chunked_loss
        and embeddings.shape[0] == num_classes
        and target_embeddings.shape[0] == num_classes)

    consts = _device_consts(embeddings, target_embeddings, all_unseen_vec)

    def infer_hist(score, label):
        emb, _, unseen = consts(score.device)
        pred = _fcn_infer(score, label, emb, forced_unseen, unseen)
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
        batch = _local_rows(model, batch, mesh, grad_accum)
        images, labels = _prepare_batch(batch, dev)
        denom = _denom(batch["num_real"], dev)
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
        if mesh is not None:
            all_reduce_grads(model.parameters(), mesh)
        aux = _sum_over_data({"loss": loss, "hist": hist,
                              "score_sum": score_sum},
                             ("loss", "hist", "score_sum"), mesh)
        # reference per-iter stdout prints this
        aux["score_fr_grad_sum"] = model.score_fr.weight.grad.sum()
        optimizer.step()
        return dataclasses.replace(state, step=state.step + 1), aux

    return train_step


def _chunked_loss_from_raw(loss_one, f_small, labels, target_embeddings):
    """(loss sum, score sum) from the raw 1/32 head: one sample at a time,
    upsampled in fp32 and scored, so the batch's full-resolution score
    volume never exists."""
    out_h, out_w = labels.shape[1], labels.shape[2]
    losses, score_sum = [], 0.0
    for fs, lbl in zip(f_small, labels):
        score = upsample_bilinear_cropped(
            fs[None], stride=32, kernel_size=64, crop_offset=19,
            out_h=out_h, out_w=out_w)
        losses.append(loss_one(score[0], lbl, target_embeddings))
        score_sum = score_sum + torch.sum(score)
    return torch.stack(losses).sum(), score_sum


def _unseen_or_none(vec, num_classes: int) -> np.ndarray:
    """An unseen-class vector as host bools; None means no unseen class."""
    if vec is None:
        return np.zeros((num_classes,), bool)
    return np.asarray(vec, bool)


def make_fcn_eval_step(*, loss_name: str, num_classes: int,
                       embeddings=None, target_embeddings=None,
                       forced_unseen: bool = False, all_unseen_vec=None,
                       val_unseen_vec=None, fused: bool = False, mesh=None):
    """Stage-1 eval step (reference Trainer.forward): returns
    `eval_step(model, batch)` -> {"loss_sum", "hists" (3, n, n) int32 (all /
    seen / unseen true classes by `val_unseen_vec`), "pred" (B, H, W) int32,
    "score_sum"}, device tensors.

    `fused` (NNE only: not the argmax baseline, not forced_unseen): labels
    from the raw head through `infer_labels_nne_fused` (K1 on the card), the
    loss from a per-sample upsample. Otherwise the full-resolution score
    feeds the loss and the argmax / NNE / forced-unseen labels."""
    embeddings = _host(embeddings, np.float32)
    target_embeddings = embeddings if target_embeddings is None else \
        _host(target_embeddings, np.float32)
    consts = _device_consts(
        embeddings, target_embeddings, _host(all_unseen_vec, bool),
        _host(_unseen_or_none(val_unseen_vec, num_classes), bool))
    loss_one = _per_sample_fcn_loss(loss_name)
    use_fused = fused and embeddings is not None and not forced_unseen

    @torch.no_grad()
    def eval_step(model, batch):
        dev = next(model.parameters()).device
        batch = _local_rows(model, batch, mesh)
        images, labels = _prepare_batch(batch, dev)
        emb, temb, unseen, val_unseen = consts(dev)
        if use_fused:
            f_small = model(images, mode="raw")[0]
            loss_sum, score_sum = _chunked_loss_from_raw(
                loss_one, f_small, labels, temb)
            pred = infer_labels_nne_fused(f_small, emb, labels.shape[1:])
        else:
            score = model(images, mode="fcn")
            loss_sum = torch.stack([loss_one(s, lbl, temb) for s, lbl in
                                    zip(score, labels)]).sum()
            pred = _fcn_infer(score, labels, emb, forced_unseen, unseen)
            score_sum = torch.sum(score.to(torch.float32))
        return _sum_over_data(
            {"loss_sum": loss_sum,
             "hists": zeroshot_hists(labels, pred, num_classes, val_unseen),
             "pred": pred, "score_sum": score_sum},
            ("loss_sum", "hists", "score_sum"), mesh)

    return eval_step


def make_szn_eval_step(*, loss_name: str, num_classes: int, embeddings,
                       target_embeddings=None, all_unseen_vec=None,
                       val_unseen_vec=None, fused: bool = False, mesh=None):
    """Full-SZN eval step (reference Trainer.forward_szn,
    trainer_fcn.py:123-147): both heads, the seenmask-gated stitched NNE
    labels (`all_unseen_vec` partitions the classes), the fcn loss. Returns
    `eval_step(model, batch)` with the keys of `make_fcn_eval_step`.

    `fused`: labels from the raw heads through `infer_labels_szn_fused` (K1
    on the card), whose gate is the bilinear seenmask upsample; the caller
    passes it only while the seenmask upscore is untrained
    (trainer_fcn.py:315-322)."""
    embeddings = _host(embeddings, np.float32)
    target_embeddings = embeddings if target_embeddings is None else \
        _host(target_embeddings, np.float32)
    unseen_host = _unseen_or_none(all_unseen_vec, num_classes)
    consts = _device_consts(
        embeddings, target_embeddings, _host(unseen_host, bool),
        _host(_unseen_or_none(val_unseen_vec, num_classes), bool))
    loss_one = _per_sample_fcn_loss(loss_name)

    @torch.no_grad()
    def eval_step(model, batch):
        dev = next(model.parameters()).device
        batch = _local_rows(model, batch, mesh)
        images, labels = _prepare_batch(batch, dev)
        emb, temb, unseen, val_unseen = consts(dev)
        if fused:
            f_small, s_small = model(images, mode="raw")
            loss_sum, score_sum = _chunked_loss_from_raw(
                loss_one, f_small, labels, temb)
            pred = infer_labels_szn_fused(f_small, s_small, emb, unseen_host,
                                          labels.shape[1:])
        else:
            fcn_score, seenmask_score = model(images, mode="both")
            loss_sum = torch.stack([loss_one(s, lbl, temb) for s, lbl in
                                    zip(fcn_score, labels)]).sum()
            pred = infer_labels_szn(fcn_score, seenmask_score, emb, unseen)
            score_sum = torch.sum(fcn_score.to(torch.float32))
        return _sum_over_data(
            {"loss_sum": loss_sum,
             "hists": zeroshot_hists(labels, pred, num_classes, val_unseen),
             "pred": pred, "score_sum": score_sum},
            ("loss_sum", "hists", "score_sum"), mesh)

    return eval_step


def _seenmask_target(label: torch.Tensor, sizes: torch.Tensor,
                     seen_vec: torch.Tensor) -> torch.Tensor:
    """Stage 2's binary target (B, H, W) int32: 1 where the pixel's class is
    seen, 0 where it is unseen or unlabelled, -1 on bucket padding (outside
    the per-sample `sizes`), which the loss ignores. The reference trains
    on every pixel of the image, unlabelled ones as 0
    (trainer_seenmask.py:54-58)."""
    k = seen_vec.shape[0]
    idx = label.clamp(min=0)
    seen = (seen_vec.to(torch.float32)[idx.clamp(max=k - 1).long()] > 0.5) \
        & (idx < k) & (label >= 0)
    tgt = seen.to(torch.int32)
    return torch.where(_pad_mask(sizes, label.shape[1], label.shape[2]),
                       torch.full_like(tgt, -1), tgt)


def _seenmask_losses(score: torch.Tensor, target: torch.Tensor
                     ) -> torch.Tensor:
    """(B,) per-sample cross-entropy of the (B, H, W, 2) score, averaged
    over each sample's valid pixels (`cross_entropy2d(size_average=True)`
    per sample)."""
    return torch.stack([cross_entropy2d(s[None], t[None], size_average=True)
                        for s, t in zip(score, target)])


def make_seenmask_train_step(*, seen_vec, mesh=None):
    """Stage-2 train step: cross-entropy on the 2-channel seenmask head,
    backbone frozen. Returns `train_step(state, batch, generator)` ->
    (state, aux); batch as for `make_fcn_train_step`, "sizes" required.
    aux: {"loss", "hist" (2, 2) int32, "score_sum", "seenmask_grad_sum"},
    device tensors.

    The reference trains only the seenmask head and its upscore in stage 2
    (train.py:166-171, 304-307), so its backward stops at the head; here
    the trunk runs without autograd, so no backbone backward is built.
    Pair it with `make_seenmask_optimizer`."""
    consts = _device_consts(_host(seen_vec, np.float32))

    def train_step(state: TrainState, batch, generator=None):
        model, optimizer = state.model, state.optimizer
        dev = next(model.parameters()).device
        batch = _local_rows(model, batch, mesh)
        images, labels = _prepare_batch(batch, dev)
        (seen,) = consts(dev)
        target = _seenmask_target(
            labels, torch.as_tensor(batch["sizes"], device=dev), seen)
        optimizer.zero_grad(set_to_none=True)
        score = model(images, mode="seenmask", train=True,
                      generator=generator, frozen_trunk=True)
        loss = _seenmask_losses(score, target).sum() / _denom(
            batch["num_real"], dev)
        loss.backward()
        if mesh is not None:
            all_reduce_grads(model.parameters(), mesh)
        pred = torch.argmax(score.detach(), dim=-1).to(torch.int32)
        aux = _sum_over_data(
            {"loss": loss.detach(), "hist": confusion_matrix(target, pred, 2),
             "score_sum": torch.sum(score.detach().to(torch.float32))},
            ("loss", "hist", "score_sum"), mesh)
        aux["seenmask_grad_sum"] = model.seenmask_score.weight.grad.sum()
        optimizer.step()
        return dataclasses.replace(state, step=state.step + 1), aux

    return train_step


def make_seenmask_eval_step(*, seen_vec, mesh=None):
    """Stage-2 eval step: returns `eval_step(model, batch)` -> {"loss_sum",
    "hists" (1, 2, 2) int32, "pred", "score_sum"}, device tensors."""
    consts = _device_consts(_host(seen_vec, np.float32))

    @torch.no_grad()
    def eval_step(model, batch):
        dev = next(model.parameters()).device
        batch = _local_rows(model, batch, mesh)
        images, labels = _prepare_batch(batch, dev)
        (seen,) = consts(dev)
        target = _seenmask_target(
            labels, torch.as_tensor(batch["sizes"], device=dev), seen)
        score = model(images, mode="seenmask")
        pred = torch.argmax(score, dim=-1).to(torch.int32)
        return _sum_over_data(
            {"loss_sum": _seenmask_losses(score, target).sum(),
             "hists": confusion_matrix(target, pred, 2)[None], "pred": pred,
             "score_sum": torch.sum(score.to(torch.float32))},
            ("loss_sum", "hists", "score_sum"), mesh)

    return eval_step
