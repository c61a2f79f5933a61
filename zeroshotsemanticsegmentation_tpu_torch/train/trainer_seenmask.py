"""Stage-2 trainer: binary seenmask head on a frozen backbone (the JAX
package's train/trainer_seenmask.py).

Reference behavior (trainer_seenmask.py:19-172, train.py:163-194): train the
2-channel head with size-averaged CE where the binary target is "pixel's
class is seen" (unlabeled counts as unseen); trained on the *train* split,
which keeps train_unseen pixels as negatives, evaluated on val;
per-iteration logs mirror stage 1 under seenmask/* tags.

Deliberate fixes over the reference, as in the JAX package: metrics use a
2-class histogram (the reference reuses the 21/33-class one,
trainer_seenmask.py:137), and `best` is only relinked when mean IoU
improves (the reference overwrites it unconditionally,
trainer_seenmask.py:165-166). Like the reference, which rewrites only the
model weights of the loaded stage-1 checkpoint, each save keeps that
checkpoint's epoch, iteration, best mean IoU and optimizer state (the
stage-1 moments in the reference's 16+16 layout), so a resume from it
takes stage 1's next step.

On a mesh (`mesh=`) the trainer works as `FCNTrainer` does on one: the
same global batches on every rank, sums over the data group in the steps,
logs, tiles and files from rank 0.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from zeroshotsemanticsegmentation_tpu_torch.data.transforms import (
    batch_image_rgb)
from zeroshotsemanticsegmentation_tpu_torch.ops.metrics import (
    hist_to_metrics)
from zeroshotsemanticsegmentation_tpu_torch.train import checkpoint as ckpt
from zeroshotsemanticsegmentation_tpu_torch.train.state import TrainState
from zeroshotsemanticsegmentation_tpu_torch.train.steps import (
    make_seenmask_eval_step, make_seenmask_train_step)
from zeroshotsemanticsegmentation_tpu_torch.train.trainer_fcn import (
    _METRIC_NAMES, TRAIN_HEADERS, StepLogBuffer, echo_feed,
    prefetch_to_device, step_generator, traced_steps, val_headers, viz_rows)
from zeroshotsemanticsegmentation_tpu_torch.viz import (
    get_tile_image, save_image, visualize_seenmask)


class SeenmaskTrainer:
    """Stage 2. `model` is trained in place by `optimizer`
    (`make_seenmask_optimizer`)."""

    def __init__(self, *, cfg, model, optimizer, train_loader, val_loader,
                 logger, start_iteration: int = 0, mesh=None):
        self.cfg = cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.logger = logger
        self.epoch = 0
        self.best_mean_iu = 0.0
        self.device = next(model.parameters()).device
        self.mesh = mesh

        n = cfg.num_classes
        # seen = classes not in train_unseen (reference train.py:192,
        # trainer_seenmask.py:55)
        seen_vec = np.array([c not in set(cfg.train_unseen)
                             for c in range(n)])
        # stage 2 trains `seenmask_upscore` whenever the model has one
        # (reference train.py:304-307): every checkpoint written here
        # records it
        self.upscore_trained = "seenmask_upscore.weight" in model.state_dict()
        self.state = TrainState(model=model, optimizer=optimizer,
                                step=int(start_iteration))
        self._train_step = make_seenmask_train_step(seen_vec=seen_vec,
                                                    mesh=mesh)
        self._eval_step = make_seenmask_eval_step(seen_vec=seen_vec,
                                                  mesh=mesh)
        self._generator = torch.Generator(device=self.device)

    @property
    def iteration(self) -> int:
        return self.state.step

    def _emit_train_row(self, meta: tuple, aux: dict) -> None:
        epoch, batch_idx, it, elapsed = meta
        log = self.logger
        loss = float(aux["loss"])
        if np.isnan(loss):
            raise ValueError("loss is nan while training")
        metrics = hist_to_metrics(aux["hist"])
        log.stdout(
            "Seenmask Train Epoch {:<5} | Iteration {:<5} | Loss {:5.5f} | "
            "seenmask grad sum {:7.8f} | score sum {:10.5f}".format(
                epoch, batch_idx, loss,
                float(aux["seenmask_grad_sum"]), float(aux["score_sum"])))
        log.csv_append("seenmask_train_log.csv", TRAIN_HEADERS,
                       [epoch, it, loss, *metrics, elapsed])
        log.scalar("seenmask/train/loss", loss, it)
        log.scalars("seenmask/train", list(_METRIC_NAMES), metrics, it)

    def train_epoch(self) -> None:
        cfg, log = self.cfg, self.logger
        self.train_loader.set_epoch(1_000_000 + self.epoch)
        feed = (echo_feed(self.train_loader, self.device,
                          max_factor=cfg.data_echo_max_factor)
                if cfg.data_echo == "auto"
                else prefetch_to_device(self.train_loader, self.device))
        it0 = self.state.step
        buf = StepLogBuffer(cfg.log_flush_steps, self._emit_train_row)
        for batch_idx, (_, dbatch) in traced_steps(feed):
            gen = step_generator(self._generator, cfg.seed + 1,
                                 self.state.step)
            self.state, aux = self._train_step(self.state, dbatch, gen)
            if batch_idx % cfg.log_interval:
                continue
            buf.push((self.epoch, batch_idx, it0 + batch_idx,
                      log.elapsed_seconds), aux)
        buf.flush()

    def validate(self, *, base_checkpoint: dict | None = None) -> float:
        """One validation pass and a save; `base_checkpoint` ({epoch,
        iteration, best_mean_iu, opt_state}) is the stage-1 checkpoint stage
        2 started from."""
        cfg, log = self.cfg, self.logger
        model = self.state.model
        loss_sum = torch.zeros((), dtype=torch.float64, device=self.device)
        hist = torch.zeros((2, 2), dtype=torch.int64, device=self.device)
        n_images = 0
        tiles = []
        for batch, dbatch in prefetch_to_device(self.val_loader, self.device):
            out = self._eval_step(model, dbatch)
            loss_sum += out["loss_sum"].to(torch.float64)
            hist += out["hists"][0]
            n_images += batch["num_real"]
            if len(tiles) < cfg.num_viz:
                pred = viz_rows(out["pred"], self.mesh)
                for i in range(batch["num_real"]):
                    if len(tiles) >= cfg.num_viz:
                        break
                    h, w = batch["sizes"][i]
                    img = batch_image_rgb(batch["image"][i, :h, :w])
                    lbl = batch["label"][i, :h, :w]
                    seen_true = np.where(
                        lbl < 0, -1,
                        (~np.isin(lbl, list(cfg.train_unseen))).astype(np.int32))
                    tiles.append(visualize_seenmask(
                        lbl_pred=pred[i, :h, :w], lbl_true=seen_true,
                        img=img, n_class=2))

        viz_dir = osp.join(log.log_dir, "seenmask_viz")
        if log.enabled:
            os.makedirs(viz_dir, exist_ok=True)
        if tiles and log.enabled:
            tile = get_tile_image(tiles)
            save_image(osp.join(viz_dir, f"epoch{self.epoch}.jpg"), tile)
            log.image("seenmask/segmentations", tile, self.epoch)

        val_loss = loss_sum.item() / max(n_images, 1)
        metrics = hist_to_metrics(hist.cpu().numpy())
        log.scalar("seenmask/val/loss", val_loss, self.epoch)
        log.scalars("seenmask/val", list(_METRIC_NAMES), metrics, self.epoch)
        for name, v in zip(_METRIC_NAMES, metrics):
            log.stdout(f"{name}: {v:.3f}")
        log.csv_append("seenmask_val_log.csv", val_headers(False),
                       [self.epoch, self.iteration, val_loss, *metrics,
                        log.elapsed_seconds])

        mean_iu = metrics[2]
        is_best = bool(mean_iu > self.best_mean_iu)
        if is_best:
            self.best_mean_iu = mean_iu
        base = base_checkpoint or {}
        opt_state = base.get("opt_state")
        ckpt.save_checkpoint(
            log.log_dir, model_state=model.state_dict(),
            optim_state=(opt_state if opt_state is not None
                         else self.state.optimizer.state_dict()),
            epoch=base.get("epoch", self.epoch),
            iteration=base.get("iteration", self.iteration),
            best_mean_iu=base.get("best_mean_iu", self.best_mean_iu),
            is_best=is_best, upscore_trained=self.upscore_trained,
            mesh=self.mesh)
        return mean_iu

    def train(self, *, base_checkpoint: dict | None = None) -> None:
        for epoch in range(self.cfg.seenmask_epochs):
            self.epoch = epoch
            self.train_epoch()
            self.validate(base_checkpoint=base_checkpoint)
