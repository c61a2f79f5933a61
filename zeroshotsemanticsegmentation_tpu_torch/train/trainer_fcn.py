"""Stage-1 trainer: FCN embedding regression / softmax baseline (the JAX
package's train/trainer_fcn.py).

Orchestrates the train and eval steps over the batch pipeline with the
reference Trainer's observable behavior (trainer_fcn.py:19-306):
per-iteration train CSV/TB/stdout with loss, grad sum and train metrics,
per-epoch validation with overall + seen/unseen metrics, a first-N
visualization tile, a checkpoint after every eval with best-by-mean-IoU,
and the dataset's early-stop image budget.

On the card nothing in the loop waits for the device between log flushes:
batches are copied from pinned host memory on a side stream
(`prefetch_to_device`), the step counter lives on the host, and the steps'
metrics stay on the device until `StepLogBuffer` reads `log_flush_steps` of
them back in one copy. Dropout draws from a generator reseeded from (seed,
step) before every step, so a resumed run draws the masks of an
uninterrupted one.

On a mesh (`mesh=`, the model already sharded by `parallel.shard_model`)
every rank iterates the same global batches (the same loader and seed) and
its steps take their rows; validation's sums are summed over the data
group inside the eval steps. Log rows, viz tiles and checkpoint files come
from rank 0 alone (the other ranks' `RunLogger` is disabled); every rank
joins the checkpoint's gathers and barrier.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import os.path as osp
from collections import deque

import numpy as np
import torch

from zeroshotsemanticsegmentation_tpu_torch.data.transforms import (
    batch_image_rgb)
from zeroshotsemanticsegmentation_tpu_torch.ops.metrics import (
    hist_to_metrics, unseen_mask_vector)
from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
    gather_rows, opt_param_names)
from zeroshotsemanticsegmentation_tpu_torch.train import checkpoint as ckpt
from zeroshotsemanticsegmentation_tpu_torch.train.state import TrainState
from zeroshotsemanticsegmentation_tpu_torch.train.steps import (
    make_fcn_eval_step, make_fcn_train_step, make_szn_eval_step)
from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import (
    profile_trace, span)
from zeroshotsemanticsegmentation_tpu_torch.viz import (
    get_tile_image, save_image, visualize_segmentation)

_METRIC_NAMES = ("pxl_acc", "class_acc", "mean_iu", "fwavacc")

TRAIN_HEADERS = ["epoch", "iteration", "train/loss", "train/pxl_acc",
                 "train/class_acc", "train/mean_iu", "train/fwavacc",
                 "elapsed_time"]

# the batch entries copied to the device; "num_real" stays a host int
_ARRAY_KEYS = ("image", "label", "sizes")


def val_headers(zeroshot: bool) -> list[str]:
    h = ["epoch", "iteration", "val/loss", "val/pxl_acc", "val/class_acc",
         "val/mean_iu", "val/fwavacc"]
    if zeroshot:
        for grp in ("seen", "unseen"):
            h += [f"val/{grp}/{m}" for m in _METRIC_NAMES]
    return h + ["elapsed_time"]


def step_generator(gen: torch.Generator, seed: int, step: int
                   ) -> torch.Generator:
    """`gen` reseeded from (seed, step): a step's dropout masks depend on
    the run's seed and the step's number alone (the JAX steps fold the step
    into the key), so a resumed run draws the masks of an uninterrupted
    one. Host-side: no device work."""
    return gen.manual_seed((int(seed) << 32) + int(step))


def put_batch(batch: dict, device: torch.device, stream=None):
    """Start copying a host batch to `device`: (device batch, event).

    On the card each array goes through pinned host memory and a
    non_blocking copy on `stream` (a side stream), and the event is recorded
    after the copies; `take_batch` makes the compute stream wait on it. A
    batch the native decoder wrote into pinned tensors ("pinned") is copied
    from them as it is; the copy, issued on the caching host allocator's
    own tensors, records the allocator's event that keeps their memory
    from reuse until it is done. On the CPU the tensors share the arrays'
    memory and the event is None. "num_real" stays a Python int (the steps'
    `_denom` reads it on the host)."""
    pinned = batch.get("pinned")
    host = pinned or {k: torch.from_numpy(np.ascontiguousarray(batch[k]))
                      for k in _ARRAY_KEYS}
    event = None
    if device.type == "cuda":
        with torch.cuda.stream(stream):
            out = {k: (host[k] if pinned else host[k].pin_memory()).to(
                       device, non_blocking=True) for k in _ARRAY_KEYS}
            event = torch.cuda.Event()
            event.record(stream)
    else:
        out = host
    out["num_real"] = int(batch["num_real"])
    return out, event


def take_batch(dbatch: dict, event) -> dict:
    """The device batch ready for the current stream: it waits for the
    batch's copies (on the device, the host does not wait), and the
    tensors' memory is tied to it, so the allocator keeps it until the
    stream's work on it is done."""
    if event is not None:
        cur = torch.cuda.current_stream(dbatch["image"].device)
        cur.wait_event(event)
        for k in _ARRAY_KEYS:
            dbatch[k].record_stream(cur)
    return dbatch


def _side_stream(device: torch.device):
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def prefetch_to_device(loader, device: torch.device):
    """Yield (host_batch, device_batch) pairs, each batch's copy issued when
    the caller asks for it. On the card that is right after the caller
    queued its previous step, so the copy (pinned memory, a side stream)
    runs beside that step's compute, and the first step waits for one
    batch, not two (the loader's threads keep the next batches ready on the
    host). The JAX package issues batch N+1's copy before handing over
    batch N instead; here that made each epoch's first step wait for a
    second batch from the loader (measured: PERF.md, §6)."""
    stream = _side_stream(device)
    for b in loader:
        yield b, take_batch(*put_batch(b, device, stream))


def echo_feed(loader, device: torch.device, *, depth: int = 2,
              min_pool: int = 3, max_factor: float = 4.0):
    """Device-resident batch pool with asynchronous refresh (data echoing;
    opt-in, `data_echo="auto"`).

    Each iteration issues up to `depth` copies, serves the oldest one whose
    copy has finished (its event reports done; no host wait) or, while it
    is still in flight, re-serves a resident batch (round-robin over the
    last `min_pool`). Iterations per epoch are unchanged; sample freshness
    drops by the echo factor (served/fresh, cf. data echoing, Choi et al.
    2020), which the trainer logs. `max_factor` bounds that factor: past it
    the oldest copy is served anyway and the step waits for it on the
    device. Training only; validation never echoes.

    Yields (host_batch, device_batch); host_batch is None for echoes.
    """
    stream = _side_stream(device)
    it = iter(loader)
    inflight: deque = deque()
    pool: list = []
    exhausted = False
    served = echoes = rr = 0
    try:
        for _ in range(len(loader)):
            while not exhausted and len(inflight) < depth:
                try:
                    hb = next(it)
                except StopIteration:
                    exhausted = True
                    break
                inflight.append((hb, *put_batch(hb, device, stream)))
            fresh = None
            if inflight and (inflight[0][2] is None
                             or inflight[0][2].query()):
                fresh = inflight.popleft()
            over_cap = (served + 1) / max(served - echoes, 1) > max_factor
            if fresh is None and inflight and (not pool or over_cap):
                # epoch start (nothing resident yet) or the cap reached:
                # serve the oldest copy; the step waits for it
                fresh = inflight.popleft()
            if fresh is not None:
                hb, dbatch, event = fresh
                dbatch = take_batch(dbatch, event)
                pool.append(dbatch)
                if len(pool) > min_pool:
                    pool.pop(0)
            elif not pool:
                break  # loader shorter than len() claimed
            served += 1
            if fresh is not None:
                yield hb, dbatch
            else:
                echoes += 1
                rr += 1
                yield None, pool[rr % len(pool)]
    finally:
        if served:
            echo_feed.last_stats = {
                "served": served, "echoes": echoes,
                "echo_factor": served / max(served - echoes, 1)}


echo_feed.last_stats = None


def viz_rows(pred: torch.Tensor, mesh) -> np.ndarray:
    """A validation batch's predicted labels as a host array for the viz
    tiles: on a mesh the global rows, gathered on every rank (every rank
    draws the same tiles, so all join the gather; rank 0 alone saves
    them)."""
    if mesh is not None:
        pred = gather_rows(pred, mesh)
    return pred.cpu().numpy()


class StepLogBuffer:
    """Deferred per-step log emission: reading a step's metrics right after
    queueing it would make the host wait for the device every step. Each
    logged step's aux tensors stay on the device, packed into one fp64 row
    (exact for the fp32 scalars and the histogram's counts), and
    `flush_steps` rows are read back in one copy; every stdout/CSV/TB row is
    still emitted once per logged iteration (reference cadence,
    trainer_fcn.py:160-178), in bursts of at most `flush_steps`.
    flush_steps=1 is the reference's immediate logging; 0 defers every read
    to the epoch's end."""

    def __init__(self, flush_steps: int, emit):
        fs = int(flush_steps)
        self._flush_steps = fs if fs >= 1 else float("inf")
        self._emit = emit
        self._pending: list = []

    def push(self, meta: tuple, aux: dict) -> None:
        layout = [(k, tuple(v.shape)) for k, v in aux.items()]
        row = torch.cat([v.detach().reshape(-1).to(torch.float64)
                         for v in aux.values()])
        self._pending.append((meta, layout, row))
        if len(self._pending) >= self._flush_steps:
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        with span("train.log_flush"):
            pending, self._pending = self._pending, []
            rows = torch.stack([row for _, _, row in pending]).cpu().numpy()
            for (meta, layout, _), row in zip(pending, rows):
                aux, at = {}, 0
                for k, shape in layout:
                    n = int(np.prod(shape))
                    aux[k] = row[at:at + n].reshape(shape)
                    at += n
                self._emit(meta, aux)


def traced_steps(feed):
    """(batch index, (host batch, device batch)) of each batch of `feed`.
    The caller's loop body runs inside that step's `train.step` span
    (`utils.profiling`), whose `train.feed` child is the host's wait for
    the batch: the loader's queue, then the copy's start. The wait that
    finds the feed exhausted ends a last `train.step` with no `images`."""
    feed = iter(feed)
    for batch_idx in itertools.count():
        with span("train.step") as step:
            with span("train.feed"):
                item = next(feed, None)
            if item is None:
                return
            if step is not None:
                step.work["images"] = item[1]["image"].shape[0]
            yield batch_idx, item


class FCNTrainer:
    """Stage 1. `model` (an FCN32s or FCN8s on its device) and `optimizer`
    (`make_fcn_optimizer`, possibly restored from a checkpoint) are
    trained in place. `upscore_trained` is required: whether stage 2 has
    trained `seenmask_upscore` (a checkpoint's record, False for a fresh
    init); while it has not, the SZN validation takes the fused kernel."""

    def __init__(self, *, cfg, model, optimizer, train_loader, val_loader,
                 logger, embeddings=None, target_embeddings=None,
                 start_epoch: int = 0, start_iteration: int = 0,
                 best_mean_iu: float = 0.0, upscore_trained: bool,
                 mesh=None):
        self.cfg = cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.logger = logger
        self.epoch = start_epoch
        self.best_mean_iu = best_mean_iu
        self.device = next(model.parameters()).device
        self.mesh = mesh

        n = cfg.num_classes
        self.n_class = n
        # class partitioning: stitch/forced-unseen uses train+val unseen
        # (reference trainer_fcn.py:44,56-64); the metric breakdown uses
        # val_unseen only (trainer_fcn.py:223)
        self.all_unseen = tuple(cfg.train_unseen) + tuple(cfg.val_unseen)
        all_unseen_vec = unseen_mask_vector(n, self.all_unseen)
        val_unseen_vec = unseen_mask_vector(n, cfg.val_unseen)
        self.zeroshot = bool(self.all_unseen)

        emb = None if embeddings is None else np.asarray(embeddings,
                                                         np.float32)
        temb = (None if target_embeddings is None
                else np.asarray(target_embeddings, np.float32))

        # whether stage 2 trained `seenmask_upscore`: the checkpoint's
        # record, or False for a fresh init (the weights on the card are
        # not read back to find out)
        self.upscore_trained = bool(upscore_trained)

        # the chunked loss and the fused eval read the raw 1/32 heads
        # (mode="raw"), which an architecture without them (FCN-8s) lacks
        raw_heads = getattr(model, "RAW_HEADS", False)
        if cfg.chunked_loss and not raw_heads:
            raise ValueError(
                f"chunked_loss needs the raw 1/32 heads, which "
                f"{type(model).__name__} does not have (its fcn head fuses "
                "the pool3/pool4 skips); train it without chunked_loss")

        self.state = TrainState(model=model, optimizer=optimizer,
                                step=int(start_iteration))
        kw = dict(loss_name=cfg.fcn_loss, num_classes=n, embeddings=emb,
                  target_embeddings=temb, forced_unseen=cfg.forced_unseen,
                  all_unseen_vec=all_unseen_vec)
        self._train_step = make_fcn_train_step(
            chunked_loss=cfg.chunked_loss, grad_accum=cfg.grad_accum,
            mesh=mesh, **kw)
        # fused eval: the serving labels kernel (K1) inside validation;
        # "auto" = the model is on the card. Only a model with raw heads
        # can feed it; any other validates on the unfused route whatever
        # `fused_eval` says (the JAX trainer picks by backend alone, so its
        # FCN-8s would fail at mode="raw" on a TPU)
        fe = cfg.fused_eval
        fused = raw_heads and (
            fe == "on" or (fe == "auto" and self.device.type == "cuda"))
        self._eval_step = make_fcn_eval_step(
            val_unseen_vec=val_unseen_vec, fused=fused, mesh=mesh, **kw)
        # the fused SZN kernel upsamples the seenmask gate with the FIXED
        # bilinear taps: exact only while `seenmask_upscore` is untrained
        # (reference stage 2 trains it, train.py:304-307)
        if self.zeroshot and emb is not None:
            self._szn_eval_step = make_szn_eval_step(
                loss_name=cfg.fcn_loss, num_classes=n, embeddings=emb,
                target_embeddings=temb, all_unseen_vec=all_unseen_vec,
                val_unseen_vec=val_unseen_vec,
                fused=fused and not self.upscore_trained, mesh=mesh)
        else:
            self._szn_eval_step = None
        self._generator = torch.Generator(device=self.device)

    # ------------------------------------------------------------------

    @property
    def iteration(self) -> int:
        return self.state.step

    def _emit_train_row(self, meta: tuple, aux: dict) -> None:
        epoch, batch_idx, it, elapsed = meta
        log = self.logger
        loss = float(aux["loss"])
        if np.isnan(loss):
            raise ValueError("loss is nan while training")  # ref :107
        metrics = hist_to_metrics(aux["hist"])
        log.stdout(
            "FCN Train Epoch {:<5} | Iteration {:<5} | Loss {:5.5f} | "
            "score_fr grad sum {:15.6f} | score sum {:10.5f}".format(
                epoch, batch_idx, loss,
                float(aux["score_fr_grad_sum"]),
                float(aux["score_sum"])))
        log.csv_append("train_log.csv", TRAIN_HEADERS,
                       [epoch, it, loss, *metrics, elapsed])
        log.scalar("fcn/train/loss", loss, it)
        log.scalars("fcn/train", list(_METRIC_NAMES), metrics, it)

    def train_epoch(self) -> None:
        cfg, log = self.cfg, self.logger
        self.train_loader.set_epoch(self.epoch)
        feed = (echo_feed(self.train_loader, self.device,
                          max_factor=cfg.data_echo_max_factor)
                if cfg.data_echo == "auto"
                else prefetch_to_device(self.train_loader, self.device))
        it0 = self.state.step
        buf = StepLogBuffer(cfg.log_flush_steps, self._emit_train_row)
        with contextlib.ExitStack() as profiling:
            for batch_idx, (_, dbatch) in traced_steps(feed):
                gen = step_generator(self._generator, cfg.seed,
                                     self.state.step)
                self.state, aux = self._train_step(self.state, dbatch, gen)
                if batch_idx % cfg.log_interval == 0:
                    buf.push((self.epoch, batch_idx, it0 + batch_idx,
                              log.elapsed_seconds), aux)
                # optional torch.profiler window over steps 1 to
                # profile_steps (step 0 is warm-up), opened at the end of
                # step 0 so that step 1's spans start inside it
                if cfg.profile_steps and self.epoch == 0 and log.enabled:
                    if batch_idx == 0:
                        profiling.enter_context(
                            profile_trace(osp.join(log.log_dir, "profile")))
                    elif batch_idx == cfg.profile_steps:
                        profiling.close()
        buf.flush()
        if cfg.data_echo == "auto" and echo_feed.last_stats:
            s = echo_feed.last_stats
            log.stdout(f"data-echo epoch {self.epoch}: {s['served']} steps, "
                       f"{s['echoes']} echoed (factor "
                       f"{s['echo_factor']:.2f})")

    def validate(self, *, both_fcn_and_seenmask: bool = False) -> float:
        """One full validation pass; returns overall mean-IoU.

        both_fcn_and_seenmask=True runs the full-SZN path (reference
        forward_szn / test_all); False runs plain fcn inference (test_fcn).
        The sums stay on the device until the pass ends.
        """
        cfg, log = self.cfg, self.logger
        step_fn = (self._szn_eval_step if both_fcn_and_seenmask
                   else self._eval_step)
        if step_fn is None:
            raise ValueError("SZN validation requires zero-shot embeddings")

        model = self.state.model
        n = self.n_class
        loss_sum = torch.zeros((), dtype=torch.float64, device=self.device)
        hists = torch.zeros((3, n, n), dtype=torch.int64, device=self.device)
        n_images = 0
        tiles = []
        for batch, dbatch in prefetch_to_device(self.val_loader, self.device):
            out = step_fn(model, dbatch)
            loss_sum += out["loss_sum"].to(torch.float64)
            hists += out["hists"]
            n_images += batch["num_real"]
            if len(tiles) < cfg.num_viz:
                pred = viz_rows(out["pred"], self.mesh)
                for i in range(batch["num_real"]):
                    if len(tiles) >= cfg.num_viz:
                        break
                    h, w = batch["sizes"][i]
                    img = batch_image_rgb(batch["image"][i, :h, :w])
                    tiles.append(visualize_segmentation(
                        lbl_pred=pred[i, :h, :w],
                        lbl_true=batch["label"][i, :h, :w].astype(np.int32),
                        img=img, n_class=n, unseen=list(cfg.val_unseen)))

        viz_dir = osp.join(log.log_dir,
                           "szn_viz" if both_fcn_and_seenmask else "fcn_viz")
        if log.enabled:
            os.makedirs(viz_dir, exist_ok=True)
        if tiles and log.enabled:
            tile = get_tile_image(tiles)
            save_image(osp.join(viz_dir, f"epoch{self.epoch}.jpg"), tile)
            log.image("fcn/segmentations", tile, self.epoch)

        hists = hists.cpu().numpy()
        val_loss = loss_sum.item() / max(n_images, 1)  # per image (ref :250)
        metrics = hist_to_metrics(hists[0])
        row = [self.epoch, self.iteration, val_loss, *metrics]
        log.scalar("fcn/val/loss", val_loss, self.epoch)
        log.scalars("fcn/val", list(_METRIC_NAMES), metrics, self.epoch)
        if self.zeroshot:
            seen_metrics = hist_to_metrics(hists[1])
            unseen_metrics = hist_to_metrics(hists[2])
            log.scalars("fcn/val/seen", list(_METRIC_NAMES), seen_metrics,
                        self.epoch)
            log.scalars("fcn/val/unseen", list(_METRIC_NAMES), unseen_metrics,
                        self.epoch)
            for grp, m in [("seen", seen_metrics), ("unseen", unseen_metrics)]:
                for name, v in zip(_METRIC_NAMES, m):
                    log.stdout(f"{grp} {name}: {v:.3f}")
            row += [*seen_metrics, *unseen_metrics]
        for name, v in zip(_METRIC_NAMES, metrics):
            log.stdout(f"overall {name}: {v:.3f}")
        row.append(log.elapsed_seconds)
        log.csv_append("val_log.csv", val_headers(self.zeroshot), row)

        mean_iu = metrics[2]
        is_best = bool(mean_iu > self.best_mean_iu or
                       np.isnan(self.best_mean_iu))
        if is_best and not np.isnan(mean_iu):
            self.best_mean_iu = mean_iu
        ckpt.save_checkpoint(
            log.log_dir, model_state=model.state_dict(),
            optim_state=self.state.optimizer.state_dict(), epoch=self.epoch,
            iteration=self.iteration, best_mean_iu=self.best_mean_iu,
            is_best=is_best, upscore_trained=self.upscore_trained,
            mesh=self.mesh, optim_param_names=opt_param_names(
                model, self.state.optimizer))
        return mean_iu

    def train(self) -> None:
        """Epoch loop with the reference's image-budget early stop
        (trainer_fcn.py:294-306)."""
        for epoch in range(self.epoch, self.cfg.fcn_epochs):
            self.epoch = epoch
            self.train_epoch()
            self.validate()
            # reference counts epoch * images-per-epoch (trainer_fcn.py:302)
            if epoch * len(self.train_loader.dataset) > self.cfg.early_stop_images:
                break
