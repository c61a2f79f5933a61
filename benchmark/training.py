"""The training drivers' common part: the port's trainer driven epoch by
epoch over a seeded synthetic feed, and the check of its first steps.

Set-up builds one trainer (`FCNTrainer` for stage 1, `SeenmaskTrainer`
for stage 2) with its model, optimizer and `BatchLoader`, and trains its
first epoch; that same trainer then trains whole epochs in the window. The
first epoch's first `check_steps` steps go through the trainer's own step
and feed on batches that all differ, and are what the check reads: each
step's loss, the first gradient as Adam holds it after one step
(`exp_avg / (1 - beta1)`), and each trained parameter's change after the
last of them; and the first step's full-resolution head that the loss
reads (the model's output in that step: the embedding score in stage 1,
the seenmask score in stage 2), by the norm of its difference from the
reference's, which is first order in the forward's rounding where the
loss and the gaps of norms average it out. The plain fp32 reference
(`reference/train.py`) follows the same steps from the same seeded
weights, batches and dropout masks.

The dropout masks are inputs made from the seed by the port's documented
rule: before step s, a generator on the model's device is seeded with
(seed << 32) + s (stage 2: seed + 1), and one `torch.rand((B, C, 1, 1))`
< 1 - rate draw is made for fc6, then one for fc7.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import bounds, flops
from benchmark.reference import train as ref_train
from benchmark.weights import make_weights

PAD_LABEL = -1


class VocSynthetic:
    """Seeded images and labels of PASCAL VOC-like sizes. Every seed has
    the same set of sizes (fixed quantiles of `side_range`, shuffled by
    the seed); the pixels and the labels (8 x 8 blocks of random classes,
    2% of pixels ignored) are drawn from (seed, index). `raw_images` (set
    by the port's `BatchLoader(compact=True)`) gives uint8 RGB."""

    raw_images = False

    def __init__(self, n: int, num_classes: int, side_range, seed: int):
        lo, hi = side_range
        rng = np.random.Generator(np.random.PCG64(seed))
        side = [int(round(lo + (hi - lo) * (i + 0.5) / n)) for i in range(n)]
        self.sizes = list(zip(rng.permutation(side), rng.permutation(side)))
        self.sizes = [(int(h), int(w)) for h, w in self.sizes]
        self.num_classes, self.seed = num_classes, seed

    def __len__(self) -> int:
        return len(self.sizes)

    def __getitem__(self, index: int) -> dict:
        rng = np.random.Generator(np.random.PCG64([self.seed, int(index)]))
        h, w = self.sizes[index]
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if not self.raw_images:
            img = img.astype(np.float32)
        blocks = rng.integers(0, self.num_classes, (8, 8))
        lbl = np.kron(blocks, np.ones((-(-h // 8), -(-w // 8)), np.int64))
        lbl = lbl[:h, :w].astype(np.int32)
        lbl.ravel()[rng.integers(0, h * w, h * w // 50)] = PAD_LABEL
        return {"image": img, "label": lbl, "id": f"bench_{index}",
                "size": (h, w)}

    def batch(self, k: int, batch: int, bucket) -> tuple:
        """Batch k as the reference takes it: uint8 images zero-padded to
        the bucket, int64 labels padded with -1, int32 sizes."""
        idx = range(k * batch, (k + 1) * batch)
        img = np.zeros((batch, *bucket, 3), np.uint8)
        lbl = np.full((batch, *bucket), PAD_LABEL, np.int64)
        sizes = np.zeros((batch, 2), np.int32)
        raw = self.raw_images
        self.raw_images = True
        try:
            for j, i in enumerate(idx):
                s = self[i]
                h, w = s["size"]
                img[j, :h, :w], lbl[j, :h, :w], sizes[j] = (
                    s["image"], s["label"], (h, w))
        finally:
            self.raw_images = raw
        return (torch.from_numpy(img), torch.from_numpy(lbl),
                torch.from_numpy(sizes))


def dropout_masks(cfg: dict, seed: int, step: int, batch: int, device):
    """(fc6 keep, fc7 keep) of step `step` by the port's rule."""
    gen = torch.Generator(device=device).manual_seed((seed << 32) + step)
    keep = 1.0 - cfg["dropout"]
    m6 = torch.rand((batch, cfg["fc6_channels"], 1, 1), generator=gen,
                    device=device) < keep
    m7 = torch.rand((batch, cfg["fc7_channels"], 1, 1), generator=gen,
                    device=device) < keep
    return m6[:, :, 0, 0], m7[:, :, 0, 0]


def gaps(prog: dict, refd: dict, cut: float = 1e-3) -> tuple:
    """(the worst leaf's, the median leaf's) |prog - ref| / max(ref, the
    median leaf's ref) over leaves whose reference reads at least `cut` of
    the median leaf's (`refd`, `prog`: name -> norm), and the worst leaf's
    name."""
    vals = sorted(refd.values())
    med = vals[len(vals) // 2]
    per = sorted((abs(prog[n] - r) / max(r, med), n)
                 for n, r in refd.items() if r >= cut * med)
    return per[-1][0], per[len(per) // 2][0], per[-1][1]


def score_gaps(prog: torch.Tensor, refs: torch.Tensor) -> tuple:
    """(the worst image's, the median image's) ||prog - ref|| / ||ref|| of
    the first step's head, `prog` NHWC as the model returns it, `refs`
    NCHW; an image left out reads 1."""
    if prog.shape[0] != refs.shape[0]:
        return 1.0, 1.0
    per = []
    for i in range(refs.shape[0]):
        r = refs[i].double()
        p = prog[i].to(r.device, torch.float64).permute(2, 0, 1)
        per.append(float((p - r).norm() / r.norm().clamp(min=1e-30)))
    per.sort()
    return per[-1], per[len(per) // 2]


class TrainDriver:
    stage = 1

    def __init__(self, ctx):
        from zeroshotsemanticsegmentation_tpu_torch.configs import get_config
        from zeroshotsemanticsegmentation_tpu_torch.data import BatchLoader
        from zeroshotsemanticsegmentation_tpu_torch.utils import RunLogger
        self.ctx, self.cfg, self.mix = ctx, ctx.cfg, ctx.mix
        cuda = ctx.device.type == "cuda"
        self.bucket = tuple(ctx.overrides.get("bucket", self.cfg["bucket"]))
        self.batch = int(ctx.overrides.get("batch_size",
                                           self.mix["batch_size"]))
        self.n_batches = int(ctx.overrides.get("batches_per_epoch",
                                               self.mix["batches_per_epoch"]))
        self.check_steps = int(self.mix["check_steps"])
        self.seed31 = ctx.seed % (1 << 31)
        side = ctx.overrides.get("side_range", self.mix["side_range"])
        self.dataset = VocSynthetic(self.batch * self.n_batches,
                                    self.cfg["num_classes"], side, ctx.seed)
        step_flops = flops.stage1_flops if self.stage == 1 else \
            flops.stage2_flops
        self.epoch_flops = float(sum(step_flops(self.cfg, h, w)
                                     for h, w in self.dataset.sizes))
        self.embed = ctx.embeddings()
        self.steps_seen = 0
        self.prog = {}
        self.trainer = None
        if ctx.control:
            return
        self.pcfg = get_config(
            self.cfg["preset"], arch=self.cfg["arch"], batch_size=self.batch,
            bucket=self.bucket, data_echo="off", compact_feed=True,
            log_flush_steps=int(self.mix["log_flush_steps"]), num_viz=0,
            profile_steps=0, seed=self.seed31,
            **{"fcn_lr" if self.stage == 1 else "seenmask_lr":
               float(self.mix["lr"])},
            compute_dtype=self.cfg["compute_dtype"],
            prune_pad=self.cfg["prune_pad"],
            channel_scale=ctx.channel_scale,
            fused_block1="on" if self.cfg["fused_block1"] else "off")
        self.loader = BatchLoader(
            self.dataset, self.batch, bucket_hw=self.bucket, shuffle=False,
            num_threads=int(self.mix["loader_threads"]), compact=True,
            pin_memory=cuda, device=ctx.device if cuda else None)
        weights = make_weights(self.cfg, ctx.seed, ctx.device)
        self.model = ctx.program_model(weights)
        self.names = ref_train.trainable(self.stage, weights)
        self.w0 = {n: weights[n].detach().cpu() for n in self.names}
        del weights
        self.log_dir = tempfile.mkdtemp(prefix="bench_logs_",
                                        dir=os.environ.get("TMPDIR"))
        self.logger = RunLogger(self.log_dir, tensorboard=False,
                                verbose=False)
        self.trainer = self.make_trainer()
        self._step = self.trainer._train_step
        self.trainer._train_step = self._spy

    def make_trainer(self):
        raise NotImplementedError

    # ---- the first steps, seen through the trainer's own step --------

    def _spy(self, state, batch, gen):
        heads = []
        hook = None
        if self.steps_seen == 0:  # the heads the first step's loss reads
            hook = self.model.register_forward_hook(
                lambda mod, args, out: heads.append(
                    (out[0] if isinstance(out, tuple) else out).detach().to(
                        "cpu", torch.float32, copy=True)))
        try:
            st, aux = self._step(state, batch, gen)
        finally:
            if hook is not None:
                hook.remove()
        if heads:
            self.prog["scores"] = torch.cat(heads)
        k = self.steps_seen
        self.steps_seen += 1
        params = dict(self.model.named_parameters())
        if k < self.check_steps:
            self.prog.setdefault("losses", []).append(
                float(aux["loss"].detach()))
        if k == 0:
            opt = self.trainer.state.optimizer
            b1 = opt.param_groups[0]["betas"][0]
            # a step that left no moment behind gave the optimizer nothing
            self.prog["g1"] = {
                n: float(opt.state[params[n]]["exp_avg"].double().norm())
                / (1 - b1) if "exp_avg" in opt.state[params[n]] else 0.0
                for n in self.names}
        if k == self.check_steps - 1:
            self.prog["delta"] = {
                n: float((params[n].detach().cpu().double()
                          - self.w0[n].double()).norm()) for n in self.names}
            self.trainer._train_step = self._step
        return st, aux

    # ---- the driver's interface ---------------------------------------

    def warm(self) -> None:
        """The first epoch: every shape of the step, the feed's threads,
        and the steps the check reads."""
        if self.trainer is not None:
            self.trainer.train_epoch()

    def window(self, seconds: float) -> dict:
        if self.trainer is None:  # the control runs no program
            return {"attempted": 1, "failed": 0, "values": {},
                    "work": {}}
        it0 = self.trainer.iteration
        t0 = time.perf_counter()
        deadline = t0 + seconds
        epochs = 0
        while True:
            self.trainer.train_epoch()
            self.ctx.sync()
            epochs += 1
            t1 = time.perf_counter()
            if t1 >= deadline:
                break
        steps = self.trainer.iteration - it0
        b = self.batch
        bh, bw = self.bucket
        return {"attempted": steps, "failed": 0,
                "values": {"train_img_s": steps * b / (t1 - t0)},
                "work": {"steps": steps, "flops": epochs * self.epoch_flops,
                         "k3_bound_s": bounds.k3_bound_s(b, bh + 8, bw + 8),
                         "k4_bound_s": bounds.k4_bound_s(b, bh + 8, bw + 8),
                         "k5_bound_s": bounds.k5_bound_s(
                             b, bh, bw, self.cfg["num_classes"],
                             self.cfg["embed_dim"]),
                         "k6_bound_s": bounds.k6_bound_s(
                             b, bh, bw, self.cfg["num_classes"],
                             self.cfg["embed_dim"])}}

    def free(self) -> None:
        if self.trainer is not None:
            self.logger.close()
            shutil.rmtree(self.log_dir, ignore_errors=True)
        self.trainer = self.model = self.loader = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """Each step's loss, the first step's head, the first gradient and
        the change after the checked steps against the fp32 reference (TF32
        off), each as its worst relative gap, beside the cell's limits."""
        ctx = self.ctx
        dev = ctx.device
        limits = ctx.cell["limits"]
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            weights = make_weights(self.cfg, ctx.seed, dev)
            batches = [tuple(t.to(dev) for t in self.dataset.batch(
                k, self.batch, self.bucket)) for k in range(self.check_steps)]
            mseed = self.seed31 + (1 if self.stage == 2 else 0)
            masks = [dropout_masks(self.cfg, mseed, k, self.batch, dev)
                     for k in range(self.check_steps)]
            emb = torch.from_numpy(self.embed).to(dev)
            lr = float(self.mix["lr"])
            if ctx.control:  # the reference in the program's place
                self.prog = ref_train.run_steps(
                    self.cfg, self.stage, weights, batches, masks, emb, lr,
                    self.cfg["unseen_classes"],
                    quant=None if ctx.control == "half_batch"
                    else ctx.control,
                    half=ctx.control == "half_batch")
                # NHWC, as the model returns its heads
                self.prog["scores"] = self.prog["scores"].permute(0, 2, 3, 1)
            refd = ref_train.run_steps(self.cfg, self.stage, weights,
                                       batches, masks, emb, lr,
                                       self.cfg["unseen_classes"])
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        loss_gap = max(abs(p - r) / abs(r) for p, r in
                       zip(self.prog["losses"], refd["losses"]))
        g, g_med, _ = gaps(self.prog["g1"], refd["g1"])
        sg, sg_med = score_gaps(self.prog.pop("scores"), refd.pop("scores"))
        d, d_med, d_leaf = gaps(self.prog["delta"], refd["delta"])
        self.readings = {"loss_gap": loss_gap, "score_gap": sg,
                         "score_gap_median": sg_med, "grad_gap": g,
                         "grad_gap_median": g_med, "delta_gap": d,
                         "delta_gap_median": d_med, "delta_gap_leaf": d_leaf}
        # the numbers the cell's limits name are compared
        return {k: (self.readings[k], float(lim))
                for k, lim in limits.items()}
