"""Closed-loop serving of DeepLab-v2 ResNet-101 through the predict CLI's
batching: `serve_closed`'s client, images, timing and sample, with the
DeepLab model in the program's place.

What differs from `serve_closed.Driver`: the model
(`models.deeplab.DeepLabV2ResNet101` holding `benchmark.weights_r101`'s
tensors, served by `make_szn_predictor`, whose labels take K1 at x8), the
operations (`benchmark.flops_r101.forward_flops` at each image's own
size), K1's bound at the 1/8 heads (64 x 64 at the 512 bucket) and the
check's reference (`benchmark.reference.deeplab`, fp32, TF32 off: the
check's cosines too). A program without the DeepLab model fails at set-up,
before any weight is drawn.

Besides the cell's fp8 control, `FAULTS` names structural faults planted
in the reference put in the program's place (`--control` of the control
tests): the configuration changed as each says, the weights drawn from the
configuration as it stands. They show that the check sees the dilated
stages and the ASPP heads, not only the precision.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import bounds, flops_r101
from benchmark.reference import deeplab as ref
from benchmark.reference.labels import label_gaps, stitched_labels
from benchmark.traffic import serve_closed
from benchmark.weights_r101 import make_weights

REF_CHUNK = serve_closed.REF_CHUNK
# control name -> the configuration's keys as the faulty reference runs it
FAULTS = {
    "dilation1": lambda cfg: {"dilations": [1, 1, 1, cfg["dilations"][3]]},
    "aspp_drop": lambda cfg: {"aspp_rates": cfg["aspp_rates"][:-1]},
    "skip_block": lambda cfg: {"blocks": [*cfg["blocks"][:2],
                                          cfg["blocks"][2] - 1,
                                          cfg["blocks"][3]]},
}


class Driver(serve_closed.Driver):
    def __init__(self, ctx):
        from zeroshotsemanticsegmentation_tpu_torch.cli.predict import (
            predict_arrays)
        from zeroshotsemanticsegmentation_tpu_torch.models.deeplab import (
            DeepLabV2ResNet101)
        from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
        self._model_cls = DeepLabV2ResNet101
        self.ctx, self.cfg, self.mix = ctx, ctx.cfg, ctx.mix
        self.bucket = tuple(ctx.overrides.get("bucket", self.cfg["bucket"]))
        self.batch = int(self.mix["batch_size"])
        self._predict_arrays = predict_arrays
        self._counts = _kernels.launch_counts
        rng = np.random.Generator(np.random.PCG64(ctx.seed))
        n = self.batch * int(self.mix["distinct_requests"])
        sizes = serve_closed.image_sizes(self.mix, n, rng)
        if "image_scale" in ctx.overrides:  # the CPU tests' small images
            f = ctx.overrides["image_scale"]
            sizes = [(max(16, int(h * f)), max(16, int(w * f)))
                     for h, w in sizes]
        images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                  for h, w in sizes]
        self.requests = [images[i:i + self.batch]
                         for i in range(0, n, self.batch)]
        self.pixels = [sum(im.shape[0] * im.shape[1] for im in r)
                       for r in self.requests]
        self.flops = [sum(flops_r101.forward_flops(
            self.cfg, im.shape[0], im.shape[1]) for im in r)
            for r in self.requests]
        self.embed = ctx.embeddings()
        self.unseen = list(self.cfg["unseen_classes"])
        self.model = None
        self.predict = self._make_predict()
        self.most = max(range(len(self.requests)),
                        key=lambda i: self.pixels[i])
        self.keep: list = []
        self.keep_most = None
        self.seen = self.seen_most = 0
        self.rng = np.random.Generator(np.random.PCG64(ctx.seed + 1))

    def _program_model(self, weights: dict):
        """The port's DeepLab model on the device holding `weights`: built
        on the meta device, then given the seeded tensors."""
        cfg, ctx = self.cfg, self.ctx
        with torch.device("meta"):
            model = self._model_cls(
                cfg["embed_dim"], dtype=ctx.dtype,
                channel_scale=cfg.get("channel_scale", 1.0),
                blocks=tuple(cfg["blocks"]), device="meta")
        model = model.to_empty(device=ctx.device)
        model.load_state_dict(weights, strict=True)
        return model

    def _make_predict(self):
        ctx = self.ctx
        if ctx.control:  # the reference in the control's precision
            return self._reference_predict(ctx.control)
        from zeroshotsemanticsegmentation_tpu_torch.serving import (
            make_szn_predictor)
        self.model = self._program_model(
            make_weights(self.cfg, ctx.seed, ctx.device))
        return make_szn_predictor(self.model, None, self.embed, self.unseen,
                                  upscore_trained=False, device=ctx.device)

    def _reference_predict(self, control):
        """The reference in the program's place: in fp8 or int8, or with
        one of `FAULTS` (dilation 1 in layer3, the last ASPP rate left out,
        layer3's last block left out) in fp32."""
        p = make_weights(self.cfg, self.ctx.seed, self.ctx.device)
        emb = torch.from_numpy(self.embed).to(self.ctx.device)
        cfg, quant = self.cfg, control
        if control in FAULTS:
            cfg, quant = {**cfg, **FAULTS[control](cfg)}, None

        @torch.no_grad()
        def predict(batch):
            x = ref.normalize(batch.to(self.ctx.device))
            score, seen = ref.heads(cfg, p, x, quant=quant)
            return stitched_labels(score, seen, emb, self.unseen)
        return predict

    def window(self, seconds: float) -> dict:
        lat = []
        n_req = len(self.requests)
        k1_0 = self._counts["szn_fused"]
        t0 = time.perf_counter()
        deadline = t0 + seconds
        t1 = t0
        while t1 < deadline:
            i = len(lat) % n_req
            ts = time.perf_counter()
            with record_function("bench.request"):
                labels = self._serve(i)
            t1 = time.perf_counter()
            lat.append(t1 - ts)
            self._offer(i, labels)
        window_s = t1 - t0
        idx = [k % n_req for k in range(len(lat))]
        pixels = sum(self.pixels[i] for i in idx)
        h8 = flops_r101.head_side(self.cfg, self.bucket[0])
        w8 = flops_r101.head_side(self.cfg, self.bucket[1])
        return {
            "attempted": len(lat), "failed": 0,
            "values": {"serve_mpix_s": pixels / window_s / 1e6,
                       "serve_p95_ms": float(np.percentile(lat, 95)) * 1e3},
            "work": {"requests": len(lat),
                     "flops": float(sum(self.flops[i] for i in idx)),
                     "k1_launches": self._counts["szn_fused"] - k1_0,
                     "k1_bound_s": bounds.k1_bound_s(
                         self.batch, h8, w8, len(self.embed) + 1,
                         *self.bucket),
                     "model_cfg": self.cfg}}

    def check(self) -> dict:
        """As `serve_closed.Driver.check`, under the DeepLab reference: the
        served labels' widest `label_gap` and `class_gap` beside the
        cell's limits."""
        with ref.NoTF32():
            return self._check()

    def _check(self) -> dict:
        ctx = self.ctx
        limits = ctx.cell["limits"]
        p = make_weights(self.cfg, ctx.seed, ctx.device)
        emb = torch.from_numpy(self.embed).to(ctx.device)
        got = {"label_gap": 0.0, "class_gap": 0.0}
        gap_sum, pixels = 0.0, 0
        for i, labels in self.sample():
            batch = torch.from_numpy(serve_closed.pad_batch(
                self.requests[i], self.bucket, len(self.requests[i])))
            for a in range(0, batch.shape[0], REF_CHUNK):
                with torch.no_grad():
                    x = ref.normalize(batch[a:a + REF_CHUNK].to(ctx.device))
                    score, seen = ref.heads(self.cfg, p, x)
                for j in range(score.shape[0]):
                    lb = torch.from_numpy(np.asarray(labels[a + j]))
                    h, w = lb.shape
                    g = label_gaps(score[j:j + 1, :, :h, :w],
                                   seen[j:j + 1, :, :h, :w], emb,
                                   self.unseen, lb[None].to(ctx.device),
                                   float(limits["class_gap"]))
                    for name in got:
                        got[name] = max(got[name], g[name])
                    gap_sum += g["gap_sum"]
                    pixels += g["pixels"]
                del score, seen
        got["label_gap_mean"] = gap_sum / max(pixels, 1)
        self.readings = got
        return {name: (got[name], float(lim)) for name, lim in
                limits.items()}
