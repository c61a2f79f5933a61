"""Closed-loop serving through the predict CLI's batching.

One client sends a request, waits for its labels and sends the next: what
`cli.predict` does over a photo collection. A request is `batch_size`
uint8 RGB images of PASCAL VOC's sizes (long side `long_side`, short side
in `short_side`, orientation half and half), served by
`cli.predict.predict_arrays` (pad to the bucket, host-to-device copy, the
predictor of `serving.make_szn_predictor`, labels back to the host, crop)
and timed from the call to the host-side int32 labels.

Every seed serves the same set of image sizes: the sizes are fixed
quantiles of the range and the seed shuffles them over the images and
draws the pixels, so the work of a window does not depend on the seed.
The client cycles over `distinct_requests` requests.

The check: a sample of the window's requests drawn from the seed, the
request with the most pixels among them, goes through the plain fp32
reference; each pixel's served label is judged by the reference's scores
(`benchmark.reference.labels.label_gaps`). The sample is drawn as the
window runs (reservoir sampling), so the client keeps the labels of those
requests only and drops every other answer as the predict CLI does: held
answers would grow the process by 16 MB a request and make each new one
fault in fresh pages.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import bounds, flops
from benchmark.reference import fcn as ref
from benchmark.reference.labels import label_gaps, stitched_labels
from benchmark.weights import make_weights

REF_CHUNK = 4  # images a reference forward: fp32 at 710^2 fits in a few GB


def image_sizes(mix: dict, n: int, rng: np.random.Generator) -> list:
    """n (h, w) sizes: short sides at the n quantile midpoints of the range,
    the long side fixed, every other one portrait; shuffled by `rng`."""
    lo, hi = mix["short_side"]
    long = mix["long_side"]
    short = [int(round(lo + (hi - lo) * (i + 0.5) / n)) for i in range(n)]
    sizes = [(s, long) if i % 2 else (long, s) for i, s in enumerate(short)]
    return [sizes[i] for i in rng.permutation(n)]


def pad_batch(images: list, bucket, batch: int) -> np.ndarray:
    """The static batch the predict CLI builds: each image zero-padded
    bottom/right to the bucket, the batch filled with zero images."""
    out = np.zeros((batch, bucket[0], bucket[1], 3), np.uint8)
    for j, img in enumerate(images):
        out[j, :img.shape[0], :img.shape[1]] = img
    return out


class Driver:
    def __init__(self, ctx):
        from zeroshotsemanticsegmentation_tpu_torch.cli.predict import (
            predict_arrays)
        from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
        self.ctx, self.cfg, self.mix = ctx, ctx.cfg, ctx.mix
        self.bucket = tuple(ctx.overrides.get("bucket", self.cfg["bucket"]))
        self.batch = int(self.mix["batch_size"])
        self._predict_arrays = predict_arrays
        self._counts = _kernels.launch_counts
        rng = np.random.Generator(np.random.PCG64(ctx.seed))
        n = self.batch * int(self.mix["distinct_requests"])
        sizes = image_sizes(self.mix, n, rng)
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
        self.flops = [sum(flops.forward_flops(self.cfg, im.shape[0],
                                              im.shape[1]) for im in r)
                      for r in self.requests]
        self.embed = ctx.embeddings()
        self.unseen = list(self.cfg["unseen_classes"])
        self.model = None
        self.predict = self._make_predict()
        self.most = max(range(len(self.requests)),
                        key=lambda i: self.pixels[i])
        # the sample: `check_requests` - 1 finished requests, uniform over
        # the window, and one instance of the request with most pixels
        self.keep: list = []
        self.keep_most = None
        self.seen = self.seen_most = 0
        self.rng = np.random.Generator(np.random.PCG64(ctx.seed + 1))

    def _make_predict(self):
        ctx = self.ctx
        program_int8 = ctx.control == "int8" and self.cfg["arch"] == "fcn32s"
        if ctx.control and not program_int8:
            # the reference in the control's precision
            return self._reference_predict(ctx.control)
        from zeroshotsemanticsegmentation_tpu_torch.serving import (
            make_szn_predictor)
        model = ctx.program_model(make_weights(self.cfg, ctx.seed,
                                               ctx.device))
        self.model = model
        return make_szn_predictor(model, None, self.embed, self.unseen,
                                  upscore_trained=False, device=ctx.device,
                                  int8=program_int8)

    def _reference_predict(self, quant):
        p = make_weights(self.cfg, self.ctx.seed, self.ctx.device)
        emb = torch.from_numpy(self.embed).to(self.ctx.device)

        @torch.no_grad()
        def predict(batch):
            x = ref.normalize(batch.to(self.ctx.device))
            score, seen = ref.heads(self.cfg, p, x, quant=quant)
            return stitched_labels(score, seen, emb, self.unseen)
        return predict

    def _serve(self, i: int):
        return self._predict_arrays(self.predict, self.requests[i],
                                    bucket=self.bucket,
                                    batch_size=self.batch)

    def warm(self) -> None:
        """The one static shape every request takes, twice: the kernels
        are built or loaded and every cache of the program filled."""
        for i in range(2):
            self._serve(i % len(self.requests))

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
        kp1 = len(self.embed) + 1
        h32 = w32 = flops.head_side(self.cfg, self.bucket[0])
        return {
            "attempted": len(lat), "failed": 0,
            "values": {"serve_mpix_s": pixels / window_s / 1e6,
                       "serve_p95_ms": float(np.percentile(lat, 95)) * 1e3},
            "work": {"requests": len(lat),
                     "flops": float(sum(self.flops[i] for i in idx)),
                     "k1_launches": self._counts["szn_fused"] - k1_0,
                     "k1_bound_s": bounds.k1_bound_s(
                         self.batch, h32, w32, kp1, *self.bucket),
                     "k2_bound_s": bounds.k2_bound_s(
                         self.batch, self.bucket[0] + 10,
                         self.bucket[1] + 10)}}

    def free(self) -> None:
        self.predict = self.model = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def _offer(self, i: int, labels) -> None:
        """Reservoir sampling of the finished requests (Vitter's algorithm
        R, one draw a request from the seeded generator)."""
        if i == self.most:
            self.seen_most += 1
            if self.rng.integers(self.seen_most) == 0:
                self.keep_most = (i, labels)
            return
        self.seen += 1
        m = int(self.mix["check_requests"]) - 1
        if len(self.keep) < m:
            self.keep.append((i, labels))
        else:
            j = int(self.rng.integers(self.seen))
            if j < m:
                self.keep[j] = (i, labels)

    def sample(self) -> list:
        """The checked requests: (request index, served labels)."""
        return self.keep + ([self.keep_most] if self.keep_most else [])

    def check(self) -> dict:
        """The served labels' widest `label_gap` and `class_gap` under the
        fp32 reference (TF32 off) beside the cell's limits, the limit on
        `class_gap` being the class near-tie that explains a label."""
        ctx = self.ctx
        limits = ctx.cell["limits"]
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            p = make_weights(self.cfg, ctx.seed, ctx.device)
            emb = torch.from_numpy(self.embed).to(ctx.device)
            got = {"label_gap": 0.0, "class_gap": 0.0}
            gap_sum, pixels = 0.0, 0
            for i, labels in self.sample():
                batch = torch.from_numpy(pad_batch(
                    self.requests[i], self.bucket, len(self.requests[i])))
                for a in range(0, batch.shape[0], REF_CHUNK):
                    with torch.no_grad():
                        x = ref.normalize(
                            batch[a:a + REF_CHUNK].to(ctx.device))
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
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        # the numbers the cell's limits name are compared
        return {name: (got[name], float(lim)) for name, lim in
                limits.items()}
