"""Tracing and per-step timing (the JAX package's utils/profiling.py).

* `profile_trace(dir)`: a torch.profiler trace of the enclosed block (CPU
  and, on the card, CUDA activity), written to `dir` as a Chrome trace
  (viewable in ui.perfetto.dev).
* `StepTimer`: a wall-clock record of step latencies with throughput
  summaries (img/s, MP/s). It times what the host sees: a step on the card
  returns before the device finishes, so time work that ends in a sync.
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp
import time

import numpy as np
import torch


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into
    `log_dir/trace.json`."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(osp.join(log_dir, "trace.json"))


class StepTimer:
    """Accumulates step wall-times; `summary()` reports latency + throughput."""

    def __init__(self, *, pixels_per_step: int | None = None,
                 items_per_step: int | None = None):
        self.pixels_per_step = pixels_per_step
        self.items_per_step = items_per_step
        self._durations: list[float] = []
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._durations.append(time.perf_counter() - self._t0)
        self._t0 = None
        return False

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._t0
        self._durations.append(dt)
        return dt

    @property
    def num_steps(self) -> int:
        return len(self._durations)

    def summary(self, *, skip_warmup: int = 1) -> dict:
        d = np.asarray(self._durations[skip_warmup:] or self._durations)
        out = {
            "steps": int(d.size),
            "mean_s": float(d.mean()),
            "p50_s": float(np.percentile(d, 50)),
            "p99_s": float(np.percentile(d, 99)),
        }
        if self.items_per_step:
            out["items_per_s"] = self.items_per_step / out["mean_s"]
        if self.pixels_per_step:
            out["megapixels_per_s"] = self.pixels_per_step / out["mean_s"] / 1e6
        return out

    def reset(self) -> None:
        self._durations.clear()
