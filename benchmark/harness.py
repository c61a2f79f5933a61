"""The harness: finds a cell's files by name, runs its traffic driver through
set-up, warm-up, the measured window and the check, and assembles the
result line.

Everything a cell needs is found by the names in `BENCHMARK.json`:
`configs/<config>.json` (the model), `traffic/<traffic>.json` (the mix,
which names its driver `traffic/<driver>.py`), `workloads/<cell>.json`
(the limits of the cell's check) and `metrics/<metric>.py` (one reader a
per-layer metric). A driver module defines `Driver(ctx)`, whose
constructor is the set-up, and the methods `warm()`, `window(seconds)`,
`free()` and `check()`.
"""

from __future__ import annotations

import importlib.util
import json
import os
import os.path as osp
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
BENCH_DIR = osp.join(ROOT, "benchmark")
PACKAGE = "zeroshotsemanticsegmentation_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "zeroshotsemanticsegmentation_tpu")
# a traced window's length at most: reading a profile of every kernel of a
# longer one would take the run past its time limit
TRACE_SECONDS = 15.0


def load_json(kind: str, name: str) -> dict:
    with open(osp.join(BENCH_DIR, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """`benchmark/<kind>/<name>.py` as a module (metric names hold dots)."""
    path = osp.join(BENCH_DIR, kind, f"{name}.py")
    mod_name = f"benchmark.{kind}._{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not osp.isfile(path):
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec() -> dict:
    with open(osp.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(name: str, spec: dict | None = None) -> dict:
    """The cell's entry and the end-to-end and per-layer metrics it
    reports (a metric without `workloads` is every cell's)."""
    spec = benchmark_spec() if spec is None else spec
    cells = [w for w in spec["workloads"] if w["name"] == name]
    if not cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"cell": cells[0], "end_to_end": mine(spec["end_to_end"]),
            "per_layer": mine(spec["per_layer"])}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: the port's package name begins with the latter)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Context:
    """One run of one cell: its configuration, mix and limits, the seed and
    the device. `overrides` shrink a configuration or mix for the CPU tests
    (e.g. channel_scale, bucket); `control` swaps the program for the
    correctness control (the cell's `control`: "int8", the program's int8
    path or the reference in int8 where the program has none; "fp8", the
    reference in fp8) or for a planted fault in the reference put in the
    program's place ("half_batch": each training step on half of its
    batch, the mean over that half)."""
    name: str
    cfg: dict
    mix: dict
    cell: dict
    seed: int
    device: torch.device
    control: str = ""
    overrides: dict = field(default_factory=dict)

    @classmethod
    def load(cls, name: str, seed: int, device, *, control: str = "",
             overrides: dict | None = None, spec: dict | None = None):
        entry = cell_spec(name, spec)["cell"]
        overrides = dict(overrides or {})
        cfg = {**load_json("configs", entry["config"]),
               **overrides.pop("cfg", {})}
        mix = {**load_json("traffic", entry["traffic"]),
               **overrides.pop("mix", {})}
        cell = load_json("workloads", name)
        if control == "control":
            control = cell["control"]
        scale = float(overrides.get("channel_scale", 1.0))
        if scale != 1.0:  # the port's `width`: max(8, int(f * scale))
            def w(f):
                return max(8, int(f * scale))
            cfg["vgg"] = [[w(f) for f in blk] for blk in cfg["vgg"]]
            cfg["fc6_channels"] = w(cfg["fc6_channels"])
            cfg["fc7_channels"] = w(cfg["fc7_channels"])
        return cls(name, cfg, mix, cell, int(seed), torch.device(device),
                   control, overrides)

    @property
    def channel_scale(self) -> float:
        return float(self.overrides.get("channel_scale", 1.0))

    @property
    def dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.cfg["compute_dtype"]]

    def embeddings(self) -> np.ndarray:
        return np.load(osp.join(ROOT, self.cfg["embeddings"])).astype(
            np.float32)

    def program_model(self, weights: dict):
        """The port's model of this configuration on the device, holding
        `weights`: built on the meta device (no init of its own is drawn),
        then given the seeded tensors."""
        from zeroshotsemanticsegmentation_tpu_torch.models import (
            FCN8s, FCN32s)
        cls = FCN8s if self.cfg["arch"] == "fcn8s" else FCN32s
        with torch.device("meta"):
            model = cls(self.cfg["embed_dim"], dtype=self.dtype,
                        dropout_rate=self.cfg["dropout"],
                        channel_scale=self.channel_scale,
                        prune_pad=self.cfg["prune_pad"],
                        fused_block1=self.cfg["fused_block1"], device="meta")
        model = model.to_empty(device=self.device)
        model.load_state_dict(weights, strict=True)
        return model

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def run_cell(ctx: Context, seconds: float, trace: bool, t0: float,
             metrics: dict, log=print) -> dict:
    """Set-up, warm-up, window and check of one cell; returns the result
    line's object. `t0` is the process's start on the host clock;
    `metrics` is `cell_spec(...)`."""
    from benchmark import timeline as tr

    t_imports = time.perf_counter() - t0
    drv = load_module("traffic", ctx.mix["driver"]).Driver(ctx)
    ctx.sync()
    t_built = time.perf_counter() - t0
    drv.warm()
    ctx.sync()
    setup_s = time.perf_counter() - t0
    log(f"setup: imports {t_imports:.3f} s, build {t_built - t_imports:.3f}"
        f" s, warm-up {setup_s - t_built:.3f} s")
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if ctx.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        with record_function(tr.WINDOW_SPAN):
            stats = drv.window(min(seconds, TRACE_SECONDS))
        ctx.sync()
        prof.stop()
    else:
        stats = drv.window(seconds)
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    out = {"correct": False, "attempted": stats["attempted"],
           "failed": stats["failed"], "metrics": {}}
    if trace:
        t = tr.from_profiler(prof, stats["work"])
        del prof
        for m in metrics["per_layer"]:
            v = load_module("metrics", m["name"]).read(t)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        device_extra = {"busy_s": t.busy_s, "window_s": t.window_s}
        breakdown = {"device_ops": t.device_ops(),
                     "idle_gaps": t.idle_gaps()}
    else:
        values = {**stats["values"], "setup_s": setup_s, "peak_gb": peak / 1e9}
        for m in metrics["end_to_end"]:
            if m["name"] in values:  # a control run measures no rate
                out["metrics"][m["name"]] = {"value": values[m["name"]],
                                             "unit": m["unit"]}
        device_extra = {}
    out["device"] = {"platform": "gpu" if ctx.device.type == "cuda"
                     else ctx.device.type,
                     "kind": (torch.cuda.get_device_name(ctx.device)
                              if ctx.device.type == "cuda" else "cpu"),
                     "count": 1, "memory_peak_bytes": peak, **device_extra}
    if trace:
        out["breakdown"] = breakdown
    drv.free()
    t_check = time.perf_counter()
    checks = drv.check()
    log(f"check: {time.perf_counter() - t_check:.3f} s; readings "
        + json.dumps(getattr(drv, "readings", {})))
    out["correct"] = bool(stats["attempted"] > 0 and stats["failed"] == 0
                          and all(v <= lim for v, lim in checks.values()))
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"check {k} {v!r} limit {lim!r}")
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    return out


class ForbiddenImport(RuntimeError):
    def __init__(self, found):
        super().__init__("modules of JAX or of the JAX package are loaded: "
                         + ", ".join(found))
