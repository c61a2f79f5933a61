"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control control|half_batch]

From the root of a checkout, on a machine with an NVIDIA GPU: set-up
(weights from the seed, the program's kernels built or loaded from its
build directory), warm-up of every shape the cell uses, a measured window
of `--seconds`, then the check of what the window produced against the
plain reference. The last line of standard output is one JSON object
(`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
also `breakdown`, and last `checks`: each compared number beside its
limit); the compared numbers are also the last lines of standard error.
`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics from a `torch.profiler` trace of the window (at most
its first 15 s: `harness.TRACE_SECONDS`).
`--control control` runs the cell's correctness control (its workload
file's `control`: the program's int8 path, or the reference in int8 or
fp8) in the program's place; `--control half_batch` a training reference
that leaves out half of each batch (a planted fault whose readings bound
the limits). Neither is part of a benchmark run.

Exits non-zero without a result when no card (or fewer than the cell asks
for) is present, or when a module of JAX or of the JAX package is loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import os.path as osp  # noqa: E402
import sys  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CACHE = osp.join(ROOT, ".bench_cache")


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; no
    library may load JAX on its own."""
    os.environ["TORCH_EXTENSIONS_DIR"] = osp.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = osp.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # the checkout's root, not this script's directory, leads the path
    sys.path[:] = [ROOT] + [q for q in sys.path
                            if osp.abspath(q or ".") != osp.dirname(
                                osp.abspath(__file__))]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("none", "control", "half_batch"),
                   default="none")
    args = p.parse_args(argv)
    _environment()

    import torch

    from benchmark import harness

    metrics = harness.cell_spec(args.workload)
    chips = metrics["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} NVIDIA GPU(s); torch.cuda."
              f"is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    ctx = harness.Context.load(args.workload, args.seed, "cuda:0",
                               control="" if args.control == "none"
                               else args.control)
    try:
        out = harness.run_cell(ctx, args.seconds, bool(args.trace), T0,
                               metrics,
                               log=lambda s: print(s, file=sys.stderr))
    except harness.ForbiddenImport as e:
        print(str(e), file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
