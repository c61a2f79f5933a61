#!/usr/bin/env python3
"""Runs one benchmark cell as `benchmark/run.py` does, with the port's
spans (`utils.profiling`) recorded, and sums them by name.

    python3 scripts/torch_tracing_cost.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

The arguments are `benchmark/run.py`'s. Under `--trace 0` every span of the
run is recorded (`force_tracing`) with no profiler active: the result
line's end-to-end metrics against a plain `benchmark/run.py` run of the
same seed are what tracing costs when it is on. Under `--trace 1` the
profiler's window records them, as in a benchmark run. After the result
line, standard error gets one line `spans: {name: [count, host ms, device
ms]}` over the recorded spans (device ms null off the card). Exits as
`benchmark/run.py` does, non-zero without a card.
"""

import os.path as osp
import sys
import time

T0 = time.perf_counter()

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)

import json  # noqa: E402

from benchmark import run  # noqa: E402
from zeroshotsemanticsegmentation_tpu_torch.utils import (  # noqa: E402
    profiling)


def summary() -> dict:
    out = {}
    for s in profiling.spans(0, 2 ** 63 - 1):
        n, host, dev = out.get(s.name, (0, 0.0, None))
        if s.device_ms is not None:
            dev = (dev or 0.0) + s.device_ms
        out[s.name] = (n + 1, host + s.host_ms, dev)
    return out


def main(argv) -> int:
    run.T0 = T0
    if "--trace" in argv and argv[argv.index("--trace") + 1] == "1":
        rc = run.main(argv)
    else:
        with profiling.force_tracing():
            rc = run.main(argv)
    sys.stdout.flush()
    print("spans: " + json.dumps(summary()), file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
