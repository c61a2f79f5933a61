"""Observability triple: stdout, CSV logs, TensorBoard (the JAX package's
utils/logging.py).

Mirrors the reference's channels and tag names (trainer_fcn.py:66-81,
167-178, 226-267; train.py:54,288-300): per-iteration train CSVs + scalars,
per-epoch val CSVs + scalars with seen/unseen breakdowns, the config dump,
an elapsed wall-clock column (US/Eastern epoch start, trainer_fcn.py:43).

TensorBoard through tensorboardX when importable, silently off otherwise.
`config.yaml` is written without PyYAML (`dump_yaml`): the config is flat.
`enabled=False` makes a logger that writes nothing at all (the ranks of a
mesh other than rank 0).
"""

from __future__ import annotations

import datetime
import json
import math
import os
import os.path as osp
from zoneinfo import ZoneInfo

_TZ = ZoneInfo("America/New_York")


def _yaml_scalar(v) -> str:
    """One flat config value as a YAML 1.1 flow scalar or sequence."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        # YAML 1.1 reads a float only with a dot (1e-05 would be a string)
        r = repr(v).lower()
        return r.replace("e", ".0e", 1) if "." not in r and "e" in r else r
    if isinstance(v, str):
        return json.dumps(v)  # JSON's escapes are YAML double-quoted ones
    if isinstance(v, (tuple, list)):
        return "[" + ", ".join(_yaml_scalar(x) for x in v) + "]"
    raise TypeError(f"no YAML form for {type(v).__name__} value {v!r}")


def dump_yaml(cfg_dict: dict) -> str:
    """A flat mapping of ints, floats, strings, bools and tuples of them as
    YAML, keys sorted (what yaml.safe_dump reads back the same)."""
    return "".join(f"{k}: {_yaml_scalar(cfg_dict[k])}\n"
                   for k in sorted(cfg_dict))


class RunLogger:
    def __init__(self, log_dir: str, *, tb_dir: str | None = None,
                 tensorboard: bool = True, verbose: bool = True,
                 enabled: bool = True):
        self.log_dir = log_dir
        self.enabled = enabled
        self.verbose = verbose and enabled
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
        self.timestamp_start = datetime.datetime.now(_TZ)
        self._csv_files: dict[str, object] = {}
        self._tb = None
        if tensorboard and enabled:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(tb_dir or osp.join(log_dir, "tb"))

    @property
    def elapsed_seconds(self) -> float:
        return (datetime.datetime.now(_TZ)
                - self.timestamp_start).total_seconds()

    # -- channels ----------------------------------------------------------

    def stdout(self, msg: str) -> None:
        if self.verbose:
            print(msg, flush=True)

    def csv_append(self, fname: str, headers: list[str], row: list) -> None:
        """Persistent handles, flushed per row: tailing a live run and a
        crash mid-run both see every logged row."""
        if not self.enabled:
            return
        f = self._csv_files.get(fname)
        if f is None:
            path = osp.join(self.log_dir, fname)
            fresh = not osp.exists(path)
            f = open(path, "a")
            self._csv_files[fname] = f
            if fresh:
                f.write(",".join(headers) + "\n")
        f.write(",".join(str(x) for x in row) + "\n")
        f.flush()

    def scalar(self, tag: str, value, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def scalars(self, prefix: str, names: list[str], values, step: int) -> None:
        for n, v in zip(names, values):
            self.scalar(f"{prefix}/{n}", v, step)

    def image(self, tag: str, img, step: int) -> None:
        if self._tb is not None:
            self._tb.add_image(tag, img, int(step), dataformats="HWC")

    def text(self, tag: str, s: str) -> None:
        if self._tb is not None:
            self._tb.add_text(tag, s)

    def dump_config(self, cfg_dict: dict) -> None:
        """config.yaml + stdout + TB text (reference train.py:288-300)."""
        if not self.enabled:
            return
        for k, v in cfg_dict.items():
            self.stdout(f"{k} {v}")
        with open(osp.join(self.log_dir, "config.yaml"), "w") as f:
            f.write(dump_yaml(cfg_dict))
        self.text("cfg", "\n".join(f"{k}: {v}" for k, v in cfg_dict.items()))

    def close(self) -> None:
        for f in self._csv_files.values():
            f.close()
        self._csv_files.clear()
        if self._tb is not None:
            self._tb.close()
