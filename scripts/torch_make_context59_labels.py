#!/usr/bin/env python3
"""Build 59-class PASCAL-Context label PNGs from the official annotations.

The PyTorch port's copy of scripts/make_context59_labels.py, with the same
flags and the same output, for a machine without JAX or Pillow. The
official distribution (``trainval.tar.gz`` + ``labels.txt``) ships one
``.mat`` file an image whose ``LabelMap`` holds raw category ids; this tool
remaps them to the 59-class vocabulary by name and writes 1-indexed 8-bit
grayscale PNGs for ``data/context.PascalContext(n_classes=59)``:

    pixel value 0      = not one of the 59 classes (read as ignore, -1)
    pixel value 1..59  = index + 1 into assets.CONTEXT59_CLASS_NAMES

A 59-class name missing from ``labels.txt`` fails the run rather than
mislabel. ``.mat`` files are read with scipy.io, PNGs written by the port's
own encoder (``utils/png.py``).

    python3 scripts/torch_make_context59_labels.py \\
        --labels-txt <path>/labels.txt --mat-dir <path>/trainval \\
        --out-dir data/context/59_context_labels [--mat-key LabelMap]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import re
import sys

import numpy as np

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse_labels_txt(path: str) -> dict:
    """``labels.txt`` lines are ``<raw_id>: <name>``; returns {name: raw_id}.
    Blank lines are skipped; any other line that does not parse raises."""
    mapping: dict[str, int] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            m = re.match(r"^(\d+)\s*:\s*(.+)$", line)
            if not m:
                raise ValueError(f"unparseable labels.txt line: {line!r}")
            mapping[m.group(2).strip()] = int(m.group(1))
    return mapping


def build_lut(raw_by_name: dict, max_raw_id: int) -> np.ndarray:
    """(max_raw_id + 1,) uint8 table: raw id -> 1-indexed 59-class id (0 for
    every raw id that is none of the 59)."""
    from zeroshotsemanticsegmentation_tpu_torch.data.assets import (
        CONTEXT59_CLASS_NAMES)

    missing = [n for n in CONTEXT59_CLASS_NAMES if n not in raw_by_name]
    if missing:
        raise ValueError(
            "labels.txt is missing these 59-class names (vocabulary "
            f"mismatch: do not proceed): {missing}")
    lut = np.zeros(max_raw_id + 1, dtype=np.uint8)
    for idx59, name in enumerate(CONTEXT59_CLASS_NAMES):
        raw = raw_by_name[name]
        if raw > max_raw_id:
            raise ValueError(f"raw id {raw} for {name!r} exceeds LabelMap "
                             "range")
        lut[raw] = idx59 + 1
    return lut


def convert(labels_txt: str, mat_dir: str, out_dir: str,
            *, mat_key: str = "LabelMap") -> int:
    """Remaps every ``<mat_dir>/*.mat`` (in sorted order) into
    ``<out_dir>/<name>.png``; returns the number written."""
    import scipy.io

    from zeroshotsemanticsegmentation_tpu_torch.utils.png import write_gray8

    raw_by_name = parse_labels_txt(labels_txt)
    lut = build_lut(raw_by_name, max_raw_id=max(raw_by_name.values()))
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for fname in sorted(os.listdir(mat_dir)):
        if not fname.endswith(".mat"):
            continue
        mat = scipy.io.loadmat(osp.join(mat_dir, fname))
        if mat_key not in mat:
            found = sorted(k for k in mat if not k.startswith("__"))
            raise KeyError(f"{fname}: no {mat_key!r} variable (found "
                           f"{found})")
        raw = np.asarray(mat[mat_key])
        if raw.max() >= lut.shape[0]:
            raise ValueError(f"{fname}: raw id {raw.max()} out of labels.txt "
                             "range")
        write_gray8(osp.join(out_dir, fname[:-4] + ".png"), lut[raw])
        n += 1
    if n == 0:
        raise FileNotFoundError(f"no .mat files under {mat_dir}")
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--labels-txt", required=True)
    p.add_argument("--mat-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--mat-key", default="LabelMap")
    a = p.parse_args(argv)
    n = convert(a.labels_txt, a.mat_dir, a.out_dir, mat_key=a.mat_key)
    print(f"wrote {n} 59-class label PNGs to {a.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
