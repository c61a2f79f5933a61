#!/usr/bin/env python3
"""Writes the seeded JPEG fixtures of the native decoder's checks
(tests/torch_fixtures/) and records their decodes.

    python3 scripts/torch_make_decode_fixtures.py           # write them
    python3 scripts/torch_make_decode_fixtures.py --check   # compare only

Each fixture is a seeded image (`source_image`: smooth waves and a few
soft-edged shapes, numpy only, so a machine without a JPEG encoder
regenerates it) encoded by Pillow at its spec's quality and chroma
subsampling. `fixtures.json` records each file's SHA-256, the SHA-256 of
Pillow's decode (libjpeg-turbo, islow IDCT, fancy upsampling) and that
decode's mean and max |err| from the source; `residuals.npz` holds
Pillow's decodes less the source (int8), so a machine whose decoder is not
libjpeg (nvJPEG) compares with libjpeg's pixels (`libjpeg_decode`).
`--check` regenerates everything in memory and exits non-zero when a
committed file differs.

The label helpers (`label_array`, `write_png`) need numpy and the standard
library only: `chip_smoke.py` phase 24 and tests/test_torch_native.py write
their PNG labels with them (8-bit and packed 1/2/4-bit gray and palette,
every filter, Adam7).
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os.path as osp
import struct
import sys
import zlib

import numpy as np

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE_DIR = osp.join(ROOT, "tests", "torch_fixtures")

# name: (height, width, seed, quality, subsampling (Pillow: 0 = 4:4:4,
# 2 = 4:2:0), mode): VOC-like sizes, at most 500 px a side
SPECS = {
    "landscape_420": (375, 500, 1, 90, 2, "RGB"),
    "portrait_420": (500, 375, 2, 85, 2, "RGB"),
    "landscape_444": (333, 500, 3, 95, 0, "RGB"),
    "gray": (281, 400, 4, 90, 2, "L"),
}


def source_image(name: str) -> np.ndarray:
    """The seeded source of fixture `name`: uint8 (h, w, 3), or (h, w) for a
    gray fixture."""
    h, w, seed, _, _, mode = SPECS[name]
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64) / max(h, w)
    img = np.full((h, w, 3), 128.0)
    for c in range(3):
        for _ in range(6):
            fy, fx = rng.uniform(0.5, 14.0, 2)
            amp, phase = rng.uniform(6.0, 22.0), rng.uniform(0, 2 * np.pi)
            img[..., c] += amp * np.sin(2 * np.pi * (fx * x + fy * y) + phase)
    for _ in range(8):  # soft-edged ellipses of flat colour
        cy, cx = rng.uniform(0, 1, 2) * (h / max(h, w), w / max(h, w))
        ry, rx = rng.uniform(0.04, 0.2, 2)
        d = ((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2
        alpha = np.clip((1.0 - d) * 6.0, 0.0, 1.0)[..., None]
        img = img * (1 - alpha) + alpha * rng.uniform(20, 235, 3)
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img.mean(-1).round().astype(np.uint8) if mode == "L" else img


def encode(name: str) -> bytes:
    import PIL.Image
    _, _, _, quality, subsampling, mode = SPECS[name]
    buf = io.BytesIO()
    PIL.Image.fromarray(source_image(name), mode=mode).save(
        buf, format="JPEG", quality=quality, subsampling=subsampling)
    return buf.getvalue()


def pil_decode(data: bytes) -> np.ndarray:
    """Pillow's RGB decode, as the JAX package's Python path reads an
    image."""
    import PIL.Image
    return np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"),
                      dtype=np.uint8)


def as_rgb(img: np.ndarray) -> np.ndarray:
    return np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def generate() -> tuple[dict, dict, dict]:
    """(files {name.jpg: bytes}, the record, Pillow's decodes)."""
    files, record, decodes = {}, {}, {}
    for name in SPECS:
        data = encode(name)
        dec = pil_decode(data)
        err = np.abs(dec.astype(np.int32) - as_rgb(source_image(name)))
        h, w, seed, quality, subsampling, mode = SPECS[name]
        files[f"{name}.jpg"] = data
        decodes[name] = dec
        record[name] = {
            "file": f"{name}.jpg", "hw": [h, w], "seed": seed,
            "quality": quality, "subsampling": subsampling, "mode": mode,
            "bytes": len(data), "sha256": sha256(data),
            "decode_sha256": sha256(dec.tobytes()),
            "decode_mean_abs_err": float(err.mean()),
            "decode_max_abs_err": int(err.max())}
    return files, record, decodes


def residuals(decodes: dict) -> dict:
    return {k: (v.astype(np.int16) - as_rgb(source_image(k))).astype(np.int8)
            for k, v in decodes.items()}


def _npz_bytes(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def load_record() -> dict:
    with open(osp.join(FIXTURE_DIR, "fixtures.json")) as f:
        return json.load(f)


def libjpeg_decode(name: str) -> np.ndarray:
    """Pillow's (libjpeg's) decode of fixture `name`, rebuilt from its
    source and the committed residual."""
    with np.load(osp.join(FIXTURE_DIR, "residuals.npz")) as z:
        res = z[name]
    return (as_rgb(source_image(name)).astype(np.int16) + res).astype(
        np.uint8)


def check() -> list[str]:
    """The committed files that differ from what this script writes now."""
    files, record, decodes = generate()
    bad = [f for f, data in files.items()
           if not osp.isfile(osp.join(FIXTURE_DIR, f))
           or open(osp.join(FIXTURE_DIR, f), "rb").read() != data]
    if not osp.isfile(osp.join(FIXTURE_DIR, "fixtures.json")) \
            or load_record() != record:
        bad.append("fixtures.json")
    if not osp.isfile(osp.join(FIXTURE_DIR, "residuals.npz")) or any(
            not np.array_equal(libjpeg_decode(k), v)
            for k, v in decodes.items()):
        bad.append("residuals.npz")
    return bad


# ------------------------------------------------------------- labels

def label_array(seed: int, h: int, w: int, n_values: int = 21,
                boundary: int | None = 255) -> np.ndarray:
    """A seeded label map: rectangles of values in [0, n_values) over a
    background of 0, one-pixel `boundary` borders (VOC's 255) unless
    None. uint8 (h, w)."""
    rng = np.random.default_rng(seed)
    lbl = np.zeros((h, w), np.uint8)
    for _ in range(10):
        y0, x0 = int(rng.integers(0, h - 2)), int(rng.integers(0, w - 2))
        y1 = int(rng.integers(y0 + 2, min(h, y0 + h // 2) + 1))
        x1 = int(rng.integers(x0 + 2, min(w, x0 + w // 2) + 1))
        lbl[y0:y1, x0:x1] = rng.integers(0, n_values)
        if boundary is not None:
            lbl[y0, x0:x1] = lbl[y1 - 1, x0:x1] = boundary
            lbl[y0:y1, x0] = lbl[y0:y1, x1 - 1] = boundary
    return lbl


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _pack(row: np.ndarray, depth: int) -> np.ndarray:
    if depth == 8:
        return row.astype(np.uint8)
    per = 8 // depth
    n = -(-len(row) // per)
    padded = np.zeros(n * per, np.int64)
    padded[:len(row)] = row
    shifts = 8 - depth * (np.arange(per) + 1)
    groups = padded.reshape(n, per) << shifts
    return groups.sum(1).astype(np.uint8)


def _filter(kind: int, x: np.ndarray, prev: np.ndarray) -> np.ndarray:
    xi, up = x.astype(np.int64), prev.astype(np.int64)
    left = np.concatenate([[0], xi[:-1]])
    ul = np.concatenate([[0], up[:-1]])
    if kind == 0:
        pred = np.zeros_like(xi)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) // 2
    else:
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, ul))
    return ((xi - pred) % 256).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xffffffff))


def write_png(path: str, values: np.ndarray, *, depth: int = 8,
              palette: bool = False, interlace: bool = False,
              seed: int = 0) -> None:
    """Writes `values` ((h, w) ints below 2**depth) as a gray or palette
    PNG of `depth` bits, Adam7-interlaced or not, each row's filter drawn
    from `seed`, the image data split over two IDAT chunks."""
    values = np.asarray(values)
    h, w = values.shape
    if values.min() < 0 or values.max() >= 2 ** depth:
        raise ValueError(f"values outside {depth} bits")
    rng = np.random.default_rng(seed)
    raw = bytearray()
    for sx, sy, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = values[sy::dy, sx::dx]
        if sub.size == 0:
            continue
        prev = np.zeros(len(_pack(sub[0], depth)), np.uint8)
        for row in sub:
            packed = _pack(row, depth)
            kind = int(rng.integers(0, 5))
            raw += bytes([kind]) + _filter(kind, packed, prev).tobytes()
            prev = packed
    color = 3 if palette else 0
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette:
        out += _chunk(b"PLTE", bytes(
            c for i in range(2 ** depth) for c in (i, 255 - i, (7 * i) % 256)))
    z = zlib.compress(bytes(raw), 9)
    half = len(z) // 2
    out += _chunk(b"IDAT", z[:half]) + _chunk(b"IDAT", z[half:])
    out += _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)


def png_values(values: np.ndarray, depth: int, palette: bool) -> np.ndarray:
    """What a decoder reads from `write_png(values, depth, palette)`:
    palette indices as they are, gray scaled to 8 bits as libpng's
    png_set_expand_gray_1_2_4_to_8 does."""
    v = np.asarray(values, np.int32)
    return v if palette or depth == 8 else v * (255 // (2 ** depth - 1))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--check", action="store_true",
                   help="compare the committed files; write nothing")
    args = p.parse_args(argv)
    if args.check:
        bad = check()
        print(json.dumps({"differ": bad}))
        return 1 if bad else 0
    files, record, decodes = generate()
    for f, data in files.items():
        with open(osp.join(FIXTURE_DIR, f), "wb") as fh:
            fh.write(data)
    with open(osp.join(FIXTURE_DIR, "fixtures.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")
    with open(osp.join(FIXTURE_DIR, "residuals.npz"), "wb") as f:
        f.write(_npz_bytes(residuals(decodes)))
    print(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
