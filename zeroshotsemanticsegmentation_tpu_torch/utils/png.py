"""A minimal PNG writer for 8-bit grayscale label maps (no Pillow).

`write_gray8(path, values)` writes an (H, W) uint8 array as a non-interlaced
8-bit grayscale PNG: the signature, IHDR, one zlib-compressed IDAT whose
rows all carry filter 0 (none), and IEND, each chunk with its CRC. Every
conforming decoder reads it back exactly, the port's native decoder
(`data.native.NativeLoader.decode_label`) among them.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xffffffff))


def encode_gray8(values: np.ndarray, level: int = 6) -> bytes:
    """The PNG file of (H, W) uint8 `values`, as bytes."""
    values = np.asarray(values)
    if values.ndim != 2 or values.dtype != np.uint8:
        raise ValueError(f"encode_gray8 takes an (H, W) uint8 array, not "
                         f"{values.dtype} {values.shape}")
    h, w = values.shape
    if h == 0 or w == 0:
        raise ValueError(f"a PNG needs at least one pixel, not {h}x{w}")
    # each row: filter byte 0, then the row's bytes
    rows = np.empty((h, w + 1), np.uint8)
    rows[:, 0] = 0
    rows[:, 1:] = values
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_gray8(path: str, values: np.ndarray, level: int = 6) -> None:
    """Writes (H, W) uint8 `values` to `path` as an 8-bit grayscale PNG."""
    data = encode_gray8(values, level)
    with open(path, "wb") as f:
        f.write(data)
