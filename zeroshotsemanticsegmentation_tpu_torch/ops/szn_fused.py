"""Fused SZN inference: class projection + bilinear upsample + stitched
argmax from the raw heads; the full-resolution score volume never exists.

The upsample is the model's fixed transposed-convolution geometry
(stride, kernel, crop): FCN-32s's x32 (32, 64, 19), the default, or
DeepLab-v2's x8 (8, 16, 4) from its 1/8 heads. Every call takes it as
`geometry`; the tap tables are cached per geometry and lengths.

Algebra (as in the JAX package): the upscore is linear and per channel, and
the class projection is linear per pixel, so they commute,

    upsample(score) . e_k / |e_k|  ==  upsample(score . e_k / |e_k|),

and the per-pixel score norm does not change an argmax. The seenmask gate
likewise: sign(upsample(s0 - s1)) decides the seenmask argmax. So:

  1. pre-stage (plain PyTorch, small tensors): fp32 projection of the raw
     head onto the row-normalized embeddings, the gate s0 - s1 appended as
     row K -> `aug` (B, h32, w32, K+1) (h32, w32: the heads' sides, 1/32
     or 1/8 of the image's);
  2. `szn_labels`: the kernel `csrc/szn_fused.cu` (on a CUDA tensor) or its
     plain version `szn_labels_plain` (on a CPU tensor) upsamples each row
     to the output size and takes the masked seen/unseen first-max argmaxes
     (fill 0.0 for excluded classes, -1e30 for the gate row) and the gate
     select, emitting int32 labels.

The partition (`_partition`) is host data, made once per class mask; the
kernel takes it as a bit mask of the seen classes (`kernel_partition`,
checked on the host)
and its launch plan from `k1_plan`, so a request copies nothing from host
memory.

On a mesh (`parallel.mesh`) each rank calls these on its own rows, as the
JAX package's shard_map runs the kernel per data shard: the plan is that
of the local batch, and the callers (the eval steps, serving) sum the
histograms or gather the labels over the data group.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zeroshotsemanticsegmentation_tpu_torch import device_const
from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
from zeroshotsemanticsegmentation_tpu_torch.ops.bilinear import (
    upsample_matrix)

# (stride, kernel, crop) of the fixed bilinear upsample: FCN-32s's x32
FCN32S_GEOMETRY = (32, 64, 19)
_GATE_FILL = -1e30

_ARGTYPES = [_kernels.P] * 7 + [_kernels.I] * 14 + [_kernels.P]

# K1's launch plan, defined by `k1_plan` alone: the kernel takes the
# instance, the layout and the band height as launch arguments
K1_THREADS = 128        # threads a block, 4 warps
K1_RUN = 4              # output columns a thread
K1_ROWS = (8, 4, 2, 1)  # output rows a band: the most whose rows fit
K1_INSTANCES = (22, 34)  # K+1 of the unrolled instances (pascal, context)
K1_MASK_WORDS = 64      # 64-bit words of the seen mask: 4096 real classes
K1_SMEM_LIMIT = 232448  # shared memory a block may opt into on an H100


def _matrix(in_len: int, out_len: int, device,
            geometry: tuple = FCN32S_GEOMETRY) -> torch.Tensor:
    stride, kernel, crop = geometry
    return torch.tensor(upsample_matrix(in_len, stride, kernel, crop,
                                        out_len), device=device)


@functools.lru_cache(maxsize=64)
def _tap_table(in_len: int, out_len: int,
               geometry: tuple = FCN32S_GEOMETRY):
    """The interpolation matrix as a 2-tap table: first input index (int32,
    (out_len,)) and the two weights (fp32, (2, out_len)), numpy. Raises if a
    row has taps that are not two adjacent entries, or if a run of K1_RUN
    output coordinates (K1's register block) spans more than two first
    indices (three tap columns). `geometry` = (stride, kernel, crop)."""
    stride, kernel, crop = geometry
    m = upsample_matrix(in_len, stride, kernel, crop, out_len)
    nz = m != 0
    i0 = np.where(nz.any(axis=1), nz.argmax(axis=1), 0)
    i1 = np.minimum(i0 + 1, in_len - 1)
    o = np.arange(out_len)
    w = np.zeros((2, out_len), np.float32)
    w[0] = m[o, i0]
    w[1] = np.where(i0 + 1 < in_len, m[o, i1], 0.0)
    recon = np.zeros_like(m)
    recon[o, i0] = w[0]
    recon[o, i1] += w[1]
    if not np.array_equal(recon, m):
        raise ValueError("upsample matrix has more than two adjacent taps "
                         f"per row (in_len={in_len}, out_len={out_len})")
    runs = np.pad(i0, (0, -out_len % K1_RUN), mode="edge").reshape(
        -1, K1_RUN)
    if np.any(runs - runs[:, :1] > 1) or np.any(np.diff(i0) < 0):
        raise ValueError(f"a run of {K1_RUN} output coordinates needs more "
                         f"than three tap columns (in_len={in_len}, "
                         f"out_len={out_len})")
    return i0.astype(np.int32), w


def _taps(in_len: int, out_len: int, device, rows: tuple | None = None,
          geometry: tuple = FCN32S_GEOMETRY):
    """`_tap_table` on `device`, copied there once per geometry, lengths
    and rows; with `rows` = (r0, r1) the entries of output coordinates
    [r0, r1) alone (weights still (2, r1 - r0), the kernel's layout)."""
    r0, r1 = (0, out_len) if rows is None else rows
    i0, w = _tap_table(in_len, out_len, geometry)
    key = (in_len, out_len, r0, r1, *geometry)
    return (device_const(("szn_taps_i0", *key),
                         lambda: np.ascontiguousarray(i0[r0:r1]), device),
            device_const(("szn_taps_w", *key),
                         lambda: np.ascontiguousarray(w[:, r0:r1]), device))


def k1_plan(batch: int, h32: int, w32: int, kp1: int, out_h: int,
            out_w: int, n_seen: int) -> dict:
    """K1's launch plan for a partition of the K = kp1 - 1 real classes with
    `n_seen` seen: the kernel instance (22 or 34 unrolled, 0 generic); the
    blended row's layout, each tap column `stride` floats holding the seen
    classes from position 0, the unseen ones from `u0`, the gate at `gate`
    (the unrolled instances pad each partition to a multiple of 4 positions
    for 16-byte loads and give the gate a group of its own); `rows`, the
    output rows of a band, the most of 8, 4, 2, 1 whose blended rows fit
    beside the position tables; the shared memory in bytes; and the grid:
    block `i` takes image i // bands, rows `rows` (i % bands) .. + rows
    (clipped at out_h); within a band, warp w takes tiles w, w + 4, .. of
    `rows` rows x 32 / rows runs of K1_RUN columns (clipped at out_w). A
    plan whose `smem` is past the card's limit is refused at launch."""
    k, n_unseen = kp1 - 1, kp1 - 1 - n_seen

    def layout(padded):
        if padded:
            u0 = 4 * -(-n_seen // 4)
            gate = u0 + 4 * -(-n_unseen // 4)
            return u0, gate, gate + 4
        return n_seen, k, kp1

    instance = kp1 if kp1 in K1_INSTANCES else 0
    u0, gate, stride = layout(instance)
    tables = 4 * (kp1 + stride)
    if instance and 4 * w32 * stride + tables > K1_SMEM_LIMIT:
        instance = 0
        u0, gate, stride = layout(False)
        tables = 4 * (kp1 + stride)
    rows = next((r for r in K1_ROWS
                 if 4 * r * w32 * stride + tables <= K1_SMEM_LIMIT), 1)
    bands = -(-out_h // rows)
    cols = 32 // rows
    return {"instance": instance, "stride": stride, "u0": u0, "gate": gate,
            "rows": rows, "smem": 4 * rows * w32 * stride + tables,
            "bands": bands, "grid": batch * bands, "threads": K1_THREADS,
            "tile": (rows, cols), "tiles": -(-out_w // (K1_RUN * cols))}


def _host(a, dtype, name: str) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"szn_labels: {name} must be host data (numpy "
                             f"or a CPU tensor), got a tensor on {a.device}: "
                             "the kernel reads its partition on the host")
        a = a.numpy()
    return np.asarray(a, dtype=dtype)


@functools.lru_cache(maxsize=64)
def _kernel_partition_cached(seen: bytes, unseen: bytes, fill: bytes):
    s = np.frombuffer(seen, np.int32) != 0
    u = np.frombuffer(unseen, np.int32) != 0
    f = np.frombuffer(fill, np.float32)
    k = s.shape[0] - 1
    if (k < 0 or u.shape != s.shape or f.shape != s.shape or s[k] or u[k]
            or f[k] != np.float32(_GATE_FILL) or np.any(f[:k] != 0.0)
            or np.any(s[:k] == u[:k])):
        raise ValueError(
            "szn_labels: the kernel takes a partition of the K real classes "
            "into seen and unseen (each class in exactly one) with fill 0.0, "
            "and the gate row K last in neither with fill -1e30, as "
            "`_partition` builds it")
    if k > 64 * K1_MASK_WORDS:
        raise ValueError(f"szn_labels: {k} classes, the kernel takes at "
                         f"most {64 * K1_MASK_WORDS}")
    words = np.zeros(K1_MASK_WORDS, np.uint64)
    idx = np.flatnonzero(s[:k])
    np.bitwise_or.at(words, idx // 64, np.left_shift(
        np.uint64(1), (idx % 64).astype(np.uint64)))
    # each partition's first excluded real class (the other partition's
    # first member), -1 for none
    fx = [int(np.argmax(~m[:k])) if np.any(~m[:k]) else -1 for m in (s, u)]
    return words, len(idx), fx[0], fx[1]


def kernel_partition(seen, unseen, fill):
    """The host check and form of K1's partition: raises unless every real
    class k < K is in exactly one of `seen` and `unseen` with fill 0.0 and
    the gate row K is in neither with fill -1e30 (what `_partition`
    builds). Returns the kernel's form: the seen mask (K1_MASK_WORDS
    uint64 words, bit k % 64 of word k // 64; every other real class is
    unseen), the number of seen classes and each partition's first
    excluded real class (-1 for none). Cached on the masks' bytes."""
    return _kernel_partition_cached(
        _host(seen, np.int32, "seen").tobytes(),
        _host(unseen, np.int32, "unseen").tobytes(),
        _host(fill, np.float32, "fill").tobytes())


def _on(a, dtype, device) -> torch.Tensor:
    """A partition array as a tensor on `device`; host data is copied there
    once per content."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    a = np.ascontiguousarray(a, dtype=torch.empty((), dtype=dtype).numpy()
                             .dtype)
    return device_const(("szn_partition", a.dtype.str, a.tobytes()),
                        a.copy, device)


def _rows(out_h: int, rows) -> tuple:
    r0, r1 = (0, out_h) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= r0 < r1 <= out_h:
        raise ValueError(f"szn_labels: rows {rows} outside [0, {out_h})")
    return r0, r1


def szn_labels_plain(aug: torch.Tensor, seen, unseen, fill, out_h: int,
                     out_w: int, rows: tuple | None = None,
                     geometry: tuple = FCN32S_GEOMETRY) -> torch.Tensor:
    """Plain version of the kernel: interpolation-matrix upsample of every
    row of `aug` (B, h32, w32, K+1) to (B, out_h, out_w, K+1) in fp32,
    masked first-max argmaxes (`seen`, `unseen`, `fill` over K+1 rows,
    host data or tensors), gate select -> (B, out_h, out_w) int32. With
    `rows` = (r0, r1): output rows [r0, r1) alone, (B, r1 - r0, out_w).
    `geometry` = (stride, kernel, crop) of the upsample."""
    _, h32, w32, _ = aug.shape
    r0, r1 = _rows(out_h, rows)
    dev = aug.device
    seen, unseen = _on(seen, torch.int32, dev), _on(unseen, torch.int32, dev)
    fill = _on(fill, torch.float32, dev)
    up = torch.einsum("oh,bhwk->bowk",
                      _matrix(h32, out_h, dev, geometry)[r0:r1], aug)
    up = torch.einsum("pw,bowk->bopk", _matrix(w32, out_w, dev, geometry),
                      up)
    seen_arg = torch.argmax(torch.where(seen != 0, up, fill), dim=-1)
    unseen_arg = torch.argmax(torch.where(unseen != 0, up, fill), dim=-1)
    return torch.where(up[..., -1] >= 0, unseen_arg, seen_arg).to(
        torch.int32)


def szn_labels(aug: torch.Tensor, seen, unseen, fill, out_h: int,
               out_w: int, rows: tuple | None = None,
               geometry: tuple = FCN32S_GEOMETRY) -> torch.Tensor:
    """Kernel wrapper: launches `csrc/szn_fused.cu` on a CUDA tensor; a CPU
    tensor takes `szn_labels_plain`. `seen`, `unseen` and `fill` are host
    data (numpy or CPU tensors, as `_partition` returns them): the wrapper
    checks their form on the host (`kernel_partition`) and raises on any
    other form or on a CUDA tensor. The plan comes from `k1_plan`; the
    kernel refuses a plan past the card's limits (the check raises).
    `rows` = (r0, r1): output rows [r0, r1) alone (a band of a
    height-sharded image): the kernel reads rows only through the row tap
    tables and `out_h`, so it is given those tables' rows and r1 - r0.
    `geometry` = (stride, kernel, crop) of the upsample: the kernel sees it
    only through the tap tables."""
    if not aug.is_cuda:
        return szn_labels_plain(aug, seen, unseen, fill, out_h, out_w, rows,
                                geometry)
    if aug.dim() != 4 or aug.dtype != torch.float32 \
            or not aug.is_contiguous():
        raise ValueError("szn_labels: aug must be a contiguous float32 "
                         f"(B, h32, w32, K+1) tensor, got {aug.dtype} "
                         f"{tuple(aug.shape)}")
    b, h32, w32, kp1 = aug.shape
    fill = _host(fill, np.float32, "fill")
    if fill.shape != (kp1,):
        raise ValueError(f"szn_labels: the partition has {fill.shape} "
                         f"rows, aug K+1 = {kp1}")
    words, n_seen, fx_seen, fx_unseen = kernel_partition(seen, unseen, fill)
    dev = aug.device
    r0, r1 = _rows(out_h, rows)
    geometry = tuple(geometry)
    row_i0, row_w = _taps(h32, out_h, dev, (r0, r1), geometry)
    col_i0, col_w = _taps(w32, out_w, dev, None, geometry)
    out_h = r1 - r0
    out = torch.empty((b, out_h, out_w), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    plan = k1_plan(b, h32, w32, kp1, out_h, out_w, n_seen)
    fn = _kernels.function("szn_fused", "szn_fused_labels", _ARGTYPES)
    p = _kernels.ptr
    rc = fn(p(aug), _kernels.P(words.ctypes.data), p(row_i0), p(row_w),
            p(col_i0), p(col_w), p(out), b, h32, w32, kp1, n_seen, out_h,
            out_w, plan["instance"], plan["u0"], plan["gate"],
            plan["stride"], plan["rows"], fx_seen, fx_unseen,
            _kernels.P(_kernels.stream_handle(dev)))
    _kernels.check("szn_fused", rc)
    _kernels.launch_counts["szn_fused"] += 1
    return out


def _embed_scaled(embeddings, device) -> torch.Tensor:
    e = torch.as_tensor(embeddings, dtype=torch.float32, device=device)
    norm2 = torch.sum(e * e, dim=1, keepdim=True)
    return e / torch.sqrt(torch.where(norm2 == 0, torch.ones_like(norm2),
                                      norm2))


def _aug(score_small: torch.Tensor, gate_small: torch.Tensor,
         embed_scaled: torch.Tensor) -> torch.Tensor:
    """Pre-stage: fp32 class projection with the gate appended as row K."""
    sims = torch.einsum("bhwc,kc->bhwk", score_small.to(torch.float32),
                        embed_scaled)
    return torch.cat([sims, gate_small[..., None]], dim=-1).contiguous()


@functools.lru_cache(maxsize=64)
def _partition_cached(seen: bytes, unseen: bytes):
    k = len(seen)
    parts = (np.append(np.frombuffer(seen, bool), False).astype(np.int32),
             np.append(np.frombuffer(unseen, bool), False).astype(np.int32),
             np.append(np.zeros(k, np.float32), np.float32(_GATE_FILL)))
    for a in parts:
        a.setflags(write=False)
    return parts


def _partition(cls_seen, cls_unseen):
    """(seen, unseen, fill) over K+1 rows, host numpy arrays (int32, int32,
    float32) made once per mask; row K (the gate) is in neither partition
    and fills with -1e30 so it never wins an argmax."""
    return _partition_cached(np.asarray(cls_seen, bool).tobytes(),
                             np.asarray(cls_unseen, bool).tobytes())


def infer_labels_szn_fused(score_small: torch.Tensor,
                           seenmask_small: torch.Tensor, embeddings,
                           unseen_class_mask, out_hw: tuple[int, int],
                           rows: tuple | None = None,
                           geometry: tuple = FCN32S_GEOMETRY
                           ) -> torch.Tensor:
    """SZN labels from the raw heads (model mode='raw').

    score_small (B, h32, w32, C), seenmask_small (B, h32, w32, 2) ->
    (B, out_h, out_w) int32, or output rows [r0, r1) alone with `rows`.
    Equivalent to upsampling both heads with the fixed bilinear
    `geometry` (the model's `UPSAMPLE`: stride, kernel, crop) and running
    `ops.nne.infer_labels_szn`."""
    dev = score_small.device
    e = _embed_scaled(embeddings, dev)
    if e.shape[1] != score_small.shape[-1]:
        raise ValueError(f"embeddings {tuple(e.shape)} do not match the "
                         f"score width {score_small.shape[-1]}")
    uv = np.asarray(unseen_class_mask, dtype=bool)
    seen, unseen, fill = _partition(~uv, uv)
    gate = (seenmask_small[..., 0] - seenmask_small[..., 1]).to(torch.float32)
    return szn_labels(_aug(score_small, gate, e), seen, unseen, fill,
                      int(out_hw[0]), int(out_hw[1]), rows, geometry)


def infer_labels_nne_fused(score_small: torch.Tensor, embeddings,
                           out_hw: tuple[int, int]) -> torch.Tensor:
    """Plain (unstitched) NNE over all classes from the raw head, through
    the same kernel: an always-negative gate (the upsample of a constant -1
    stays < 0) makes every pixel take the seen partition, here all classes.
    Equivalent to `ops.nne.infer_labels(upsample(score), embeddings)`."""
    dev = score_small.device
    e = _embed_scaled(embeddings, dev)
    k = e.shape[0]
    seen, unseen, fill = _partition(np.ones(k, bool), np.zeros(k, bool))
    gate = torch.full(score_small.shape[:-1], -1.0, dtype=torch.float32,
                      device=dev)
    return szn_labels(_aug(score_small, gate, e), seen, unseen, fill,
                      int(out_hw[0]), int(out_hw[1]))
