"""Support-pruned pad-100 VGG blocks: compute only where the data reaches.

The FCN-32s geometry pads conv1_1 by 100, inflating block 1 to (H+198)^2
activations for an H^2 input. Everything the pad region computes is
data-independent: outside the input's receptive-field support, activations
equal the network's zero-input response (the "frame"), a per-channel
constant in the interior with a thin rim near the virtual edge. This module
evaluates the leading VGG blocks exactly while touching only the support
(the JAX package's models/pruned.py, whose argument this follows step by
step):

* data path: VALID convs over the support grown by 1 px per conv, ring-padded
  with the per-channel zero-input constant c_l; pools run on even-aligned,
  even-sized arrays, re-aligned with constant pads;
* constant chain: c_{l+1} = relu(sum_{taps,cin} K c_l + b), c_0 = 0;
* frame probe: one zero image of side 16 + (H mod 2^blocks) through the plain
  pad-100 stack gives the rim pattern at the last pool; the frame for the
  real size is assembled from it by corner/edge/interior expansion;
* materialization: the pooled support is written into the assembled frame
  at its tracked virtual offset.

At 512^2 with 4 blocks, blocks 1-4 run at 516^2/262^2/136^2/73^2 instead of
710^2/355^2/178^2/89^2. `plan_blocks` checks every ring/alignment
constraint with integer arithmetic before the path is used; callers fall
back 4 -> 3 -> plain.

Layout: `run_pruned_blocks` takes the (B, H, W, 3) NHWC image and returns the
NCHW pool array (channels_last memory). Weights are torch OIHW. The ring and
alignment pads return channels_last memory, so blocks 2-4 (their convs,
pools and the copy into the frame) run in it throughout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from zeroshotsemanticsegmentation_tpu_torch.ops import block1_fused, ring_pad
from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import span

# the preferred depth (through pool4), and FCN-8s's (through pool3, the
# array its skip head taps)
NUM_PRUNED_BLOCKS = 4
NUM_PRUNED_BLOCKS_SKIP = 3
_FRAME_RIM = 3
_PROBE_BASE = 16
_MIN_SIDE = 16
_BLOCK_CONVS = (2, 2, 3, 3)


def _zero_input_response(k: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """sum_{i,h,w} k[o,i,h,w] * c[i] -> (o,) fp32."""
    return torch.sum(k.to(torch.float32)
                     * c.to(torch.float32)[None, :, None, None],
                     dim=(1, 2, 3))


def _padc(a: torch.Tensor, c: torch.Tensor, top: int, bottom: int,
          left: int, right: int) -> torch.Tensor:
    """Pad the spatial dims of NCHW `a` with the per-channel constant c,
    differentiable to both, -> channels_last memory: `ops.ring_pad.RingPad`
    (one kernel pass; bf16 or fp32, else ValueError) on the card
    (`ring_pad.kernel_takes`), the plain concatenation on the CPU. One
    `model.ringpad` span (`utils.profiling`) counting the bytes written,
    with `kernel` 1 where the kernel ran and 0 on the plain version."""
    b, ch, h, w = a.shape
    kernel = ring_pad.kernel_takes(a)
    with span("model.ringpad", device=True, bytes=a.element_size() * b * ch
              * (h + top + bottom) * (w + left + right), kernel=int(kernel)):
        pad = ring_pad.RingPad.apply if kernel else ring_pad.ring_pad_plain
        return pad(a, c.to(a.dtype), top, bottom, left, right)


def _expand_dim(p: torch.Tensor, dim: int, out_len: int, lo: int = 0,
                hi: int | None = None) -> torch.Tensor:
    """Positions [lo, hi) (default all) of `p` stretched along `dim` from n
    to out_len by repeating the middle element; exact when the frame is
    constant beyond the rim on both sides of the middle. Slices, an
    expand and a concatenation, so its gradient is a deterministic sum."""
    n = p.shape[dim]
    hi = out_len if hi is None else hi
    if out_len == n and (lo, hi) == (0, n):
        return p
    if out_len < n:
        raise ValueError(f"frame of {n} cannot shrink to {out_len}")
    m = n // 2
    tail = out_len - (n - 1 - m)  # the first position past the middle run
    parts = []
    if min(hi, m) > lo:
        parts.append(p.narrow(dim, lo, min(hi, m) - lo))
    a, b = max(lo, m), min(hi, tail)
    if b > a:
        mid = p.narrow(dim, m, 1)
        shape = list(mid.shape)
        shape[dim] = b - a
        parts.append(mid.expand(shape))
    a = max(lo, tail)
    if hi > a:
        parts.append(p.narrow(dim, m + 1 + a - tail, hi - a))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def assemble_frame(probe: torch.Tensor, out_h: int, out_w: int,
                   rows: tuple | None = None) -> torch.Tensor:
    """(C, ph, pw) pooled zero-input response -> (C, out_h, out_w) frame,
    or its rows [lo, hi) alone with `rows`."""
    if min(probe.shape[1], probe.shape[2]) // 2 < _FRAME_RIM:
        raise ValueError(f"probe {tuple(probe.shape)} too small for the rim")
    lo, hi = (0, out_h) if rows is None else rows
    return _expand_dim(_expand_dim(probe, 1, out_h, lo, hi), 2, out_w)


def probe_side(full_side: int, num_blocks: int) -> int:
    """Probe side whose virtual ceil-pool parity chain matches the input's
    through `num_blocks` pools (identical mod 2^num_blocks)."""
    return _PROBE_BASE + full_side % (1 << num_blocks)


def plan_blocks(in_h: int, in_w: int, pad1: int, num_blocks: int) -> bool:
    """Statically verify every ring/alignment/probe constraint of the pruned
    path for this geometry (integer simulation of `run_pruned_blocks`).
    True when the `num_blocks`-deep pruned path is exact here."""
    if min(in_h, in_w) < _MIN_SIDE or num_blocks > len(_BLOCK_CONVS):
        return False
    s0, rim = 0, 0
    sz = [in_h, in_w]
    v = [in_h + 2 * pad1 - 2, in_w + 2 * pad1 - 2]
    pv = [probe_side(in_h, num_blocks) + 2 * pad1 - 2,
          probe_side(in_w, num_blocks) + 2 * pad1 - 2]
    for bi in range(num_blocks):
        for ci in range(_BLOCK_CONVS[bi]):
            first = bi == 0 and ci == 0
            if not first and not (
                    s0 - 2 >= rim and s0 + sz[0] + 2 + rim <= v[0]
                    and s0 + sz[1] + 2 + rim <= v[1]):
                return False
            sz = [s + 2 for s in sz]
            s0 += (pad1 - 2) if first else -1
            if not first:
                rim += 1
        if s0 % 2:
            if s0 - 1 < rim:
                return False
            s0 -= 1
            sz = [s + 1 for s in sz]
        for d in range(2):
            if sz[d] % 2:
                if s0 + sz[d] + 1 + rim > v[d]:
                    return False
                sz[d] += 1
        s0 //= 2
        sz = [s // 2 for s in sz]
        v = [-(-x // 2) for x in v]
        pv = [-(-x // 2) for x in pv]
        rim = -(-rim // 2)
    if rim > _FRAME_RIM:
        return False
    for d in range(2):
        if min(pv[d] // 2, pv[d] - pv[d] // 2 - 1) < _FRAME_RIM \
                or v[d] < pv[d]:
            return False
    return True


def prunable(in_h: int, in_w: int) -> bool:
    return min(in_h, in_w) >= _MIN_SIDE


def _conv_relu(a, k, b, dtype, padding=0):
    return torch.relu(F.conv2d(a, k.to(dtype), b.to(dtype), padding=padding))


def _plain_stack(kbs, h: torch.Tensor, pad1: int, dtype) -> torch.Tensor:
    """The unpruned pad-100 blocks with ceil-mode pools (NCHW)."""
    for bi, blk in enumerate(kbs):
        for ci, (k, b) in enumerate(blk):
            pad = pad1 if (bi == 0 and ci == 0) else 1
            h = _conv_relu(h, k, b, dtype, pad)
        h = F.max_pool2d(h, 2, 2, ceil_mode=True)
    return h


class _WholeBand:
    """The one-device path as a single band: every level's rows, no
    neighbours (`parallel.spatial.Bands` is a rank's band of several)."""
    first = last = True

    def __init__(self, heights):
        self.heights = heights

    def rows(self, level: int) -> tuple:
        return 0, self.heights[level]

    def halo(self, t, top, bottom, dim):
        return None, None


def _image_rows(x: torch.Tensor, lo: int, hi: int, dtype, left: int = 0,
                right: int = 0) -> torch.Tensor:
    """Rows [lo, hi) of the (B, H, W, 3) images in `dtype`, zeros outside
    them, with `left` and `right` zero columns."""
    h = x.shape[1]
    rows = x[:, max(lo, 0):min(hi, h)].to(dtype)
    return F.pad(rows, (0, 0, left, right, max(-lo, 0),
                        max(hi - max(h, lo), 0)))


def run_pruned_blocks(kbs, x: torch.Tensor, pad1: int, dtype,
                      fused_block1: bool = False,
                      conv_relu=None, band=None) -> torch.Tensor:
    """Run the first len(kbs) VGG blocks of the pad-100 geometry on the
    receptive-field support only.

    kbs: [[(weight OIHW, bias), ...] per block], fp32 parameters.
    x: (B, H, W, 3) image batch (before the pad).
    fused_block1: run block 1 through `ops.block1_fused.block1_op` (the
      CUDA kernel on the card).
    conv_relu: optional (a NCHW, weight, bias) -> activations hook that
      replaces the VALID conv + ReLU of the data path (the int8 forward of
      `models.quantized`); the frame probe and the ring-constant chain stay
      in `dtype`, since the zero-input response must be exact. With a hook,
      block 1 never takes the fused kernel.
    band: a `parallel.spatial.Bands`: compute this rank's rows only. Block
      1 slices its rows (with their halo) from the whole image; every
      later convolution takes one row from each neighbour, and only the
      outermost bands take the ring pads and the alignment pads, which
      follow the one-device geometry.
    Returns the full virtual pool{len(kbs)} array (B, C, h, w), equal to the
    plain pad-100 path (with `band`, its rows `band.rows(len(kbs))`).
    Callers validate the geometry with `plan_blocks` (and `plan_bands`).
    """
    B, H, W, _ = x.shape
    num_blocks = len(kbs)
    dev = x.device
    if conv_relu is None:
        def conv_relu(a, k, b):
            return _conv_relu(a, k, b, dtype)
    else:
        fused_block1 = False  # the hook replaces every data-path conv

    probe = _plain_stack(kbs, torch.zeros(
        (1, 3, probe_side(H, num_blocks), probe_side(W, num_blocks)),
        dtype=dtype, device=dev), pad1, dtype)[0]

    c = torch.zeros((3,), dtype=dtype, device=dev)
    # s0 and e: the data path's first and end row (and column: s0) on the
    # current layer's full (virtual) grid, as one device holds it; t: the
    # virtual row of a[0, 0] (s0 on one device)
    vh, vw = H + 2 * pad1 - 2, W + 2 * pad1 - 2
    if band is None:
        heights = [vh]
        for _ in range(num_blocks):
            heights.append(-(-heights[-1] // 2))
        band = _WholeBand(heights)
    rim = 0
    start_bi = 0
    if fused_block1 and len(kbs[0]) == 2 and kbs[0][1][0].shape[0] == 64 \
            and pad1 >= 8:
        # block 1's frame rim is 0, so its support segment is plain VALID
        # convs on a zero-padded input: K2's output row p is the pool1 row
        # pad1/2 - 2 + p, and reads input rows 2p - 5 .. 2p; a 5-px column
        # pad, +1 right keeps an odd width pool-even (its extra column,
        # data-independent, is dropped)
        (k1, b1), (k2, b2) = kbs[0]
        s0 = (pad1 - 4) // 2
        e = s0 + (H + 6) // 2
        lo, hi = band.rows(1)
        lo, hi = max(lo, s0), min(hi, e)
        xp = _image_rows(x, 2 * (lo - s0) - 5, 2 * (hi - s0) - 1, dtype,
                         5, 5 + W % 2)
        a = block1_fused.block1_op(xp, k1, b1, k2, b2, dtype)
        a = a[:, :, :a.shape[2] - W % 2, :].permute(0, 3, 1, 2)
        for k, b in kbs[0]:
            c = torch.relu(_zero_input_response(k, c).to(dtype) + b.to(dtype))
        t = lo
        vh, vw = -(-vh // 2), -(-vw // 2)
        rim = 1
        start_bi = 1
    for bi in range(start_bi, num_blocks):
        for ci, (k, b) in enumerate(kbs[bi]):
            if bi == 0 and ci == 0:
                # conv1_1's data rows [pad1 - 2, H + pad1) read the image's
                # rows v - pad1 .. v - pad1 + 2 (zeros past its edges)
                s0, e = pad1 - 2, H + pad1
                lo, hi = band.rows(0)
                t, hi = max(lo, s0), min(hi, e)
                a = _image_rows(x, t - pad1, hi - pad1 + 2, dtype, 2, 2)
                a = conv_relu(a.permute(0, 3, 1, 2), k, b)
                c = torch.relu(_zero_input_response(k, c).to(dtype)
                               + b.to(dtype))
                continue
            # ring-pad by 2 with the current constant: +1 halo for the VALID
            # conv, +1 so the support (which grows by 1) is fully computed;
            # an inner band edge takes its neighbour's row instead
            if not (s0 - 2 >= rim and e + 2 + rim <= vh
                    and s0 + a.shape[3] + 2 + rim <= vw):
                raise AssertionError(("ring", bi, ci, s0, rim))
            above, below = band.halo(a, 1, 1, 2)
            if above is not None or below is not None:
                a = torch.cat([p for p in (above, a, below)
                               if p is not None], dim=2)
            a = _padc(a, c, 2 if band.first else 0, 2 if band.last else 0,
                      2, 2)
            a = conv_relu(a, k, b)
            s0, e = s0 - 1, e + 1
            t -= band.first
            c = torch.relu(_zero_input_response(k, c).to(dtype) + b.to(dtype))
            rim += 1
        if s0 % 2:
            a = _padc(a, c, int(band.first), 0, 1, 0)
            s0 -= 1
            t -= band.first
        padb, padr = (e % 2) * band.last, a.shape[3] % 2
        if padb or padr:
            a = _padc(a, c, 0, padb, 0, padr)
            e += padb
        if t % 2 or a.shape[2] % 2:
            raise AssertionError(("band", bi, t, a.shape[2]))
        a = F.max_pool2d(a, 2, 2)
        s0, e, t = s0 // 2, e // 2, t // 2
        vh, vw = -(-vh // 2), -(-vw // 2)
        rim = -(-rim // 2)
    if rim > _FRAME_RIM:
        raise AssertionError(("rim", rim))

    # a hook may leave the data path in a narrower dtype than the ring and
    # frame chain (the int8 forward keeps bf16 activations): the frame
    # rounds to it
    lo, hi = band.rows(num_blocks)
    frame = assemble_frame(probe, vh, vw, (lo, hi)).to(a.dtype)
    # a fresh tensor, so the slice assignment below never writes into a
    # tensor autograd saved; gradients reach both the frame and `a`
    full = frame[None].expand(B, -1, -1, -1).clone(
        memory_format=torch.channels_last)
    full[:, :, t - lo:t - lo + a.shape[2], s0:s0 + a.shape[3]] = a
    return full
