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
NCHW pool array (channels_last memory). Weights are torch OIHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from zeroshotsemanticsegmentation_tpu_torch.ops import block1_fused

NUM_PRUNED_BLOCKS = 4
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
    """Pad the spatial dims of NCHW `a` with the per-channel constant c, by
    concatenation (pad(a - c) + c would perturb interior values)."""
    b, ch, h, w = a.shape
    c = c.to(a.dtype)[None, :, None, None]

    def band(hh, ww):
        return c.expand(b, ch, hh, ww)

    if left or right:
        parts = ([band(h, left)] if left else []) + [a] + \
            ([band(h, right)] if right else [])
        a = torch.cat(parts, dim=3)
        w += left + right
    if top or bottom:
        parts = ([band(top, w)] if top else []) + [a] + \
            ([band(bottom, w)] if bottom else [])
        a = torch.cat(parts, dim=2)
    return a


def _expand_dim(p: torch.Tensor, dim: int, out_len: int) -> torch.Tensor:
    """Stretch `p` along `dim` from n to out_len by repeating the middle
    element; exact when the frame is constant beyond the rim on both sides
    of the middle."""
    n = p.shape[dim]
    if out_len == n:
        return p
    if out_len < n:
        raise ValueError(f"frame of {n} cannot shrink to {out_len}")
    m = n // 2
    mid = p.narrow(dim, m, 1)
    shape = list(mid.shape)
    shape[dim] = out_len - (n - 1)
    return torch.cat([p.narrow(dim, 0, m), mid.expand(shape),
                      p.narrow(dim, m + 1, n - m - 1)], dim=dim)


def assemble_frame(probe: torch.Tensor, out_h: int,
                   out_w: int) -> torch.Tensor:
    """(C, ph, pw) pooled zero-input response -> (C, out_h, out_w) frame."""
    if min(probe.shape[1], probe.shape[2]) // 2 < _FRAME_RIM:
        raise ValueError(f"probe {tuple(probe.shape)} too small for the rim")
    return _expand_dim(_expand_dim(probe, 1, out_h), 2, out_w)


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


def run_pruned_blocks(kbs, x: torch.Tensor, pad1: int, dtype,
                      fused_block1: bool = False) -> torch.Tensor:
    """Run the first len(kbs) VGG blocks of the pad-100 geometry on the
    receptive-field support only.

    kbs: [[(weight OIHW, bias), ...] per block], fp32 parameters.
    x: (B, H, W, 3) image batch (before the pad).
    fused_block1: run block 1 through `ops.block1_fused.block1_op` (the
      CUDA kernel on the card).
    Returns the full virtual pool{len(kbs)} array (B, C, h, w), equal to the
    plain pad-100 path. Callers validate the geometry with `plan_blocks`.
    """
    B, H, W, _ = x.shape
    num_blocks = len(kbs)
    dev = x.device

    probe = _plain_stack(kbs, torch.zeros(
        (1, 3, probe_side(H, num_blocks), probe_side(W, num_blocks)),
        dtype=dtype, device=dev), pad1, dtype)[0]

    c = torch.zeros((3,), dtype=dtype, device=dev)
    # s0: coordinate of a[0, 0] on the current layer's full (virtual) grid
    s0 = 0
    vh, vw = H + 2 * pad1 - 2, W + 2 * pad1 - 2
    rim = 0
    start_bi = 0
    if fused_block1 and len(kbs[0]) == 2 and kbs[0][1][0].shape[0] == 64 \
            and pad1 >= 8:
        # block 1's frame rim is 0, so its support segment is plain VALID
        # convs on a zero-padded input: a symmetric 5-px pad lands the
        # conv1_2 output at [pad1-4, ...), +1 bottom/right keeps odd
        # extents pool-even
        (k1, b1), (k2, b2) = kbs[0]
        xp = F.pad(x.to(dtype), (0, 0, 5, 5 + W % 2, 5, 5 + H % 2))
        a = block1_fused.block1_op(xp, k1, b1, k2, b2, dtype)
        # odd H/W: drop the extra pooled row/col the +1 pad computed (it is
        # data-independent), keeping lockstep with plan_blocks
        a = a[:, :a.shape[1] - H % 2, :a.shape[2] - W % 2, :]
        a = a.permute(0, 3, 1, 2)
        for k, b in kbs[0]:
            c = torch.relu(_zero_input_response(k, c).to(dtype) + b.to(dtype))
        s0 = (pad1 - 4) // 2
        vh, vw = -(-vh // 2), -(-vw // 2)
        rim = 1
        start_bi = 1
    else:
        a = x.to(dtype).permute(0, 3, 1, 2)
    for bi in range(start_bi, num_blocks):
        for ci, (k, b) in enumerate(kbs[bi]):
            first = bi == 0 and ci == 0
            # ring-pad by 2 with the current constant: +1 halo for the VALID
            # conv, +1 so the support (which grows by 1) is fully computed
            if not first and not (
                    s0 - 2 >= rim and s0 + a.shape[2] + 2 + rim <= vh
                    and s0 + a.shape[3] + 2 + rim <= vw):
                raise AssertionError(("ring", bi, ci, s0, rim))
            a = _padc(a, c, 2, 2, 2, 2)
            a = _conv_relu(a, k, b, dtype)
            s0 += (pad1 - 2) if first else -1
            c = torch.relu(_zero_input_response(k, c).to(dtype) + b.to(dtype))
            if not first:
                rim += 1
        if s0 % 2:
            a = _padc(a, c, 1, 0, 1, 0)
            s0 -= 1
        padb, padr = a.shape[2] % 2, a.shape[3] % 2
        if padb or padr:
            a = _padc(a, c, 0, padb, 0, padr)
        a = F.max_pool2d(a, 2, 2)
        s0 //= 2
        vh, vw = -(-vh // 2), -(-vw // 2)
        rim = -(-rim // 2)
    if rim > _FRAME_RIM:
        raise AssertionError(("rim", rim))

    frame = assemble_frame(probe, vh, vw).to(a.dtype)
    # a fresh tensor, so the slice assignment below never writes into a
    # tensor autograd saved; gradients reach both the frame and `a`
    full = frame[None].expand(B, -1, -1, -1).clone(
        memory_format=torch.channels_last)
    full[:, :, s0:s0 + a.shape[2], s0:s0 + a.shape[3]] = a
    return full
