"""The card's peaks and the least time each hand-written kernel could take at
its shapes, frozen here (copied from the port's `chip_smoke.py`, whose
arithmetic each function names).

A bound is the larger of the bytes the kernel must move over the HBM
bandwidth and the operations it must do over the peak rate of the units
it runs on. Each input byte counts once, each output byte once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
PEAK_FP32_FLOP_S = 67e12


def bound_s(nbytes: float, ops: float, peak: float) -> float:
    return max(nbytes / PEAK_BYTES_S, ops / peak)


def k1_bound_s(batch: int, h32: int, w32: int, kp1: int, out_h: int,
               out_w: int) -> float:
    """K1 (`szn_labels_kernel`): reads the fp32 (B, h32, w32, K+1)
    projected heads, writes int32 (B, H, W) labels; 3 operations a class
    and output pixel of the row pass plus the column pass (chip_smoke.py
    phase 6)."""
    nbytes = batch * h32 * w32 * kp1 * 4 + batch * out_h * out_w * 4
    ops = 3 * batch * out_h * (out_w + w32) * kp1
    return bound_s(nbytes, ops, PEAK_FP32_FLOP_S)


def k2_bound_s(batch: int, hp: int, wp: int) -> float:
    """K2 (`block1_fused_wgmma`): conv1_1 (27 -> 64) and conv1_2 (576 ->
    64) in bf16 on the (B, hp, wp, 3) padded input, the pooled bf16 output
    written once (chip_smoke.py phase 6)."""
    hc1, wc1 = hp - 2, wp - 2
    hc2, wc2 = hp - 4, wp - 4
    ops = 2 * batch * (hc1 * wc1 * 27 * 64 + hc2 * wc2 * 576 * 64)
    nbytes = (batch * hp * wp * 3 * 2 + batch * (hc2 // 2) * (wc2 // 2)
              * 64 * 2 + (27 + 576) * 64 * 2 + 128 * 4)
    return bound_s(nbytes, ops, PEAK_BF16_FLOP_S)


def _k34(batch: int, hc: int, wc: int):
    ho, wo = hc - 2, wc - 2
    ops = 2 * batch * ho * wo * 576 * 64
    c11 = batch * hc * wc * 64 * 2
    out = batch * (ho // 2) * (wo // 2) * 64 * 2
    return ops, c11, out


def k3_bound_s(batch: int, hc: int, wc: int) -> float:
    """K3 (`conv2_pool_fwd_wgmma`): conv1_2 + ReLU + pool from the bf16
    conv1_1 output (B, hc, wc, 64) (chip_smoke.py phase 10)."""
    ops, c11, out = _k34(batch, hc, wc)
    return bound_s(c11 + out, ops, PEAK_BF16_FLOP_S)


def k4_bound_s(batch: int, hc: int, wc: int) -> float:
    """K4 (`conv2_pool_route_wgmma`, `conv2_wgrad_wgmma`, `wgrad_reduce`,
    `conv2_dgrad_wgmma`): K3's backward, three convolutions' work, c11
    read twice and the gradient once (chip_smoke.py phase 10)."""
    ops, c11, out = _k34(batch, hc, wc)
    return bound_s(2 * c11 + out, 3 * ops, PEAK_BF16_FLOP_S)


def k5_bound_s(batch: int, h: int, w: int, k: int, c: int) -> float:
    """K5 (`costail_fwd_regs`, `costail_fwd_wide`, `costail_finalize`):
    the fused cosine tail's forward over the fp32 (B, H, W, C) score and
    int32 labels (chip_smoke.py phase 10)."""
    pix = batch * h * w
    return bound_s(pix * c * 4 + pix * 4 + 2 * k * c * 4,
                   pix * (5 * c + 2 * k * c), PEAK_FP32_FLOP_S)


def k6_bound_s(batch: int, h: int, w: int, k: int, c: int) -> float:
    """K6 (`costail_bwd_regs`, `costail_bwd_wide`): its backward, the score
    read and its gradient written (chip_smoke.py phase 10)."""
    pix = batch * h * w
    return bound_s(2 * pix * c * 4 + pix * 4 + k * c * 4, pix * 9 * c,
                   PEAK_FP32_FLOP_S)
