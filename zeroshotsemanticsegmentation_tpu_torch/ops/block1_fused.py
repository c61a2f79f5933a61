"""Fused VGG block 1: conv1_1 + ReLU + conv1_2 + ReLU + 2x2/2 max-pool.

`block1_op` is the model's entry point. On a CUDA tensor it launches the
kernel `csrc/block1_fused.cu`, which keeps the conv1_1 activation on chip;
on a CPU tensor it runs `block1_plain`, the plain PyTorch version with the
JAX package's `xla_block1` semantics. Serving only: the kernel has no
backward yet, so a CUDA call that would need a gradient raises.

Layouts: xp (B, Hp, Wp, 3) NHWC, weights in torch's OIHW, output
(B, (Hp-4)/2, (Wp-4)/2, 64) NHWC. Any even, positive Hp-4 and Wp-4.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [_kernels.P] * 6 + [_kernels.I] * 4 + [_kernels.P]


def _check_geometry(xp: torch.Tensor) -> None:
    if xp.dim() != 4 or xp.shape[-1] != 3:
        raise ValueError(f"block1: xp must be (B, Hp, Wp, 3), got "
                         f"{tuple(xp.shape)}")
    ch, cw = xp.shape[1] - 4, xp.shape[2] - 4
    if ch <= 0 or cw <= 0 or ch % 2 or cw % 2:
        raise ValueError(f"block1: Hp-4 and Wp-4 must be even and positive, "
                         f"got {tuple(xp.shape)}")


def block1_plain(xp, k1, b1, k2, b2, dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version (the JAX package's `xla_block1`): convs in `dtype`,
    biases added in `dtype`, ReLU, 2x2/2 max-pool."""
    _check_geometry(xp)
    x = xp.permute(0, 3, 1, 2).to(dtype)
    h = torch.relu(F.conv2d(x, k1.to(dtype)) + b1.to(dtype)[:, None, None])
    h = torch.relu(F.conv2d(h, k2.to(dtype)) + b2.to(dtype)[:, None, None])
    return F.max_pool2d(h, 2, 2).permute(0, 2, 3, 1)


def block1_fused(xp, k1, b1, k2, b2, dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel wrapper: launches `csrc/block1_fused.cu` (CUDA tensors only)."""
    _check_geometry(xp)
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"block1_fused: dtype {dtype} not supported")
    dev = xp.device
    if not xp.is_cuda:
        raise ValueError("block1_fused launches a CUDA kernel; xp is on "
                         f"{dev}")
    shapes = ((k1, (64, 3, 3, 3)), (b1, (64,)), (k2, (64, 64, 3, 3)),
              (b2, (64,)))
    for t, shape in shapes:
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"block1_fused: weight of shape "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{shape} on {dev}")
    x = xp.to(dtype).contiguous()
    b, hp, wp, _ = x.shape
    if b > 65535:
        raise ValueError(f"block1_fused: batch {b} exceeds the grid limit")
    # weights as fp32 values rounded to `dtype`, HWIO; b1 rounded, b2 fp32
    hwio = lambda k: k.to(dtype).to(torch.float32).permute(2, 3, 1, 0)  # noqa: E731
    k1h, k2h = hwio(k1).contiguous(), hwio(k2).contiguous()
    b1r = b1.to(dtype).to(torch.float32).contiguous()
    b2f = b2.to(torch.float32).contiguous()
    out = torch.empty((b, (hp - 4) // 2, (wp - 4) // 2, 64), dtype=dtype,
                      device=dev)
    if out.numel() == 0:
        return out
    fn = _kernels.function("block1_fused", "block1_fused_forward", _ARGTYPES)
    p = _kernels.ptr
    rc = fn(p(x), p(k1h), p(b1r), p(k2h), p(b2f), p(out), b, hp, wp,
            _DTYPE_CODES[dtype], _kernels.P(_kernels.stream_handle(dev)))
    _kernels.check("block1_fused", rc)
    _kernels.launch_counts["block1_fused"] += 1
    return out


def block1_op(xp, k1, b1, k2, b2, dtype=torch.bfloat16) -> torch.Tensor:
    """Block 1 forward: the kernel on a CUDA tensor, the plain version on a
    CPU tensor. Raises on a CUDA call that would need a gradient."""
    if not xp.is_cuda:
        return block1_plain(xp, k1, b1, k2, b2, dtype)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xp, k1, b1, k2, b2)):
        raise RuntimeError(
            "block1_op: the fused block-1 kernel has no backward yet; run "
            "under torch.inference_mode() or torch.no_grad(), or build the "
            "model with fused_block1=False")
    return block1_fused(xp, k1, b1, k2, b2, dtype)
