"""Per-pixel row dot over the last axis (K10b), the port of the Pallas kernel
in the JAX package's H2D probe (`scripts/probe_h2d.py`, mode `rowdot_pl`).

`rowdot(a, b)` is sum(a * b, -1) for two fp32 (..., C) tensors of one shape,
any C: (B, H, W, C) x 2 -> (B, H, W). The sum runs in channel order from 0.0
in one fp32 accumulator, each product and each addition rounded on its own.

* On a CUDA tensor `rowdot` launches `csrc/rowdot.cu` or raises.
* On a CPU tensor it runs `rowdot_plain`, the same sum in torch ops; the
  kernel and the plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels

_ARGTYPES = [_kernels.P] * 3 + [_kernels.LL, _kernels.I, _kernels.I,
                                _kernels.P]


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape != b.shape or a.dim() < 1:
        raise ValueError(f"rowdot: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"rowdot: inputs must be float32, got {a.dtype} "
                         f"and {b.dtype}")


def rowdot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K10b: acc = 0; acc = acc + a[..., c] * b[..., c] for
    c = 0 .. C-1, in fp32."""
    _check(a, b)
    acc = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
    for c in range(a.shape[-1]):
        acc = acc + a[..., c] * b[..., c]
    return acc


def rowdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b, -1) of two fp32 (..., C) tensors: K10b on CUDA tensors,
    `rowdot_plain` on CPU tensors."""
    if not a.is_cuda:
        return rowdot_plain(a, b)
    _check(a, b)
    if b.device != a.device:
        raise ValueError(f"rowdot: inputs on {a.device} and {b.device}")
    a, b = a.contiguous(), b.contiguous()
    c = a.shape[-1]
    out = torch.empty(a.shape[:-1], dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    if c == 0:
        return out.zero_()
    vec4 = int(a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    fn = _kernels.function("rowdot", "rowdot_launch", _ARGTYPES)
    p = _kernels.ptr
    rc = fn(p(a), p(b), p(out), out.numel(), c, vec4,
            _kernels.P(_kernels.stream_handle(a.device)))
    _kernels.check("rowdot", rc)
    _kernels.launch_counts["rowdot"] += 1
    return out
