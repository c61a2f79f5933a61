"""2x2 stride-2 max pooling with a dense first-max backward (K9), the port of
the JAX package's shelved experiment `scripts/experiments/pool_bwd_pallas.py`.

`max_pool_2x2(x, pad_bottom, pad_right)` pools NHWC `x` as torch's
`F.max_pool2d(..., 2, 2)` does, after padding odd extents bottom/right with
-inf (ceil mode); `ceil_max_pool_2x2` picks that padding from the extents.
Its backward is `pool_bwd`: the cotangent of each pooled value goes to the
first element of its window, in scan order 00, 01, 10, 11, that equals the
pooled value, and element 11 takes it when none of the first three does
(the Pallas kernel's rule; with a real maximum in every window it is the
four-plane chain of the JAX module's XLA backward, and the routing of
torch's max-pool backward).

* On a CUDA tensor `pool_bwd` launches `csrc/pool_bwd.cu` (any C: 16-byte
  channel vectors where C and the pointers allow, else one channel per
  thread) or raises.
* On a CPU tensor it runs `pool_bwd_plain`, the four-plane chain in torch
  ops.

Like the JAX module, this one is wired into no model: the port's models pool
with `F.max_pool2d` (models/pruned.py, models/fcn32s.py), as the JAX models
pool with `nn.max_pool`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [_kernels.P] * 4 + [_kernels.I] * 6 + [_kernels.P]


def _check(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"pool_bwd: x must be (B, 2h, 2w, C), got "
                         f"{tuple(x.shape)}")
    b, hh, ww, c = x.shape
    want = (b, hh // 2, ww // 2, c)
    if tuple(y.shape) != want or tuple(g.shape) != want:
        raise ValueError(f"pool_bwd: y {tuple(y.shape)} and g "
                         f"{tuple(g.shape)} do not match x {tuple(x.shape)}")


def pool_bwd_plain(x: torch.Tensor, y: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: dx (like x) of y = 2x2/2 max pool of x (even
    extents) from the four window planes, compared in fp32."""
    _check(x, y, g)
    b, hh, ww, c = x.shape
    x6 = x.reshape(b, hh // 2, 2, ww // 2, 2, c).to(torch.float32)
    yf = y.to(torch.float32)
    g = g.to(x.dtype)
    dx = torch.zeros((b, hh // 2, 2, ww // 2, 2, c), dtype=x.dtype,
                     device=x.device)
    taken = torch.zeros(y.shape, dtype=torch.bool, device=x.device)
    for i, j in ((0, 0), (0, 1), (1, 0), (1, 1)):
        e = ~taken if (i, j) == (1, 1) else (x6[:, :, i, :, j] == yf) & ~taken
        taken |= e
        dx[:, :, i, :, j] = torch.where(e, g, torch.zeros_like(g))
    return dx.view(b, hh, ww, c)


def pool_bwd(x: torch.Tensor, y: torch.Tensor,
             g: torch.Tensor) -> torch.Tensor:
    """K9 wrapper: dx (like x) of y = 2x2/2 max pool of NHWC x (B, 2h, 2w,
    C), with y and g (B, h, w, C). Launches `csrc/pool_bwd.cu` on CUDA
    tensors (fp32 or bf16), runs `pool_bwd_plain` on CPU tensors."""
    if not x.is_cuda:
        return pool_bwd_plain(x, y, g)
    _check(x, y, g)
    if x.dtype not in _DTYPES:
        raise ValueError(f"pool_bwd: dtype {x.dtype} not supported")
    if y.device != x.device or g.device != x.device:
        raise ValueError(f"pool_bwd: x on {x.device}, y on {y.device}, g on "
                         f"{g.device}")
    x = x.contiguous()
    y = y.to(x.dtype).contiguous()
    g = g.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx
    b, hh, ww, c = x.shape
    vec = int(all(t.data_ptr() % 16 == 0 for t in (x, y, g, dx)))
    fn = _kernels.function("pool_bwd", "pool_bwd_launch", _ARGTYPES)
    p = _kernels.ptr
    rc = fn(p(x), p(y), p(g), p(dx), b, hh // 2, ww // 2, c, _DTYPES[x.dtype],
            vec, _kernels.P(_kernels.stream_handle(x.device)))
    _kernels.check("pool_bwd", rc)
    _kernels.launch_counts["pool_bwd"] += 1
    return dx


def _pad(x: torch.Tensor, pad_bottom: int, pad_right: int) -> torch.Tensor:
    if not (pad_bottom or pad_right):
        return x
    return F.pad(x, (0, 0, 0, pad_right, 0, pad_bottom), value=float("-inf"))


class _MaxPool2x2(torch.autograd.Function):
    """The JAX module's `max_pool_2x2` custom_vjp: torch's pool forward,
    K9 backward."""

    @staticmethod
    def forward(ctx, x, pad_bottom, pad_right):
        xp = _pad(x, pad_bottom, pad_right)
        y = F.max_pool2d(xp.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        y = y.contiguous()
        ctx.save_for_backward(xp, y)
        ctx.hw = x.shape[1:3]
        return y

    @staticmethod
    def backward(ctx, g):
        xp, y = ctx.saved_tensors
        h, w = ctx.hw
        return pool_bwd(xp, y, g)[:, :h, :w], None, None


def max_pool_2x2(x: torch.Tensor, pad_bottom: int = 0,
                 pad_right: int = 0) -> torch.Tensor:
    """2x2 stride-2 max pool of NHWC `x` (B, H, W, C), after padding
    `pad_bottom` rows and `pad_right` columns of -inf (H + pad_bottom and
    W + pad_right even), differentiable through K9."""
    if x.dim() != 4 or (x.shape[1] + pad_bottom) % 2 \
            or (x.shape[2] + pad_right) % 2:
        raise ValueError(f"max_pool_2x2: {tuple(x.shape)} padded by "
                         f"({pad_bottom}, {pad_right}) is not pool-even")
    return _MaxPool2x2.apply(x, pad_bottom, pad_right)


def ceil_max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """Ceil-mode 2x2/2 pool: odd extents padded bottom/right with -inf."""
    return max_pool_2x2(x, x.shape[1] % 2, x.shape[2] % 2)
