"""Fused VGG block 1: conv1_1 + ReLU + conv1_2 + ReLU + 2x2/2 max-pool.

`block1_op` is the model's entry point, routed as the JAX package's
`block1_op` custom_vjp routes it:

* a CPU tensor runs `block1_plain`, the plain PyTorch version with the JAX
  package's `xla_block1` semantics, differentiated by autograd;
* a CUDA call that needs no gradient launches `csrc/block1_fused.cu` (K2),
  which keeps the conv1_1 activation on chip;
* a CUDA call that needs a gradient runs the two-stage training form
  `block1_train`: conv1_1 + bias + ReLU as ordinary torch ops (the JAX
  package leaves this conv to XLA), then `Conv2Pool`, whose forward
  launches K3 (`conv2_pool`, csrc/block1_train.cu) on the saved conv1_1
  activation and whose backward launches K4 (`conv2_pool_backward`).

Layouts: xp (B, Hp, Wp, 3) NHWC, weights in torch's OIHW, output
(B, (Hp-4)/2, (Wp-4)/2, 64) NHWC. Any even, positive Hp-4 and Wp-4. The
conv1_1 activation c11 is (B, Hp-2, Wp-2, 64) NHWC in `dtype`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [_kernels.P] * 6 + [_kernels.I] * 4 + [_kernels.P]
_FWD_ARGTYPES = [_kernels.P] * 4 + [_kernels.I] * 4 + [_kernels.P]
_BWD_ARGTYPES = [_kernels.P] * 11 + [_kernels.I] * 5 + [_kernels.P]


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


def _check_c11(c11: torch.Tensor) -> None:
    if c11.dim() != 4 or c11.shape[-1] != 64:
        raise ValueError(f"conv2_pool: c11 must be (B, Hc, Wc, 64), got "
                         f"{tuple(c11.shape)}")
    ho, wo = c11.shape[1] - 2, c11.shape[2] - 2
    if ho <= 0 or wo <= 0 or ho % 2 or wo % 2:
        raise ValueError(f"conv2_pool: Hc-2 and Wc-2 must be even and "
                         f"positive, got {tuple(c11.shape)}")


def conv2_pool_plain(c11, k2, b2) -> torch.Tensor:
    """Plain version of K3: conv1_2 over the NHWC conv1_1 activation with
    taps rounded to c11's dtype, fp32 accumulation, + b2 in fp32, ReLU,
    2x2/2 max, one rounding to c11's dtype (the rounding points of the JAX
    package's `_kernel`). Its autograd is the plain version of K4: torch's
    max-pool backward routes to the first maximum of each window in scan
    order and ReLU's to `pre > 0`, as `_bwd_kernel` does."""
    _check_c11(c11)
    x = c11.permute(0, 3, 1, 2).to(torch.float32)
    w = k2.to(c11.dtype).to(torch.float32)
    h = torch.relu(F.conv2d(x, w) + b2.to(torch.float32)[:, None, None])
    return F.max_pool2d(h, 2, 2).to(c11.dtype).permute(0, 2, 3, 1)


def conv2_pool_plain_backward(c11, k2, b2, g):
    """Plain version of K4: autograd of `conv2_pool_plain` -> (d c11,
    d k2, d b2) in the dtypes of the inputs."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (c11, k2, b2)]
        out = conv2_pool_plain(*ins)
        return torch.autograd.grad(out, ins, g)


def _check_train_args(c11, k2, b2) -> None:
    if not c11.is_cuda:
        raise ValueError(f"conv2_pool launches a CUDA kernel; c11 is on "
                         f"{c11.device}")
    if c11.dtype not in _DTYPE_CODES:
        raise ValueError(f"conv2_pool: dtype {c11.dtype} not supported")
    _check_c11(c11)
    for t, shape in ((k2, (64, 64, 3, 3)), (b2, (64,))):
        if tuple(t.shape) != shape or t.device != c11.device:
            raise ValueError(f"conv2_pool: weight of shape {tuple(t.shape)} "
                             f"on {t.device}, expected {shape} on "
                             f"{c11.device}")


def conv2_pool(c11, k2, b2) -> torch.Tensor:
    """K3 wrapper: launches `block1_train_forward` (CUDA tensors only).
    c11 (B, Hc, Wc, 64) in bf16 or fp32, k2 OIHW, b2 (64,) -> (B, (Hc-2)/2,
    (Wc-2)/2, 64) in c11's dtype."""
    _check_train_args(c11, k2, b2)
    c11 = c11.contiguous()
    b, hc, wc, _ = c11.shape
    k2h = k2.to(c11.dtype).to(torch.float32).permute(2, 3, 1, 0).contiguous()
    b2f = b2.to(torch.float32).contiguous()
    out = torch.empty((b, (hc - 2) // 2, (wc - 2) // 2, 64), dtype=c11.dtype,
                      device=c11.device)
    fn = _kernels.function("block1_train", "block1_train_forward",
                           _FWD_ARGTYPES)
    p = _kernels.ptr
    rc = fn(p(c11), p(k2h), p(b2f), p(out), b, hc, wc,
            _DTYPE_CODES[c11.dtype],
            _kernels.P(_kernels.stream_handle(c11.device)))
    _kernels.check("block1_train", rc)
    _kernels.launch_counts["block1_train_fwd"] += 1
    return out


def conv2_pool_backward(c11, k2, b2, g):
    """K4 wrapper: launches `block1_train_backward` (CUDA tensors only):
    the route, dK2/db2 and d(c11) kernels. Returns (d c11 in c11's dtype,
    d k2 OIHW in k2's dtype, d b2 in b2's dtype); dK2 and db2 accumulate in
    fp32."""
    _check_train_args(c11, k2, b2)
    dtype = c11.dtype
    c11 = c11.contiguous()
    b, hc, wc, _ = c11.shape
    ho, wo = hc - 2, wc - 2
    if tuple(g.shape) != (b, ho // 2, wo // 2, 64):
        raise ValueError(f"conv2_pool_backward: g {tuple(g.shape)} does not "
                         f"match c11 {tuple(c11.shape)}")
    g = g.to(dtype).contiguous()
    dev = c11.device
    k2f = k2.to(dtype).to(torch.float32)
    k2h = k2f.permute(2, 3, 1, 0).contiguous()
    kflip = k2f.flip(2, 3).permute(2, 3, 0, 1).contiguous()
    b2f = b2.to(torch.float32).contiguous()
    # the dK2 reduction's chunk count: the kernel fixes the chunk length
    n_chunks = _kernels.function("block1_train", "block1_train_wgrad_chunks",
                                 [_kernels.I] * 3)(b, hc, wc)
    f32 = dict(dtype=torch.float32, device=dev)
    dz = torch.empty((b, ho, wo, 64), dtype=dtype, device=dev)
    partial = torch.empty((n_chunks, 9, 64, 64), **f32)
    dbp = torch.empty((n_chunks, 64), **f32)
    dk = torch.empty((9, 64, 64), **f32)
    db = torch.empty((64,), **f32)
    dc11 = torch.empty_like(c11)
    fn = _kernels.function("block1_train", "block1_train_backward",
                           _BWD_ARGTYPES)
    p = _kernels.ptr
    rc = fn(p(c11), p(k2h), p(kflip), p(b2f), p(g), p(dz), p(partial),
            p(dbp), p(dk), p(db), p(dc11), b, hc, wc, n_chunks,
            _DTYPE_CODES[dtype], _kernels.P(_kernels.stream_handle(dev)))
    _kernels.check("block1_train", rc)
    _kernels.launch_counts["block1_train_bwd"] += 1
    dk2 = dk.view(3, 3, 64, 64).permute(2, 3, 0, 1).to(k2.dtype)
    return dc11, dk2.contiguous(), db.to(b2.dtype)


class Conv2Pool(torch.autograd.Function):
    """conv1_2 + bias + ReLU + 2x2 max-pool on the NHWC conv1_1 activation:
    K3 forward, K4 backward (the JAX package's `_conv2_pool` custom_vjp)."""

    @staticmethod
    def forward(ctx, c11, k2, b2):
        ctx.save_for_backward(c11, k2, b2)
        return conv2_pool(c11, k2, b2)

    @staticmethod
    def backward(ctx, g):
        return conv2_pool_backward(*ctx.saved_tensors, g)


def block1_train(xp, k1, b1, k2, b2, dtype=torch.bfloat16) -> torch.Tensor:
    """The training form (the JAX package's two-stage `fused_block1`):
    conv1_1 rounded to `dtype`, + b1 in `dtype`, ReLU as torch ops, then
    `Conv2Pool` on the (B, Hp-2, Wp-2, 64) NHWC activation. The CUDA
    kernels' path; its CPU counterpart is `block1_plain`."""
    _check_geometry(xp)
    x = xp.to(dtype).permute(0, 3, 1, 2)
    c11 = torch.relu(F.conv2d(x, k1.to(dtype)) + b1.to(dtype)[:, None, None])
    return Conv2Pool.apply(c11.permute(0, 2, 3, 1).contiguous(),
                           k2.to(dtype), b2.to(torch.float32))


def block1_op(xp, k1, b1, k2, b2, dtype=torch.bfloat16) -> torch.Tensor:
    """Block 1 forward: the plain version on a CPU tensor; on a CUDA tensor
    K2 when no gradient is needed, else the K3/K4 training form."""
    if not xp.is_cuda:
        return block1_plain(xp, k1, b1, k2, b2, dtype)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xp, k1, b1, k2, b2)):
        return block1_train(xp, k1, b1, k2, b2, dtype)
    return block1_fused(xp, k1, b1, k2, b2, dtype)
