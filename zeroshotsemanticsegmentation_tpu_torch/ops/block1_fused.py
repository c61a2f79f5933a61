"""Fused VGG block 1: conv1_1 + ReLU + conv1_2 + ReLU + 2x2/2 max-pool.

`block1_op` is the model's entry point, routed as the JAX package's
`block1_op` custom_vjp routes it:

* a CPU tensor runs `block1_plain`, the plain PyTorch version with the JAX
  package's `xla_block1` semantics, differentiated by autograd;
* a CUDA call that needs no gradient launches `csrc/block1_fused.cu` (K2),
  which keeps the conv1_1 activation on chip: in bf16 on the tensor cores
  (`block1_fused_wgmma`: conv1_1 as a K = 32 GEMM from the input patch,
  then conv1_2 on the same `wgmma` mainloop and pool epilogue as K3, both
  weight images packed by `pack_conv_weights`; `block1_tile_plan` mirrors
  its tiling for the CPU tests), in fp32 on the CUDA cores;
* a CUDA call that needs a gradient runs the two-stage training form
  `block1_train`: conv1_1 + bias + ReLU as ordinary torch ops (the JAX
  package leaves this conv to XLA), then `Conv2Pool`, whose forward
  launches K3 (`conv2_pool`, csrc/block1_train.cu) on the saved conv1_1
  activation and whose backward launches K4 (`conv2_pool_backward`). In
  bf16 both run on the tensor cores (`csrc/conv3x3_wgmma.cuh`): the host
  packs k2 into the mainloop's shared-memory image (`pack_conv_weights`),
  and `conv_tile_plan` and `wgrad_chunks` mirror the kernels' tiling and
  dK2 chunking for the CPU tests. fp32 runs the CUDA-core kernels.

`conv1_1_pairs` is conv1_1 + bias + ReLU on its own, the port of the JAX
package's `conv1_1_pairs` (K8, `csrc/conv1_1.cu`: bf16 a K = 32 `wgmma`
product with TMA stores, tiled as `c11_tile_plan` says; fp32 on the CUDA
cores; its plain version `conv1_1_pairs_plain` runs on a CPU tensor). No model path calls it, as in
the JAX package: the block-1 bench (`scripts/torch_bench_block1.py`) feeds
it to K3.

Layouts: xp (B, Hp, Wp, 3) NHWC, weights in torch's OIHW, output
(B, (Hp-4)/2, (Wp-4)/2, 64) NHWC. Any even, positive Hp-4 and Wp-4. The
conv1_1 activation c11 is (B, Hp-2, Wp-2, 64) NHWC in `dtype`; for even Wp
the JAX package's packed-pair layout (B, Hp-2, (Wp-2)/2, 128), lane e*64+c of
pair q = column 2q+e, channel c, is the same memory under a view.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [_kernels.P] * 6 + [_kernels.I] * 4 + [_kernels.P]
# K3's entry point: four pointers, four ints, the stream; K8's also takes
# its tile plan's two ints
_FWD_ARGTYPES = [_kernels.P] * 4 + [_kernels.I] * 4 + [_kernels.P]
_C11_ARGTYPES = [_kernels.P] * 4 + [_kernels.I] * 6 + [_kernels.P]
_BWD_ARGTYPES = [_kernels.P] * 11 + [_kernels.I] * 6 + [_kernels.P]


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
    """Kernel wrapper: launches `csrc/block1_fused.cu` (CUDA tensors only);
    bf16 on the tensor cores (`block1_fused_wgmma`), fp32 on the CUDA
    cores."""
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
    if dtype == torch.float32 and b > 65535:
        raise ValueError(f"block1_fused: batch {b} exceeds the grid limit")
    if dtype == torch.bfloat16:
        # the packed wgmma images of conv1_1's (32, 64) and conv1_2's
        # (9, 64, 64) B matrices
        k1h = pack_conv_weights(conv1_1_b_matrix(k1.to(dtype))[None])
        k2h = pack_conv_weights(conv_b_matrices(k2.to(dtype)))
    else:
        k1h = k1.to(dtype).permute(2, 3, 1, 0).contiguous()  # HWIO
        k2h = k2.to(dtype).permute(2, 3, 1, 0).contiguous()
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


# ---- the bf16 kernels' plan (csrc/conv3x3_wgmma.cuh, csrc/block1_train.cu)

WGMMA_WINDOWS = 8        # a conv tile is 8x8 2x2 windows: 16x16 pixels
WGRAD_SEG = 64           # conv2_wgrad_wgmma: pixels of one row per step
WGRAD_CHUNK_SEGS = 64    # steps per block
WGRAD_CHUNK_PIX = 4096   # fp32 conv2_wgrad: pixels per block


def conv_b_matrices(k2: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """The GEMM B operand of each tap, (9, K, N) [tap][k][n], from OIHW
    k2: the forward's B[kh*3+kw][ci][co] = k2[co, ci, kh, kw] (HWIO); with
    `flip`, d(c11)'s B[th*3+tw][co][ci] = k2[co, ci, 2-th, 2-tw] (dz
    channels in, c11 channels out)."""
    if flip:
        return k2.flip(2, 3).permute(2, 3, 0, 1).reshape(9, 64, 64)
    return k2.permute(2, 3, 1, 0).reshape(9, 64, 64)


def conv1_1_b_matrix(k1: torch.Tensor) -> torch.Tensor:
    """conv1_1's GEMM B operand for bf16 K2, (32, 64) [k][n], from OIHW
    k1: B[(kh * 3 + kw) * 3 + ci][co] = k1[co, ci, kh, kw], rows 27-31
    zero (K padded to two k16 steps)."""
    b = k1.permute(2, 3, 1, 0).reshape(27, 64)
    return torch.cat([b, b.new_zeros(5, 64)])


def pack_conv_weights(b: torch.Tensor) -> torch.Tensor:
    """(T, K, 64) [tap][k][n], K a multiple of 16 -> the bf16
    shared-memory image the wgmma mainloop reads as B: T * K / 16 steps
    (tap, 16-channel k step) of 2048 B, each the no-swizzle K-major layout
    of 8x2 core matrices (n-group nc, k-half kc) at (2 nc + kc) * 128 B, a
    core matrix 8 n-rows of 8 k values. Shape (T, K / 16, 8, 2, 8, 8):
    [tap][ks][nc][kc][n % 8][k % 8]. conv1_2's (9, 64, 64) gives the 72 KB
    image, conv1_1's (1, 32, 64) the 4 KB one."""
    t, k, _ = b.shape
    return (b.to(torch.bfloat16).reshape(t, k // 16, 2, 8, 8, 8)
            .permute(0, 1, 4, 2, 5, 3).contiguous())


def conv_tile_plan(batch: int, hc: int, wc: int) -> dict:
    """The bf16 kernels' tiling of a c11 of (batch, hc, wc, 64):
    `pool`, the (batch, tiles_y, tiles_x) grid of 8x8-window tiles that
    K3 and K4's route walk (tile (ty, tx) owns pooled pixels 8 ty .., 8 tx
    ..); `dgrad`, the grid of 16x16-pixel tiles of d(c11); both walked in
    (b, ty, tx) order by persistent blocks."""
    ph, pw = (hc - 2) // 2, (wc - 2) // 2
    w, t = WGMMA_WINDOWS, 2 * WGMMA_WINDOWS
    return {"pool": (batch, -(-ph // w), -(-pw // w)),
            "dgrad": (batch, -(-hc // t), -(-wc // t))}


def block1_tile_plan(batch: int, hp: int, wp: int) -> tuple:
    """bf16 K2's tiling of an input of (batch, hp, wp, 3): the (batch,
    tiles_y, tiles_x) grid of 8x8-pooled-pixel tiles that persistent blocks
    walk in (b, ty, tx) order; tile (ty, tx) reads input rows 16 ty .. 16 ty
    + 19 and columns 16 tx .. 16 tx + 19, computes the 18x18 c11 pixels from
    (16 ty, 16 tx) and stores pooled pixels (8 ty + i, 8 tx + j) inside
    ((hp - 4) / 2, (wp - 4) / 2): K3's pool plan on the c11 it computes."""
    return conv_tile_plan(batch, hp - 2, wp - 2)["pool"]


def tile_row_pixels() -> torch.Tensor:
    """(2, 2, 4, 2, 8, 2): the (y, x) within its 16x16 tile of the output
    pixel that the mainloop's accumulator row [wg][dy][warp][h][r] (row 16
    warp + 8 h + r of warpgroup wg's m64 tile dy) computes:
    (2 (4 wg + warp) + dy, 2 r + h)."""
    wg, dy, warp, h, r = torch.meshgrid(
        *(torch.arange(n) for n in (2, 2, 4, 2, 8)), indexing="ij")
    return torch.stack((2 * (4 * wg + warp) + dy, 2 * r + h), -1)


def wgrad_chunks(batch: int, hc: int, wc: int, dtype) -> int:
    """The dK2 chunk count of `block1_train_wgrad_chunks`, 0 for a shape
    the backward refuses: bf16 blocks take WGRAD_CHUNK_SEGS row segments of
    WGRAD_SEG pixels, fp32 blocks WGRAD_CHUNK_PIX pixels; either way a
    chunk has a fixed length and the count grows with the pixels."""
    ho, wo = hc - 2, wc - 2
    if (not 0 < batch <= 65535 or ho <= 0 or wo <= 0 or ho % 2 or wo % 2
            or batch * ho * wo * 64 >= 2 ** 31):
        return 0
    if dtype == torch.bfloat16:
        segs = batch * ho * -(-wo // WGRAD_SEG)
        return -(-segs // WGRAD_CHUNK_SEGS)
    return -(-(batch * ho * wo) // WGRAD_CHUNK_PIX)


def _train_weights(k2, dtype, flip=False) -> torch.Tensor:
    """k2 as the kernels take it: the packed wgmma image for bf16, HWIO
    fp32 values rounded to `dtype` otherwise."""
    k = k2.to(dtype)
    if dtype == torch.bfloat16:
        return pack_conv_weights(conv_b_matrices(k, flip))
    return conv_b_matrices(k.to(torch.float32), flip).contiguous()


def conv2_pool(c11, k2, b2) -> torch.Tensor:
    """K3 wrapper: launches `block1_train_forward` (CUDA tensors only);
    bf16 on the tensor cores (`conv2_pool_fwd_wgmma`), fp32 on the CUDA
    cores. c11 (B, Hc, Wc, 64) in bf16 or fp32, k2 OIHW, b2 (64,) ->
    (B, (Hc-2)/2, (Wc-2)/2, 64) in c11's dtype."""
    _check_train_args(c11, k2, b2)
    c11 = c11.contiguous()
    b, hc, wc, _ = c11.shape
    k2h = _train_weights(k2, c11.dtype)
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


# K4's steps, as `block1_train_backward` selects them
K4_ROUTE, K4_WGRAD, K4_DGRAD, K4_ALL = 1, 2, 4, 7


def k4_buffers(c11, k2, b2, g) -> dict:
    """K4's inputs as the kernels take them, its scratch and its outputs,
    for `k4_launch`."""
    _check_train_args(c11, k2, b2)
    dtype = c11.dtype
    c11 = c11.contiguous()
    b, hc, wc, _ = c11.shape
    ho, wo = hc - 2, wc - 2
    if tuple(g.shape) != (b, ho // 2, wo // 2, 64):
        raise ValueError(f"conv2_pool_backward: g {tuple(g.shape)} does not "
                         f"match c11 {tuple(c11.shape)}")
    dev = c11.device
    # the dK2 reduction's chunk count: the kernel fixes the chunk length
    n_chunks = _kernels.function("block1_train", "block1_train_wgrad_chunks",
                                 [_kernels.I] * 4)(
        b, hc, wc, _DTYPE_CODES[dtype])
    f32 = dict(dtype=torch.float32, device=dev)
    return {"c11": c11, "k2": _train_weights(k2, dtype),
            "kflip": _train_weights(k2, dtype, flip=True),
            "b2": b2.to(torch.float32).contiguous(),
            "g": g.to(dtype).contiguous(),
            "dz": torch.empty((b, ho, wo, 64), dtype=dtype, device=dev),
            "partial": torch.empty((n_chunks, 9, 64, 64), **f32),
            "dbp": torch.empty((n_chunks, 64), **f32),
            "dk": torch.empty((9, 64, 64), **f32),
            "db": torch.empty((64,), **f32),
            "dc11": torch.empty_like(c11), "n_chunks": n_chunks}


def k4_launch(bufs: dict, parts: int = K4_ALL) -> None:
    """Launches the K4 steps `parts` (K4_ROUTE: dz; K4_WGRAD: dK2, db2;
    K4_DGRAD: d(c11)) on `k4_buffers`' tensors."""
    c11 = bufs["c11"]
    b, hc, wc, _ = c11.shape
    fn = _kernels.function("block1_train", "block1_train_backward",
                           _BWD_ARGTYPES)
    p = _kernels.ptr
    rc = fn(*(p(bufs[k]) for k in ("c11", "k2", "kflip", "b2", "g", "dz",
                                   "partial", "dbp", "dk", "db", "dc11")),
            b, hc, wc, bufs["n_chunks"], _DTYPE_CODES[c11.dtype], parts,
            _kernels.P(_kernels.stream_handle(c11.device)))
    _kernels.check("block1_train", rc)


def conv2_pool_backward(c11, k2, b2, g):
    """K4 wrapper: launches `block1_train_backward` (CUDA tensors only):
    the route, dK2/db2 and d(c11) kernels, on the tensor cores for bf16.
    Returns (d c11 in c11's dtype, d k2 OIHW in k2's dtype, d b2 in b2's
    dtype); dK2 and db2 accumulate in fp32."""
    bufs = k4_buffers(c11, k2, b2, g)
    k4_launch(bufs)
    _kernels.launch_counts["block1_train_bwd"] += 1
    dk2 = bufs["dk"].view(3, 3, 64, 64).permute(2, 3, 0, 1).to(k2.dtype)
    return bufs["dc11"], dk2.contiguous(), bufs["db"].to(b2.dtype)


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


def _check_pairs_geometry(xp: torch.Tensor) -> None:
    if xp.dim() != 4 or xp.shape[-1] != 3:
        raise ValueError(f"conv1_1_pairs: xp must be (B, Hp, Wp, 3), got "
                         f"{tuple(xp.shape)}")
    hp, wp = xp.shape[1], xp.shape[2]
    if hp < 4 or wp < 4 or hp % 2 or wp % 2:
        raise ValueError(f"conv1_1_pairs: Hp and Wp must be even and at "
                         f"least 4, got {tuple(xp.shape)}")


def _pairs(c11: torch.Tensor) -> torch.Tensor:
    b, ho, wo, _ = c11.shape
    return c11.view(b, ho, wo // 2, 128)


def conv1_1_pairs_plain(xp, k1, b1, dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of K8 with the JAX kernel's rounding points: xp and k1
    rounded to `dtype`, the 27 products summed in fp32, + b1 in fp32, ReLU,
    one rounding to `dtype`; in the packed-pair shape. The taps are added
    in the order (kh, ci, kw), as fp32 K8 adds them; bf16 K8 sums on the
    tensor cores in their own order, so a bf16 result may sit one bf16 ulp
    away where the fp32 sums fall on two sides of a rounding boundary."""
    _check_pairs_geometry(xp)
    x = xp.to(dtype).to(torch.float32)
    w = k1.to(dtype).to(torch.float32)
    b, hp, wp, _ = x.shape
    ho, wo = hp - 2, wp - 2
    acc = torch.zeros((b, ho, wo, 64), dtype=torch.float32, device=x.device)
    for kh in range(3):
        for ci in range(3):
            for kw in range(3):
                acc = acc + (x[:, kh:kh + ho, kw:kw + wo, ci:ci + 1]
                             * w[:, ci, kh, kw])
    return _pairs(torch.relu(acc + b1.to(torch.float32)).to(dtype))


# bf16 K8's tiling, passed to the kernel, which refuses any other
C11_TILE_M = 128          # output pixels a tile
C11_STAGE_BYTES = C11_TILE_M * 64 * 2    # one staging buffer
C11_WGMMA_SMEM = 1024 + 2 * C11_STAGE_BYTES + 2 * 2048   # + packed B


def c11_tile_plan(batch: int, hp: int, wp: int) -> dict:
    """bf16 K8's tiling of an input of (batch, hp, wp, 3): `tiles` tiles of
    C11_TILE_M consecutive output pixels of the flattened (b, y, x) axis of
    M = batch (hp - 2) (wp - 2) pixels, the last clipped at M; tile t's
    pixels are C11_TILE_M t .. C11_TILE_M (t + 1) - 1. `smem` is the shared
    memory a block takes: two staging buffers on a 1024-byte aligned base
    and conv1_1's 4 KB packed B. `conv1_1_pairs` passes `tile_m` and
    `smem` to the kernel, which refuses a plan that is not its own."""
    m = batch * (hp - 2) * (wp - 2)
    return {"pixels": m, "tile_m": C11_TILE_M,
            "tiles": -(-m // C11_TILE_M), "smem": C11_WGMMA_SMEM}


def conv1_1_pairs(xp, k1, b1, dtype=torch.bfloat16) -> torch.Tensor:
    """conv1_1 (3 -> 64, 3x3 VALID) + b1 + ReLU in the JAX op's packed-pair
    shape (B, Hp-2, (Wp-2)/2, 128); `.view(B, Hp-2, Wp-2, 64)` gives the
    NHWC activation K3 reads. xp (B, Hp, Wp, 3), Hp and Wp even; k1 (64, 3,
    3, 3) OIHW; b1 (64,). K8 on a CUDA tensor (bf16 on `wgmma`,
    `conv1_1_wgmma`, tiled as `c11_tile_plan` says; fp32 on the CUDA
    cores), the plain version on a CPU tensor."""
    if not xp.is_cuda:
        return conv1_1_pairs_plain(xp, k1, b1, dtype)
    _check_pairs_geometry(xp)
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"conv1_1_pairs: dtype {dtype} not supported")
    dev = xp.device
    for t, shape in ((k1, (64, 3, 3, 3)), (b1, (64,))):
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"conv1_1_pairs: weight of shape "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{shape} on {dev}")
    x = xp.to(dtype).contiguous()
    b, hp, wp, _ = x.shape
    tile_m = smem = 0
    if dtype == torch.bfloat16:  # conv1_1's packed wgmma image, as K2's
        k1h = pack_conv_weights(conv1_1_b_matrix(k1.to(dtype))[None])
        plan = c11_tile_plan(b, hp, wp)
        tile_m, smem = plan["tile_m"], plan["smem"]
    else:
        k1h = k1.to(torch.float32).permute(2, 3, 1, 0).contiguous()  # HWIO
    b1f = b1.to(torch.float32).contiguous()
    out = torch.empty((b, hp - 2, wp - 2, 64), dtype=dtype, device=dev)
    if b == 0:
        return _pairs(out)
    fn = _kernels.function("conv1_1", "conv1_1_forward", _C11_ARGTYPES)
    p = _kernels.ptr
    rc = fn(p(x), p(k1h), p(b1f), p(out), b, hp, wp, _DTYPE_CODES[dtype],
            tile_m, smem, _kernels.P(_kernels.stream_handle(dev)))
    _kernels.check("conv1_1", rc)
    _kernels.launch_counts["conv1_1_pairs"] += 1
    return _pairs(out)
