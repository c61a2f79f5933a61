"""A matrix product with fp32 accumulation, the port of the JAX package's
Pallas matmul (`ops/pdot.py`, K7).

`pdot(a, b)` is (M, K) @ (K, N) -> (M, N); with `trans_a=True`, `a` is
(K, M) and the result is a^T @ b without a materialised transpose (the
shape of a 1x1 convolution's weight gradient). Inputs are both bf16 or both
fp32; `out_dtype` (fp32 or bf16) defaults to the input type. Every output
element sums in fp32 and is rounded once at the end, which covers both
Pallas bodies (`_kernel_accum_out` for fp32 out, `_kernel_scratch` for
other types).

* On a CUDA tensor `pdot` launches `csrc/pdot.cu` or raises. The kernel
  takes row-major contiguous 2-D operands; the wrapper checks that and
  copies nothing. fp32 inputs multiply in full fp32 (never TF32, as the
  JAX package's `highest=True` asks); bf16 products are exact in fp32, so
  `highest` is accepted and changes nothing on this card.
* `pdot_plan` is the rule that picks the kernel's variant, by the
  operands' shapes and 16-byte alignment, and its K splits:
  - fp32 inputs: `fp32` (CUDA cores; when the output has fewer 64x64 tiles
    than the card has SMs, K splits into chunks of a multiple of 16 so that
    about twice as many blocks as SMs run, each chunk at least 64 deep);
  - bf16, `trans_a`, N <= 24, M % 8 == 0: `narrow` (wgmma n8 / n16 /
    n24, K in fixed 512-deep chunks);
  - bf16 with a's and b's rows 16-byte aligned (K % 8 == 0, or M % 8 == 0
    under `trans_a`; N % 8 == 0), 16-byte-aligned bases and M, N >= 64:
    `tma` (TMA ring + wgmma, 128 x 256 tiles, no split);
  - any other bf16 product: `wmma` (K splits into <= 512-deep chunks when
    the output has fewer 128x128 tiles than SMs and K > 512).
  Each variant has its own launch count (`pdot_<variant>`) beside the
  total `pdot`.
* On a CPU tensor it runs `pdot_plain`, the plain version: the fp32
  product of the inputs (bf16 inputs widened exactly), rounded once.
"""

from __future__ import annotations

import torch

from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {"fp32": 0, "wmma": 1, "tma": 2, "narrow": 3}
_ARGTYPES = [_kernels.P] * 4 + [_kernels.I] * 9 + [_kernels.P]

NARROW_MAX_N = 24      # the narrow variant's widest wgmma tile
NARROW_K_CHUNK = 512   # its fixed K chunk
TMA_MIN_MN = 64        # the tma variant's smallest M and N
WMMA_TILE, WMMA_SPLIT_K = 128, 512
F32_TILE, F32_MIN_CHUNK = 64, 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pdot_plan(m: int, k: int, n: int, *, trans_a: bool, dtype, sms: int,
              aligned: bool = True) -> dict:
    """K7's variant for an (M, K) @ (K, N) product of input `dtype` on a
    card of `sms` SMs, with `aligned` the operands' bases 16-byte aligned:
    {"variant", "splits", "k_chunk"}, K split into `splits` chunks of
    `k_chunk` (the last one shorter). The rule is the module note's."""
    if dtype == torch.float32:
        tiles = _cdiv(m, F32_TILE) * _cdiv(n, F32_TILE)
        splits = 1 if tiles >= sms else max(1, min(
            _cdiv(2 * sms, tiles), _cdiv(k, F32_MIN_CHUNK)))
        chunk = _cdiv(_cdiv(k, splits), 16) * 16
        return {"variant": "fp32", "splits": _cdiv(k, chunk),
                "k_chunk": chunk}
    rows_ok = aligned and (m if trans_a else k) % 8 == 0
    if trans_a and n <= NARROW_MAX_N and rows_ok:
        return {"variant": "narrow", "splits": _cdiv(k, NARROW_K_CHUNK),
                "k_chunk": NARROW_K_CHUNK}
    if rows_ok and n % 8 == 0 and min(m, n) >= TMA_MIN_MN:
        return {"variant": "tma", "splits": 1, "k_chunk": k}
    tiles = _cdiv(m, WMMA_TILE) * _cdiv(n, WMMA_TILE)
    splits = 1 if tiles >= sms or k <= WMMA_SPLIT_K else _cdiv(
        k, WMMA_SPLIT_K)
    chunk = _cdiv(_cdiv(k, splits), 32) * 32
    return {"variant": "wmma", "splits": _cdiv(k, chunk), "k_chunk": chunk}


_SMS: dict[int, int] = {}


def _sms(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def plan_for(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False
             ) -> dict:
    """`pdot_plan` for these CUDA operands."""
    m, k, n, _ = _shapes(a, b, None, trans_a)
    return pdot_plan(m, k, n, trans_a=trans_a, dtype=a.dtype,
                     sms=_sms(a.device),
                     aligned=a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)


def _shapes(a: torch.Tensor, b: torch.Tensor, out_dtype, trans_a: bool):
    """(M, K, N, out dtype), or ValueError for operands K7 does not take."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"pdot shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = (a.shape[1], a.shape[0]) if trans_a else a.shape
    if k != b.shape[0]:
        raise ValueError(f"pdot shapes {tuple(a.shape)} @ {tuple(b.shape)} "
                         f"(trans_a={trans_a})")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise ValueError(f"pdot: inputs must be both float32 or both "
                         f"bfloat16, got {a.dtype} and {b.dtype}")
    out_dtype = a.dtype if out_dtype is None else out_dtype
    if out_dtype not in _DTYPES:
        raise ValueError(f"pdot: out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    return m, k, b.shape[1], out_dtype


def pdot_plain(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
               trans_a: bool = False) -> torch.Tensor:
    """Plain version of K7: the fp32 product, rounded once to
    `out_dtype`."""
    _, _, _, out_dtype = _shapes(a, b, out_dtype, trans_a)
    a32 = a.to(torch.float32)
    return torch.matmul(a32.t() if trans_a else a32,
                        b.to(torch.float32)).to(out_dtype)


def pdot(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
         trans_a: bool = False, highest: bool = False) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) with fp32 accumulation; K7 on CUDA
    tensors, `pdot_plain` on CPU tensors. `highest` is the JAX signature's
    full-fp32 request, which K7 always meets."""
    del highest
    m, k, n, out_dtype = _shapes(a, b, out_dtype, trans_a)
    if not a.is_cuda:
        return pdot_plain(a, b, out_dtype=out_dtype, trans_a=trans_a)
    if b.device != a.device:
        raise ValueError(f"pdot: operands on {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("pdot: K7 takes row-major contiguous operands; got "
                         f"strides {a.stride()} and {b.stride()}")
    dev = a.device
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    plan = plan_for(a, b, trans_a=trans_a)
    splits = plan["splits"]
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    fn = _kernels.function("pdot", "pdot_launch", _ARGTYPES)
    p = _kernels.ptr
    rc = fn(p(a), p(b), p(out), _kernels.P(0 if ws is None else ws.data_ptr()),
            m, n, k, int(trans_a), _DTYPES[a.dtype], _DTYPES[out_dtype],
            VARIANTS[plan["variant"]], splits, plan["k_chunk"],
            _kernels.P(_kernels.stream_handle(dev)))
    _kernels.check("pdot", rc)
    _kernels.launch_counts["pdot"] += 1
    _kernels.launch_counts["pdot_" + plan["variant"]] += 1
    return out
