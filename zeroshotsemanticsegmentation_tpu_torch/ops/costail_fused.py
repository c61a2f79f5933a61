"""Fused stage-1 tail: masked cosine loss + NNE confusion histogram + score
sum in one pass over the full-resolution score, with a recompute backward.

`fused_cos_tail` is the train step's entry point (the JAX package's
ops/costail_fused.fused_cos_tail):

* on a CPU tensor it runs `cos_tail_plain`, the plain PyTorch version:
  per-sample `ops.losses.cosine_loss`, `ops.metrics.confusion_matrix` of
  `ops.nne.infer_labels`, and the sum, differentiated by autograd;
* on a CUDA tensor it runs `CosTail`, whose forward launches K5
  (`cos_tail_forward`, csrc/costail_fused.cu) and whose backward launches
  K6 (`cos_tail_backward`).

The kernels stream the score through a ring of shared-memory tiles filled
by bulk copies; their launch (tile, stages, grid, shared memory) comes from
`costail_plan`, computed once per device and shape, whose arithmetic the
CPU tests check (tests/test_torch_costail_plan.py).

The kernels take the embedding rows already normalised (`l2_normalize`);
selecting a normalised row equals normalising the selected target. Only
`score` is differentiable: losses and score sum carry gradients, the
histogram does not, the embeddings are constants.

On a mesh (`parallel.mesh`) each rank calls it on its own rows, as the JAX
package's shard_map runs the kernels per data shard: the plan is that of
the local batch, the per-sample losses stay local, and the train step sums
the histogram and the score sum over the data group.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
from zeroshotsemanticsegmentation_tpu_torch.ops.losses import (
    cosine_loss, embed_targets, l2_normalize)
from zeroshotsemanticsegmentation_tpu_torch.ops.metrics import (
    confusion_matrix)
from zeroshotsemanticsegmentation_tpu_torch.ops.nne import infer_labels

_FWD_ARGTYPES = [_kernels.P] * 9 + [_kernels.I] * 10 + [_kernels.P]
_BWD_ARGTYPES = [_kernels.P] * 7 + [_kernels.I] * 9 + [_kernels.P]

# The launch plan (mirrors csrc/costail_fused.cu: its `layout`, `check_plan`
# and the tiles a block runs). C in REG_WIDTHS takes the register form (a
# template instance per width), any other C the wide form.
REG_WIDTHS = (2, 5, 10, 20, 21)
REG_THREADS, REG_TILE = 128, 256
WIDE_LANES, WIDE_PX, WIDE_MAX_TILE = 8, 2, 64
HEADER = 128        # stage barriers and reduction scratch
MIN_STAGES, MAX_STAGES = 3, 4
# every kernel's launch bounds hold it to 128 registers a thread, so the
# 65536 registers of an SM take 512 of its threads
SM_THREADS = 512


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def vec_width(c: int) -> int:
    """The widest vector (4, 2 or 1 floats) that divides C."""
    return 4 if c % 4 == 0 else (2 if c % 2 == 0 else 1)


def lane_classes(k: int) -> int:
    """The wide forward's classes per lane in a window of 8 lanes."""
    return 3 if k <= 24 else (5 if k <= 40 else 8)


def plan_smem(forward: bool, wide: bool, tile: int, stages: int, c: int,
              k: int, n: int) -> int:
    """Dynamic shared memory of one block: header, tables (forward: both;
    in the wide form the infer table's K padded to whole windows and its
    rows to an odd count of vectors; backward: the target table in the
    register form), the (n, n) histogram (forward), `stages` stages of
    tile * C scores and tile labels."""
    if forward and wide:
        window = WIDE_LANES * lane_classes(k)
        kp = -(-k // window) * window
        v = vec_width(c)
        floats = kp * ((c // v) | 1) * v + k * c
    elif forward:
        floats = 2 * k * c
    else:
        floats = 0 if wide else k * c
    hist = _round16(n * n * 4) if forward else 0
    return HEADER + _round16(floats * 4) + hist + stages * tile * (c + 1) * 4


def costail_plan(batch: int, hw: int, c: int, k: int, n: int, *,
                 forward: bool, sms: int, smem_block: int, smem_sm: int,
                 smem_reserved: int) -> dict:
    """K5's (`forward`) or K6's launch on a card with `sms` SMs and the given
    shared memory limits (per-block opt-in, per SM, reserved per block):
    form, tile (pixels), stages, threads, blocks per SM, grid, shared
    memory, tiles, pixels. The grid is the blocks that fit at once, so
    every block runs one contiguous run of tiles (`block_tiles`).

    The register form runs 256-pixel tiles. The wide form's tile is a
    multiple of 8 up to 64 (8 lanes a pixel pair) with 3 stages fitting
    beside the tables: the forward's (argmax-bound) the one with the most
    threads resident on an SM, then the largest; the backward's
    (byte-bound, reading the target table through L1) the largest that
    keeps two blocks an SM with the table's bytes left to L1, down to 16
    pixels. Then 4 stages where that costs no block an SM."""
    wide = c not in REG_WIDTHS

    def smem(tile, stages):
        return plan_smem(forward, wide, tile, stages, c, k, n)

    def threads(tile):
        return tile // WIDE_PX * WIDE_LANES if wide else REG_THREADS

    def per_sm(tile, stages):
        return min(SM_THREADS // threads(tile),
                   smem_sm // (smem(tile, stages) + smem_reserved))

    def l1_room(tile, stages):
        """The wide backward's target table fits in what shared memory
        leaves to L1."""
        if forward or not wide:
            return True
        return (per_sm(tile, stages) * (smem(tile, stages) + smem_reserved)
                + k * c * 4 <= smem_sm)

    tiles = range(WIDE_MAX_TILE, 0, -8) if wide else [REG_TILE]
    fits = [t for t in tiles if smem(t, MIN_STAGES) <= smem_block]
    if not fits:
        raise ValueError(f"cos_tail: C={c}, K={k}, n={n} leave no room for "
                         f"{MIN_STAGES} stages in {smem_block} B of shared "
                         f"memory")
    if not wide:
        tile = fits[0]
    elif forward:
        tile = max(fits, key=lambda t: (per_sm(t, MIN_STAGES) * threads(t),
                                        t))
    else:
        two = [t for t in fits if t >= 16 and per_sm(t, MIN_STAGES) >= 2
               and l1_room(t, MIN_STAGES)]
        tile = max(two or fits)
    stages = MAX_STAGES if (smem(tile, MAX_STAGES) <= smem_block
                            and per_sm(tile, MAX_STAGES)
                            >= per_sm(tile, MIN_STAGES)
                            and (l1_room(tile, MAX_STAGES)
                                 or not l1_room(tile, MIN_STAGES))) \
        else MIN_STAGES
    pixels = batch * hw
    ntiles = -(-pixels // tile)
    blocks = max(1, per_sm(tile, stages))
    return {"form": "wide" if wide else "regs", "tile": tile,
            "stages": stages, "threads": threads(tile),
            "blocks_per_sm": blocks, "grid": min(ntiles, sms * blocks),
            "smem": smem(tile, stages), "tiles": ntiles, "pixels": pixels}


def block_tiles(plan: dict, g: int) -> range:
    """The tiles block g runs, in order (csrc `block_run`)."""
    t, grid = plan["tiles"], plan["grid"]
    return range(t * g // grid, t * (g + 1) // grid)


def tile_copies(plan: dict, t: int, c: int) -> dict:
    """Tile t's copies (csrc `fetch_tile`): its first pixel and pixel count,
    the byte offsets (from the score's and the labels' bases) and sizes of
    its two bulk copies, and the floats and labels that plain loads take at
    the tensor's ragged end."""
    p0 = t * plan["tile"]
    np_ = min(plan["tile"], plan["pixels"] - p0)
    sbulk, lbulk = (np_ * c * 4) // 16 * 16, (np_ * 4) // 16 * 16
    return {"p0": p0, "np": np_, "score_offset": p0 * c * 4,
            "score_bulk": sbulk, "score_tail": np_ * c - sbulk // 4,
            "label_offset": p0 * 4, "label_bulk": lbulk,
            "label_tail": np_ - lbulk // 4}


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> dict:
    out = (ctypes.c_int * 4)()
    rc = _kernels.function("costail_fused", "costail_device",
                           [_kernels.I, _kernels.P])(
        index, ctypes.cast(out, ctypes.c_void_p))
    _kernels.check("costail_fused", rc)
    return {"sms": out[0], "smem_block": out[1], "smem_sm": out[2],
            "smem_reserved": out[3]}


@functools.lru_cache(maxsize=256)
def _plan_for(index: int, forward: bool, batch: int, hw: int, c: int,
              k: int, n: int) -> dict:
    """The plan on CUDA device `index`, computed once per shape."""
    return costail_plan(batch, hw, c, k, n, forward=forward,
                        **_device_limits(index))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous at a 16-byte aligned address (bulk copies and vector
    loads need it; a fresh allocation is)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def cos_tail_plain(score, label, target_embeddings, infer_embeddings,
                   num_classes: int):
    """Plain version of K5 (its autograd is the plain version of K6):
    (per-sample cosine losses (B,), hist (n, n) int32, score sum)."""
    temb = target_embeddings.to(score.device)
    losses = torch.stack([
        cosine_loss(score[i:i + 1], label[i:i + 1],
                    embed_targets(label[i:i + 1], temb))
        for i in range(score.shape[0])])
    pred = infer_labels(score.detach(), infer_embeddings.to(score.device))
    hist = confusion_matrix(label, pred, num_classes)
    return losses, hist, torch.sum(score.to(torch.float32))


def cos_tail_plain_backward(score, label, target_embeddings,
                            infer_embeddings, num_classes: int, g_losses,
                            g_ssum):
    """Plain version of K6: d score of `cos_tail_plain` by autograd."""
    with torch.enable_grad():
        s = score.detach().requires_grad_()
        losses, _, ssum = cos_tail_plain(s, label, target_embeddings,
                                         infer_embeddings, num_classes)
        return torch.autograd.grad((losses, ssum), s, (g_losses, g_ssum))[0]


def _check(score, label, temb_n) -> None:
    if not score.is_cuda:
        raise ValueError(f"cos_tail launches a CUDA kernel; score is on "
                         f"{score.device}")
    if score.dim() != 4 or score.dtype != torch.float32:
        raise ValueError(f"cos_tail: score must be float32 (B, H, W, C), "
                         f"got {score.dtype} {tuple(score.shape)}")
    b, h, w, c = score.shape
    if tuple(label.shape) != (b, h, w) or label.device != score.device:
        raise ValueError(f"cos_tail: label {tuple(label.shape)} on "
                         f"{label.device} does not match score "
                         f"{tuple(score.shape)}")
    if temb_n.dim() != 2 or temb_n.shape[1] != c:
        raise ValueError(f"cos_tail: tables {tuple(temb_n.shape)} do not "
                         f"match the score width C={c}")


def cos_tail_forward(score, label, temb_n, iemb_n, num_classes: int):
    """K5 wrapper (CUDA tensors only): (losses (B,), hist (n, n) int32,
    score sum (), valid counts (B,) fp32)."""
    _check(score, label, temb_n)
    b, h, w, c = score.shape
    k, n, hw = temb_n.shape[0], num_classes, h * w
    dev = score.device
    f32 = dict(dtype=torch.float32, device=dev)
    losses = torch.empty((b,), **f32)
    nv = torch.empty((b,), **f32)
    ssum = torch.empty((), **f32)
    hist = torch.empty((n, n), dtype=torch.int32, device=dev)
    if score.numel() == 0:
        return losses.zero_(), hist.zero_(), ssum.zero_(), nv.zero_()
    score, label, temb_n, iemb_n = (
        _aligned(score), _aligned(label.to(torch.int32)),
        _aligned(temb_n.to(dev, torch.float32)),
        _aligned(iemb_n.to(dev, torch.float32)))
    plan = _plan_for(dev.index, True, b, hw, c, k, n)
    # cos and valid-count partials (B, grid), score-sum partials (grid)
    ws = torch.empty((2 * b + 1) * plan["grid"], dtype=torch.int32,
                     device=dev)
    fn = _kernels.function("costail_fused", "costail_forward", _FWD_ARGTYPES)
    p = _kernels.ptr
    rc = fn(p(score), p(label), p(temb_n), p(iemb_n), p(losses), p(nv),
            p(ssum), p(hist), p(ws), b, hw, c, k, n,
            int(plan["form"] == "wide"), plan["tile"], plan["stages"],
            plan["grid"], plan["smem"],
            _kernels.P(_kernels.stream_handle(dev)))
    _kernels.check("costail_fused", rc)
    _kernels.launch_counts["costail_fwd"] += 1
    return losses, hist, ssum, nv


def cos_tail_backward(score, label, temb_n, g_losses, nv, g_ssum):
    """K6 wrapper (CUDA tensors only): d score (B, H, W, C) fp32."""
    _check(score, label, temb_n)
    b, h, w, c = score.shape
    k = temb_n.shape[0]
    dev = score.device
    score = _aligned(score)
    ds = torch.empty_like(score)
    if score.numel() == 0:
        return ds
    label = _aligned(label.to(torch.int32))
    temb_n = _aligned(temb_n.to(dev, torch.float32))
    g_losses = g_losses.to(dev, torch.float32).reshape(b).contiguous()
    nv = nv.to(dev, torch.float32).reshape(b).contiguous()
    g_ssum = g_ssum.to(dev, torch.float32).reshape(1).contiguous()
    plan = _plan_for(dev.index, False, b, h * w, c, k, 1)
    fn = _kernels.function("costail_fused", "costail_backward",
                           _BWD_ARGTYPES)
    p = _kernels.ptr
    rc = fn(p(score), p(label), p(temb_n), p(g_losses), p(nv), p(g_ssum),
            p(ds), b, h * w, c, k, int(plan["form"] == "wide"),
            plan["tile"], plan["stages"], plan["grid"], plan["smem"],
            _kernels.P(_kernels.stream_handle(dev)))
    _kernels.check("costail_fused", rc)
    _kernels.launch_counts["costail_bwd"] += 1
    return ds


class CosTail(torch.autograd.Function):
    """K5 forward, K6 backward (the JAX package's `_cos_tail` custom_vjp).
    Inputs: score, label, normalised target and infer tables, n."""

    @staticmethod
    def forward(ctx, score, label, temb_n, iemb_n, num_classes):
        losses, hist, ssum, nv = cos_tail_forward(score, label, temb_n,
                                                  iemb_n, num_classes)
        ctx.save_for_backward(score, label, temb_n, nv)
        ctx.mark_non_differentiable(hist)
        return losses, hist, ssum

    @staticmethod
    def backward(ctx, g_losses, _g_hist, g_ssum):
        score, label, temb_n, nv = ctx.saved_tensors
        ds = cos_tail_backward(score, label, temb_n, g_losses, nv, g_ssum)
        return ds, None, None, None, None


def fused_cos_tail(score, label, target_embeddings, infer_embeddings,
                   num_classes: int):
    """(per-sample cosine losses (B,), confusion hist (n, n) int32, score
    sum ()) from an NHWC fp32 score, differentiable in `score`:

      losses[b] == cosine_loss(score[b], label[b], E_target[label[b]])
      hist      == confusion_matrix(label, infer_labels(score, E_infer), n)
      score sum == score.sum()

    `target_embeddings` and `infer_embeddings`: (n, C) arrays or tensors.
    The kernels on a CUDA tensor, the plain version on a CPU tensor."""
    dev = score.device
    temb = torch.as_tensor(target_embeddings, dtype=torch.float32,
                           device=dev)
    iemb = torch.as_tensor(infer_embeddings, dtype=torch.float32, device=dev)
    if num_classes != temb.shape[0] or num_classes != iemb.shape[0]:
        raise ValueError(f"num_classes {num_classes} != embedding rows "
                         f"{temb.shape[0]}/{iemb.shape[0]}")
    if num_classes > 127:
        raise ValueError("int8 label feed caps classes at 127")
    if not score.is_cuda:
        return cos_tail_plain(score, label, temb, iemb, num_classes)
    return CosTail.apply(score, label, l2_normalize(temb),
                         l2_normalize(iemb), num_classes)
