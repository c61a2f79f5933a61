"""The ring pads of the support-pruned blocks (`models/pruned.py` `_padc`):
a tensor padded on its spatial dims with a per-channel constant, in
channels_last memory.

* `ring_pad_plain`: two concatenations of constant bands (the JAX
  package's `_padc`), then the channels_last copy; differentiable by
  autograd. It is the CPU's route and the kernel's reference.
* `ring_pad`: `csrc/ring_pad.cu` (bf16 or fp32 on the card, else
  ValueError): one pass that reads the input once and writes the output
  once, 16-byte vectors where the channels and strides allow. An input
  whose channels are not innermost with its pixels dense (not
  channels_last, such as a halo concatenation's NCHW result) is made
  channels_last first; a column slice of an NHWC tensor is read in place.
* `ring_sum`: the gradient's per-channel sum over the ring (the positions
  not copied from the input), in fp32 and cast once: `csrc/ring_pad.cu`'s
  second kernel; `ring_sum_plain` sums the four bands.
* `RingPad`: `ring_pad` differentiable to both inputs, the route of every
  CUDA tensor (`kernel_takes`): the input's gradient is a view of the
  incoming gradient's interior (no copy), the constant's is `ring_sum`.
"""

from __future__ import annotations

import torch

from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAD_ARGTYPES = ([_kernels.P] * 3 + [_kernels.I] * 8 + [_kernels.LL] * 2
                 + [_kernels.I] * 2 + [_kernels.P])
_SUM_ARGTYPES = ([_kernels.P] * 3 + [_kernels.I] * 8 + [_kernels.LL] * 4
                 + [_kernels.I] * 2 + [_kernels.P])
_SUM_PIXELS = 64      # ring pixels a ring_sum block sums, at the least
_SUM_SPLITS = 256     # its blocks along the ring, at the most
_fns: dict = {}       # the library's entry points, by name


def kernel_takes(a: torch.Tensor) -> bool:
    """Whether the pad of `a` runs on the kernel (`RingPad`): a CUDA tensor
    (the kernel refuses a dtype other than bf16 and fp32)."""
    return a.is_cuda


def _fn(name: str, argtypes):
    """The library's entry point `name`, looked up once (the pads launch
    ten times a forward)."""
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = _kernels.function("ring_pad", name, argtypes)
    return fn


def _check(a: torch.Tensor, c: torch.Tensor, pads) -> None:
    if a.dim() != 4 or c.shape != (a.shape[1],) or min(pads) < 0:
        raise ValueError(f"ring pad: a {tuple(a.shape)}, c {tuple(c.shape)}"
                         f" and pads {pads} do not match")


def ring_pad_plain(a: torch.Tensor, c: torch.Tensor, top: int, bottom: int,
                   left: int, right: int) -> torch.Tensor:
    """Plain version: NCHW `a` (B, C, h, w) padded with the per-channel
    constant c (C,) by concatenating constant bands (pad(a - c) + c would
    perturb interior values), -> (B, C, h + top + bottom, w + left + right)
    in channels_last memory."""
    _check(a, c, (top, bottom, left, right))
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
    return a.contiguous(memory_format=torch.channels_last)


def _nhwc(a: torch.Tensor) -> torch.Tensor:
    """`a` itself where its channels are innermost and its pixels dense
    (what the kernel reads, batch and row strides free), else its
    channels_last copy."""
    _, ch, _, w = a.shape
    if (ch == 1 or a.stride(1) == 1) and (w == 1 or a.stride(3) == ch):
        return a
    return a.contiguous(memory_format=torch.channels_last)


def ring_pad(a: torch.Tensor, c: torch.Tensor, top: int, bottom: int,
             left: int, right: int) -> torch.Tensor:
    """`ring_pad_plain`'s result by `csrc/ring_pad.cu`: `a` on the card in
    bf16 or fp32 and c on its device, else ValueError."""
    _check(a, c, (top, bottom, left, right))
    if not a.is_cuda or a.dtype not in _DTYPES or c.device != a.device:
        raise ValueError(f"ring_pad takes bf16 or fp32 on one card; got "
                         f"{a.dtype} on {a.device}, c on {c.device}")
    a = _nhwc(a)
    c = c.to(a.dtype).contiguous()
    b, ch, h, w = a.shape
    out = torch.empty((b, ch, h + top + bottom, w + left + right),
                      dtype=a.dtype, device=a.device,
                      memory_format=torch.channels_last)
    sb = a.stride(0) if b > 1 else 0
    sh = a.stride(2) if h > 1 else 0
    per = 16 // a.element_size()
    pa, pc, po = a.data_ptr(), c.data_ptr(), out.data_ptr()
    vec = int(ch % per == 0 and sb % per == 0 and sh % per == 0
              and (pa | pc | po) % 16 == 0)
    rc = _fn("ring_pad_launch", _PAD_ARGTYPES)(
        pa, pc, po, b, h, w, ch, top, bottom, left, right, sb, sh,
        a.element_size(), vec, _kernels.stream_handle(a.device))
    _kernels.check("ring_pad", rc)
    _kernels.launch_counts["ring_pad"] += 1
    return out


def ring_sum_plain(g: torch.Tensor, top: int, bottom: int, left: int,
                   right: int) -> torch.Tensor:
    """Plain version of `ring_sum`: the fp32 sums of the ring's four
    disjoint bands (the top and bottom rows whole, the left and right
    columns of the rows between), added."""
    oh, ow = g.shape[2:]
    mid = g[:, :, top:oh - bottom]
    s = torch.zeros(g.shape[1], dtype=torch.float32, device=g.device)
    for band in (g[:, :, :top], g[:, :, oh - bottom:], mid[..., :left],
                 mid[..., ow - right:]):
        s = s + band.to(torch.float32).sum(dim=(0, 2, 3))
    return s.to(g.dtype)


def ring_sum(g: torch.Tensor, top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    """(C,) in g's dtype: the sum of g (B, C, OH, OW), any strides, over
    every position outside rows [top, OH - bottom) and columns [left,
    OW - right), per channel, in fp32 and rounded once, by the second
    kernel of `csrc/ring_pad.cu`: g on the card in bf16 or fp32, else
    ValueError."""
    if not g.is_cuda or g.dim() != 4 or g.dtype not in _DTYPES:
        raise ValueError(f"ring_sum takes a bf16 or fp32 (B, C, OH, OW) "
                         f"gradient on the card; got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    b, ch, oh, ow = g.shape
    h, w = oh - top - bottom, ow - left - right
    if min(top, bottom, left, right) < 0 or h < 1 or w < 1:
        raise ValueError(f"ring_sum: pads {(top, bottom, left, right)} do "
                         f"not fit {tuple(g.shape)}")
    ring = b * (oh * ow - h * w)
    splits = max(1, min(_SUM_SPLITS, -(-ring // _SUM_PIXELS)))
    part = torch.empty((splits, ch), dtype=torch.float32, device=g.device)
    out = torch.empty(ch, dtype=g.dtype, device=g.device)
    rc = _fn("ring_sum_launch", _SUM_ARGTYPES)(
        g.data_ptr(), part.data_ptr(), out.data_ptr(), b, ch, oh, ow, top,
        bottom, left, right, *g.stride(), _DTYPES[g.dtype], splits,
        _kernels.stream_handle(g.device))
    _kernels.check("ring_pad", rc)
    _kernels.launch_counts["ring_sum"] += 1
    return out


class RingPad(torch.autograd.Function):
    """`ring_pad` with its gradients: to `a` the interior of the incoming
    gradient, as a view; to `c` its `ring_sum`."""

    @staticmethod
    def forward(ctx, a, c, top, bottom, left, right):
        ctx.pads = (top, bottom, left, right)
        ctx.c_dtype = c.dtype
        return ring_pad(a, c, top, bottom, left, right)

    @staticmethod
    def backward(ctx, g):
        top, bottom, left, right = ctx.pads
        ga = gc = None
        if ctx.needs_input_grad[0]:
            ga = g[:, :, top:g.shape[2] - bottom, left:g.shape[3] - right]
        if ctx.needs_input_grad[1]:
            gc = ring_sum(g, top, bottom, left, right).to(ctx.c_dtype)
        return ga, gc, None, None, None, None
