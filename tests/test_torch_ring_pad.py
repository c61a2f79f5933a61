"""The ring pads (`ops/ring_pad.py`, `models/pruned.py` `_padc`) on the CPU:
channels_last out, values and gradients equal to the two concatenations
the pads were before, the plain gradient pieces of the kernel's route, and
the pruned FCN-32s and FCN-8s against the plain pad-100 stack."""

import numpy as np
import pytest
import torch

from zeroshotsemanticsegmentation_tpu_torch.models import FCN8s, FCN32s
from zeroshotsemanticsegmentation_tpu_torch.models import pruned
from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
from zeroshotsemanticsegmentation_tpu_torch.ops import ring_pad as rp
from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import (
    clear_spans, force_tracing, spans)

# (top, bottom, left, right): the ring pad, its forms at a band's edges,
# and the alignment pads of `run_pruned_blocks`
PADS = [(2, 2, 2, 2), (2, 0, 2, 2), (0, 2, 2, 2), (0, 0, 2, 2),
        (1, 0, 1, 0), (0, 1, 0, 1), (0, 0, 0, 1), (0, 1, 0, 0)]
EVERYTHING = (0, 2 ** 63 - 1)


def _concat(a, c, top, bottom, left, right):
    """The pads as they were: two concatenations of constant bands."""
    b, ch, h, w = a.shape
    c = c.to(a.dtype)[None, :, None, None]

    def band(hh, ww):
        return c.expand(b, ch, hh, ww)

    if left or right:
        a = torch.cat(([band(h, left)] if left else []) + [a]
                      + ([band(h, right)] if right else []), dim=3)
        w += left + right
    if top or bottom:
        a = torch.cat(([band(top, w)] if top else []) + [a]
                      + ([band(bottom, w)] if bottom else []), dim=2)
    return a


def _inputs(dtype, channels_last, shape=(2, 8, 7, 9), seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(*shape, generator=g).to(dtype)
    if channels_last:
        a = a.contiguous(memory_format=torch.channels_last)
    c = torch.randn(shape[1], generator=g).to(dtype)
    return a, c


def _grads(fn, a, c, pads, seed=1):
    a = a.detach().clone().requires_grad_(True)
    c = c.detach().clone().requires_grad_(True)
    out = fn(a, c, *pads)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed))
    (out.float() * w).sum().backward()
    return out.detach(), a.grad, c.grad


@pytest.mark.parametrize("pads", PADS, ids=lambda p: "_".join(map(str, p)))
@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
def test_padc_is_channels_last_and_equals_the_concatenation(pads,
                                                            channels_last):
    """fp32: values, the gradient to `a` and to `c` bit-equal to the two
    concatenations'; the output channels_last whatever the input's
    layout."""
    a, c = _inputs(torch.float32, channels_last)
    got, ga, gc = _grads(pruned._padc, a, c, pads)
    want, wa, wc = _grads(_concat, a, c, pads)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert got.shape == (2, 8, 7 + pads[0] + pads[1], 9 + pads[2] + pads[3])
    assert torch.equal(got, want)
    assert torch.equal(ga, wa) and torch.equal(gc, wc)


@pytest.mark.parametrize("pads", PADS, ids=lambda p: "_".join(map(str, p)))
def test_padc_bf16_values_equal_the_concatenation(pads):
    a, c = _inputs(torch.bfloat16, True, (3, 16, 5, 6))
    with torch.no_grad():
        got = pruned._padc(a, c.float(), *pads)
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, _concat(a, c, *pads))


def test_padc_span_says_the_plain_version_ran():
    """On the CPU the kernel does not take the input: the span's `kernel`
    work is 0, its `bytes` the output's, and nothing is launched."""
    a, c = _inputs(torch.bfloat16, True)
    before = dict(_kernels.launch_counts)
    clear_spans()
    with force_tracing():
        out = pruned._padc(a, c, 2, 2, 2, 2)
    recs = [r for r in spans(*EVERYTHING) if r.name == "model.ringpad"]
    assert not rp.kernel_takes(a)
    assert [r.work for r in recs] == [{"bytes": out.numel() * 2,
                                       "kernel": 0}]
    assert _kernels.launch_counts == before


@pytest.mark.parametrize("pads", PADS, ids=lambda p: "_".join(map(str, p)))
def test_ring_sum_plain_is_the_sum_over_the_ring(pads):
    """The four bands cover the ring once: their fp32 sum equals the fp64
    masked sum (to fp32's rounding), for a gradient in either layout."""
    top, bottom, left, right = pads
    g = torch.randn(3, 5, 9, 11, generator=torch.Generator().manual_seed(3))
    mask = torch.ones(9, 11, dtype=torch.bool)
    mask[top:9 - bottom, left:11 - right] = False
    want = (g.double() * mask).sum(dim=(0, 2, 3))
    for gg in (g, g.contiguous(memory_format=torch.channels_last)):
        got = rp.ring_sum_plain(gg, *pads)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("pads", PADS, ids=lambda p: "_".join(map(str, p)))
def test_the_kernels_autograd_function_matches_the_concatenation(
        pads, monkeypatch):
    """`RingPad`'s gradient rule, its two kernels replaced by their plain
    versions (the kernels run on the card alone): values and the gradient
    to `a` bit-equal, that to `c` to fp32's rounding (another order of the
    bands' sums); the gradient to `a` a view of the incoming gradient."""
    monkeypatch.setattr(rp, "ring_pad", rp.ring_pad_plain)
    monkeypatch.setattr(rp, "ring_sum", rp.ring_sum_plain)
    a, c = _inputs(torch.float32, True)
    got, ga, gc = _grads(rp.RingPad.apply, a, c, pads)
    want, wa, wc = _grads(_concat, a, c, pads)
    assert torch.equal(got, want) and torch.equal(ga, wa)
    torch.testing.assert_close(gc, wc, rtol=1e-6, atol=1e-6)
    g = torch.ones(got.shape)
    ctx = type("Ctx", (), {"pads": pads, "c_dtype": torch.float32,
                           "needs_input_grad": (True, False)})()
    view, none_c, *_ = rp.RingPad.backward(ctx, g)
    assert view.data_ptr() == g[:, :, pads[0]:, pads[2]:].data_ptr()
    assert view.shape == a.shape and none_c is None


def test_the_kernel_reads_a_column_slice_in_place():
    """What the kernel reads (channels innermost, pixels dense): an NHWC
    column slice as it is, an NCHW tensor through its channels_last copy."""
    x = torch.randn(2, 6, 9, 8)          # NHWC
    view = x[:, :, :8].permute(0, 3, 1, 2)
    assert rp._nhwc(view) is view
    nchw = torch.randn(2, 8, 6, 8)
    got = rp._nhwc(nchw)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, nchw)


def test_the_wrappers_validate_their_arguments():
    a, c = _inputs(torch.float32, True)
    with pytest.raises(ValueError, match="ring pad"):
        rp.ring_pad(a, c[:3], 1, 1, 1, 1)
    with pytest.raises(ValueError, match="ring pad"):
        rp.ring_pad_plain(a, c, -1, 0, 0, 0)


def test_the_kernels_refuse_the_cpu():
    """`ring_pad` and `ring_sum` are the card's: a CPU tensor is refused
    before any launch, and `_padc` does not route one to them."""
    a, c = _inputs(torch.float32, True)
    before = dict(_kernels.launch_counts)
    with pytest.raises(ValueError, match="ring_pad"):
        rp.ring_pad(a, c, 1, 1, 1, 1)
    with pytest.raises(ValueError, match="ring_sum"):
        rp.ring_sum(torch.zeros(2, 8, 9, 11), 1, 1, 1, 1)
    assert not rp.kernel_takes(a)
    assert _kernels.launch_counts == before


def _pair(cls, seed, **kw):
    """The pruned model and the plain pad-100 one with the same weights."""
    g = torch.Generator().manual_seed(seed)
    pr = cls(20, channel_scale=1 / 16, dropout_rate=0.0, device="cpu",
             generator=g, **kw)
    plain = cls(20, channel_scale=1 / 16, dropout_rate=0.0, device="cpu",
                prune_pad=False, generator=torch.Generator().manual_seed(0))
    plain.load_state_dict(pr.state_dict())
    return pr, plain


@pytest.mark.parametrize("cls,mode", [(FCN32s, "raw"), (FCN8s, "both")],
                         ids=["fcn32s", "fcn8s"])
@pytest.mark.parametrize("hw", [(64, 70), (61, 61)])
def test_pruned_models_equal_the_plain_stack(cls, mode, hw):
    """The heads (FCN-32s's raw ones, FCN-8s's full-resolution ones) and
    every parameter's gradient of the support-pruned model (channels_last
    from block 2 on) vs the plain pad-100 model: fp32, to the rounding of
    another summation order (rtol 1e-4, atol 1e-4 of the scale)."""
    pr, plain = _pair(cls, 7)
    x = torch.randn(2, *hw, 3, generator=torch.Generator().manual_seed(4))
    x = x * 40
    outs, grads = [], []
    for m in (pr, plain):
        m.zero_grad()
        f, s = m(x, mode=mode)
        (f.square().sum() + s.sum()).backward()
        outs.append((f.detach(), s.detach()))
        grads.append({n: p.grad for n, p in m.named_parameters()
                      if p.grad is not None})

    def close(got, want):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * want.abs().max().item())

    for got, want in zip(*outs):
        close(got, want)
    assert grads[0].keys() == grads[1].keys()
    assert "conv2_1.weight" in grads[0] and "conv1_1.weight" in grads[0]
    for n in grads[1]:
        close(grads[0][n], grads[1][n])


def test_pruned_blocks_pad_and_pool_in_channels_last(monkeypatch):
    """Every pad of an FCN-32s forward hands blocks 2-4 channels_last
    memory, and the pool array comes out in it."""
    pr, _ = _pair(FCN32s, 9)
    seen = []
    real = pruned._padc

    def spy(*args):
        out = real(*args)
        seen.append(out.is_contiguous(memory_format=torch.channels_last))
        return out

    monkeypatch.setattr(pruned, "_padc", spy)
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 64, 70, 3)
                         .astype(np.float32) * 40)
    with torch.no_grad():
        pr(x, mode="raw")
    # blocks 2-4's ring pads (2 + 3 + 3 convs) and their alignment pads
    assert len(seen) >= 8 and all(seen)
