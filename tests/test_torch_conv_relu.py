"""The FCN trunk's conv + bias + ReLU (`ops.conv_relu.conv_bias_relu`) on
the CPU: the three ops there, bit for bit; the one cuDNN call only where
autograd records nothing, shown by forcing the card's branch with a stub
and replacing `torch.cudnn_convolution_relu`; its `model.conv` span."""

import pytest
import torch
import torch.nn.functional as F

from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
from zeroshotsemanticsegmentation_tpu_torch.models.fcn8s import FCN8s
from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
from zeroshotsemanticsegmentation_tpu_torch.ops import conv_relu as cr
from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import (
    clear_spans, force_tracing, spans)

torch.set_num_threads(2)
EVERYTHING = (0, 2 ** 63 - 1)


def _inputs(dtype, cin=8, cout=16, hw=(9, 11), channels_last=False):
    g = torch.Generator().manual_seed(0)
    a = torch.randn(2, cin, *hw, generator=g).to(dtype)
    if channels_last:
        a = a.contiguous(memory_format=torch.channels_last)
    w = torch.randn(cout, cin, 3, 3, generator=g) * 0.2
    b = torch.randn(cout, generator=g) * 0.1
    return a, w, b


def _fake_fused(calls):
    """A stand-in for `torch.cudnn_convolution_relu` on the CPU: records
    its call and computes relu(conv + b)."""
    def fused(a, w, b, stride, padding, dilation, groups):
        calls.append(tuple(w.shape))
        return torch.relu(F.conv2d(a, w, b, stride, padding, dilation,
                                   groups))
    return fused


def _refuse(*args, **kwargs):
    raise AssertionError("the fused call took a forward that records")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("padding", [0, 1, (0, 1)])
@pytest.mark.parametrize("channels_last", [False, True])
def test_the_cpu_keeps_the_three_ops_bit_for_bit(monkeypatch, dtype,
                                                 padding, channels_last):
    monkeypatch.setattr(torch, "cudnn_convolution_relu", _refuse)
    a, w, b = _inputs(dtype, channels_last=channels_last)
    before = _kernels.launch_counts["conv_plain"]
    got = cr.conv_bias_relu(a, w, b, dtype, padding)
    want = torch.relu(F.conv2d(a, w.to(dtype), b.to(dtype),
                               padding=padding))
    assert not cr.fused_takes(a, w, b)
    assert got.dtype == dtype and torch.equal(got, want)
    assert _kernels.launch_counts["conv_plain"] == before + 1


@pytest.mark.parametrize("grad, requires, fused", [
    (True, "w", False), (True, "b", False), (True, "a", False),
    (True, "wba", False), (True, "", True), (False, "wba", True)])
def test_only_a_forward_that_records_nothing_takes_the_fused_call(
        monkeypatch, grad, requires, fused):
    """With the card's branch forced, a call that autograd would record
    keeps the three ops (the fused stand-in refuses it); one it would not
    record takes the fused call, with the same values."""
    monkeypatch.setattr(cr, "_on_card", lambda a: True)
    calls = []
    monkeypatch.setattr(torch, "cudnn_convolution_relu",
                        _refuse if not fused else _fake_fused(calls))
    a, w, b = _inputs(torch.float32)
    a.requires_grad_("a" in requires)
    w.requires_grad_("w" in requires)
    b.requires_grad_("b" in requires)
    want = torch.relu(F.conv2d(a, w, b, padding=1)).detach()
    counts = dict(_kernels.launch_counts)
    with torch.set_grad_enabled(grad):
        assert cr.fused_takes(a, w, b) == fused
        got = cr.conv_bias_relu(a, w, b, torch.float32, 1)
    assert calls == ([tuple(w.shape)] if fused else [])
    assert _kernels.launch_counts["conv_fused"] - counts["conv_fused"] \
        == int(fused)
    assert _kernels.launch_counts["conv_plain"] - counts["conv_plain"] \
        == int(not fused)
    torch.testing.assert_close(got.detach(), want, rtol=1e-6, atol=1e-6)
    if grad and requires:
        got.sum().backward()  # the three ops carry the backward


def test_the_fused_call_gets_channels_last_weights_in_the_dtype(
        monkeypatch):
    monkeypatch.setattr(cr, "_on_card", lambda a: True)
    seen = []

    def fused(a, w, b, stride, padding, dilation, groups):
        seen.append((w.dtype, b.dtype,
                     w.is_contiguous(memory_format=torch.channels_last),
                     stride, padding, dilation, groups))
        return torch.relu(F.conv2d(a, w, b, stride, padding, dilation,
                                   groups))
    monkeypatch.setattr(torch, "cudnn_convolution_relu", fused)
    a, w, b = _inputs(torch.bfloat16, channels_last=True)
    with torch.no_grad():
        cr.conv_bias_relu(a, w, b, torch.bfloat16, (0, 1))
    assert seen == [(torch.bfloat16, torch.bfloat16, True, (1, 1), (0, 1),
                     (1, 1), 1)]


@pytest.mark.parametrize("padding", [0, 1, (0, 1)])
def test_each_call_is_one_model_conv_span(padding):
    a, w, b = _inputs(torch.float32, cin=8, cout=16, hw=(9, 11))
    clear_spans()
    with force_tracing():
        out = cr.conv_bias_relu(a, w, b, torch.float32, padding)
    recs = [r for r in spans(*EVERYTHING) if r.name == "model.conv"]
    clear_spans()
    _, _, oh, ow = out.shape
    assert [r.work for r in recs] == [
        {"flops": 2 * 2 * oh * ow * 16 * 8 * 9, "fused": 0}]
    assert recs[0].device_ms is None  # no card


def _tiny(cls, **kw):
    return cls(20, channel_scale=1 / 16, dropout_rate=0.0, device="cpu",
               generator=torch.Generator().manual_seed(2), **kw)


def _x(hw=64):
    return torch.randn(2, hw, hw, 3,
                       generator=torch.Generator().manual_seed(3)) * 40


@pytest.mark.parametrize("cls, mode, remat, prune", [
    (FCN32s, "fcn", False, True), (FCN32s, "fcn", True, True),
    (FCN32s, "fcn", False, False), (FCN8s, "fcn", False, True)])
def test_a_training_forward_never_takes_the_fused_call(monkeypatch, cls,
                                                       mode, remat, prune):
    """Stage 1's forward and backward (remat too, pruned and not) with the
    card's branch forced: every conv keeps the three ops."""
    monkeypatch.setattr(cr, "_on_card", lambda a: True)
    monkeypatch.setattr(torch, "cudnn_convolution_relu", _refuse)
    m = _tiny(cls, remat=remat, prune_pad=prune)
    _kernels.reset_launch_counts()
    out = m(_x(), mode=mode, train=True)
    out.square().sum().backward()
    assert _kernels.launch_counts["conv_fused"] == 0
    assert _kernels.launch_counts["conv_plain"] > 0
    assert m.conv2_1.weight.grad is not None


@pytest.mark.parametrize("cls", [FCN32s, FCN8s])
@pytest.mark.parametrize("frozen", [False, True])
def test_a_forward_that_records_nothing_fuses_every_trunk_conv(
        monkeypatch, cls, frozen):
    """Serving (no grad) and stage 2's frozen trunk with the card's branch
    forced: every conv of blocks 2-5 and of the frame probe takes the
    fused call, and the heads equal the three ops' (the stand-in computes
    the same values)."""
    m = _tiny(cls)
    x = _x()
    mode = "raw" if cls is FCN32s else "fcn"
    with torch.no_grad():
        want = m(x, mode=mode)
    monkeypatch.setattr(cr, "_on_card", lambda a: True)
    calls = []
    monkeypatch.setattr(torch, "cudnn_convolution_relu", _fake_fused(calls))
    _kernels.reset_launch_counts()
    if frozen:
        got = m(x, mode=mode, frozen_trunk=True)
    else:
        with torch.no_grad():
            got = m(x, mode=mode)
    assert _kernels.launch_counts["conv_plain"] == 0
    # the probe's blocks and the data path's (block 1 unfused here), and
    # each block after the pruned run
    assert _kernels.launch_counts["conv_fused"] == len(calls) \
        == 2 * sum((2, 2, 3, 3)[:m.PRUNED_DEPTH]) + sum(
            (2, 2, 3, 3, 3)[m.PRUNED_DEPTH:])
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(g.detach(), w, rtol=1e-5, atol=1e-5)
