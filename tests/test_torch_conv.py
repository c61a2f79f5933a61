"""The port's fc6 and 1x1 convolutions vs the JAX package's, in fp32 on the
CPU, with the dot-free mode off and on (on both sides alike).

`conv_valid_mmgrad` (fc6: matmul input gradient + overlap-add) and
`conv1x1_mmwgrad` (fc7 and the heads: the weight gradient on K7 under the
mode) against the JAX ops of the same names, whose Pallas matmul runs in
interpret mode. Shapes and bars: tests/test_conv7x7.py:22-47 and
tests/test_conv1x1.py:30-50. JAX layouts are NHWC / HWIO, the port's NCHW
(channels_last memory) / OIHW.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotsemanticsegmentation_tpu.ops import dotpolicy as j_policy
from zeroshotsemanticsegmentation_tpu.ops.conv1x1 import (
    conv1x1_mmwgrad as j_conv1x1)
from zeroshotsemanticsegmentation_tpu.ops.conv7x7 import (
    conv_valid_mmgrad as j_conv7x7)
from zeroshotsemanticsegmentation_tpu_torch.ops import conv1x1, conv7x7
from zeroshotsemanticsegmentation_tpu_torch.ops import dotpolicy

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_policies():
    yield
    dotpolicy.set_dot_free(None)
    j_policy.set_dot_free(None)


def _set_mode(on: bool) -> None:
    dotpolicy.set_dot_free(on)
    j_policy.set_dot_free(on)


@pytest.fixture
def pdot_calls(monkeypatch):
    """Counts the port's matmul calls from both conv ops."""
    calls = []
    for mod in (conv1x1, conv7x7):
        real = mod.pdot

        def spy(*a, _real=real, **kw):
            calls.append(kw.get("trans_a", False))
            return _real(*a, **kw)
        monkeypatch.setattr(mod, "pdot", spy)
    return calls


def _port_grads(op, x, k, g):
    """(y NHWC, dx NHWC, dk HWIO) of the port's `op` from NHWC/HWIO numpy."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    assert xt.is_contiguous(memory_format=torch.channels_last)
    kt = torch.from_numpy(np.ascontiguousarray(
        k.transpose(3, 2, 0, 1))).requires_grad_()
    y = op(xt, kt)
    y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    return (y.detach().permute(0, 2, 3, 1).numpy(),
            xt.grad.permute(0, 2, 3, 1).numpy(),
            kt.grad.numpy().transpose(2, 3, 1, 0))


def _jax_grads(op, x, k, g):
    y, vjp = jax.vjp(op, jnp.asarray(x), jnp.asarray(k))
    dx, dk = vjp(jnp.asarray(g))
    return np.asarray(y), np.asarray(dx), np.asarray(dk)


@pytest.mark.parametrize("dot_free", [False, True], ids=["default",
                                                         "dot-free"])
@pytest.mark.parametrize("shape,ksize", [
    ((2, 11, 12, 5), (3, 3)),
    ((2, 13, 13, 8), (7, 7)),   # fc6-like: output 7x7 from 13x13
    ((1, 7, 9, 4), (7, 7)),     # minimum-height output row
])
def test_conv_valid_mmgrad_matches_jax(rng, pdot_calls, dot_free, shape,
                                       ksize):
    _set_mode(dot_free)
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(*ksize, shape[-1], 6) * 0.3).astype(np.float32)
    oh, ow = shape[1] - ksize[0] + 1, shape[2] - ksize[1] + 1
    g = rng.randn(shape[0], oh, ow, 6).astype(np.float32)
    y, dx, dk = _port_grads(conv7x7.conv_valid_mmgrad, x, k, g)
    jy, jdx, jdk = _jax_grads(j_conv7x7, x, k, g)
    # the forward is torch's convolution, not the JAX op's code: 392-term
    # fp32 sums in another order differ by up to ~6e-6 here, so it is held
    # at the gradients' bar (tests/test_conv7x7.py's 1e-6 compares the JAX
    # op with the same XLA convolution)
    np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx, jdx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dk, jdk, rtol=1e-5, atol=1e-5)
    # the input gradient's one product went through pdot iff dot-free
    assert pdot_calls == ([False] if dot_free else [])


@pytest.mark.parametrize("dot_free", [False, True], ids=["default",
                                                         "dot-free"])
@pytest.mark.parametrize("b,h,w,ci,co", [
    (2, 5, 7, 16, 4),     # odd spatial, small channels
    (3, 4, 4, 33, 21),    # unaligned channels
    (1, 1, 1, 8, 2),      # degenerate 1-pixel image
])
def test_conv1x1_mmwgrad_matches_jax(rng, pdot_calls, dot_free, b, h, w,
                                     ci, co):
    _set_mode(dot_free)
    x = rng.randn(b, h, w, ci).astype(np.float32)
    k = (rng.randn(1, 1, ci, co) * 0.1).astype(np.float32)
    g = rng.randn(b, h, w, co).astype(np.float32)
    y, dx, dk = _port_grads(conv1x1.conv1x1_mmwgrad, x, k, g)
    jy, jdx, jdk = _jax_grads(j_conv1x1, x, k, g)
    np.testing.assert_allclose(y, jy, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dx, jdx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dk, jdk, rtol=1e-5, atol=1e-4)
    # the weight gradient went through pdot (trans_a) iff dot-free
    assert pdot_calls == ([True] if dot_free else [])


def test_mode_is_read_once_per_forward(rng, pdot_calls):
    """A backward follows the mode its forward saw, whatever the policy is
    by then."""
    x = torch.from_numpy(rng.randn(1, 9, 9, 3).astype(np.float32)).permute(
        0, 3, 1, 2).requires_grad_()
    k = torch.from_numpy(rng.randn(4, 3, 7, 7).astype(np.float32))
    dotpolicy.set_dot_free(True)
    y = conv7x7.conv_valid_mmgrad(x, k)
    dotpolicy.set_dot_free(False)
    y.sum().backward()
    assert pdot_calls == [False]


def test_nhwc_rows_views_channels_last(rng):
    t = torch.from_numpy(rng.randn(2, 3, 4, 5).astype(np.float32))
    cl = t.contiguous(memory_format=torch.channels_last)
    rows = conv1x1.nhwc_rows(cl)
    assert rows.shape == (40, 3) and rows.data_ptr() == cl.data_ptr()
    torch.testing.assert_close(conv1x1.nhwc_rows(t), rows)


# ------------------------------------- fc6's implicit-GEMM route (CPU side)

@pytest.mark.parametrize("dtype,is_cuda,cin,cout,aligned,takes", [
    (torch.bfloat16, True, 512, 4096, True, True),    # fc6, both models
    (torch.bfloat16, True, 512, 2048, True, True),    # fc6's TP shard
    (torch.bfloat16, True, 64, 256, True, True),      # the smallest granules
    (torch.float32, True, 512, 4096, True, False),    # fp32: F.conv2d
    (torch.float16, True, 512, 4096, True, False),
    (torch.bfloat16, False, 512, 4096, True, False),  # the CPU
    (torch.bfloat16, True, 32, 4096, True, False),    # narrow test widths
    (torch.bfloat16, True, 520, 4096, True, False),
    (torch.bfloat16, True, 512, 4000, True, False),   # Cout off its granule
    (torch.bfloat16, True, 512, 384, True, False),
    (torch.bfloat16, True, 512, 128, True, False),
    (torch.bfloat16, True, 512, 4096, False, False),  # unaligned input
])
def test_igemm_route_choice(dtype, is_cuda, cin, cout, aligned, takes):
    """The kernel's route, decided on dtype, device, shapes and alignment
    alone: bf16 on the card with Cin % 64, Cout % 256 and an aligned input
    takes it; everything else keeps F.conv2d."""
    assert conv7x7.igemm_takes(dtype, is_cuda, cin, cout, aligned) is takes


def test_igemm_route_reads_the_tensor():
    x = torch.zeros(2, 64, 9, 9, dtype=torch.bfloat16)
    assert not conv7x7.igemm_route(x, 256)   # a CPU tensor
    assert not conv7x7.igemm_route(x.float(), 256)


@pytest.mark.parametrize("route,x_dtype,w_dtype,packed,runs", [
    (True, torch.bfloat16, torch.bfloat16, True, True),    # the kernel
    (True, torch.float32, torch.float32, True, True),      # forced, CPU
    (True, torch.bfloat16, torch.bfloat16, False, False),  # w not packed
    (True, torch.bfloat16, torch.float32, True, False),    # dtypes differ
    (False, torch.bfloat16, torch.bfloat16, True, False),  # off the route
    (False, torch.float32, torch.float32, False, False),   # F.conv2d
])
def test_runs_igemm_reads_route_and_layout(monkeypatch, route, x_dtype,
                                           w_dtype, packed, runs):
    """The forward takes the kernel only where `x` is on its route and the
    weight is packed (channels_last) in x's dtype; `weight_for` packs on
    the route and casts plainly elsewhere."""
    monkeypatch.setattr(conv7x7, "igemm_route", lambda x, co: route)
    x = torch.zeros(1, 64, 9, 9, dtype=x_dtype)
    w32 = torch.zeros(256, 64, 7, 7)
    w = (conv7x7.pack_weight(w32, w_dtype) if packed else w32.to(w_dtype))
    assert conv7x7.runs_igemm(x, w) is runs
    got = conv7x7.weight_for(x, w32, x_dtype)
    assert got.dtype == x_dtype and got.shape == w32.shape
    assert got.is_contiguous(memory_format=torch.channels_last) is route
    assert got.is_contiguous() is not route
    assert conv7x7.runs_igemm(x, got) is route


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_weight_is_one_copy_and_a_view_for_the_backward(dtype):
    """The packed weight is one new tensor in channels_last memory (the
    cast and the layout in one pass); the backward's (CO, KH*KW*CI)
    operand is a view of it; packing a packed weight copies nothing."""
    w = torch.randn(8, 16, 7, 7)
    wp = conv7x7.pack_weight(w, dtype)
    assert wp.dtype == dtype and wp.data_ptr() != w.data_ptr()
    assert wp.is_contiguous(memory_format=torch.channels_last)
    km = wp.permute(0, 2, 3, 1).reshape(8, -1)
    assert km.data_ptr() == wp.data_ptr() and km.is_contiguous()
    assert conv7x7.pack_weight(wp, dtype) is wp


@pytest.mark.parametrize("b,ci,ih,iw,co,k", [
    (2, 8, 13, 13, 6, 7),     # fc6-like: 7x7 output from 13x13
    (1, 4, 7, 9, 5, 7),       # one output row
    (3, 5, 11, 8, 4, 3),      # a 3x3 kernel, odd extents
])
def test_packed_weight_column_order(rng, b, ci, ih, iw, co, k):
    """The packed weight, read as the contiguous (CO, KH*KW*CI) matrix, is
    the implicit GEMM's B: an unfold of x in (dh, dw, ci) column order
    times it is F.conv2d, in fp32 at 1e-5; so is the kernel's plain
    version (what `conv7x7_igemm` runs on a CPU tensor)."""
    x = torch.from_numpy(rng.randn(b, ih, iw, ci).astype(np.float32)).permute(
        0, 3, 1, 2)
    w = torch.from_numpy((rng.randn(co, ci, k, k) * 0.3).astype(np.float32))
    wp = conv7x7.pack_weight(w, torch.float32)
    assert wp.shape == (co, ci, k, k)
    km = wp.permute(0, 2, 3, 1).view(co, -1)
    want = torch.nn.functional.conv2d(x, w)
    oh, ow = ih - k + 1, iw - k + 1
    cols = conv7x7.patches(x, k, k)
    assert cols.shape == (b * oh * ow, k * k * ci)
    y = (cols @ km.t()).view(b, oh, ow, co).permute(0, 3, 1, 2)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    got = conv7x7.conv7x7_igemm(x, wp)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert got.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_pdot", [False, True])
def test_input_grad_from_packed_weight(rng, dtype, use_pdot):
    """The backward's input gradient from the packed weight, whose
    (CO, KH*KW*CI) operand is then a view, is the dx it gives from the
    contiguous weight, bit for bit."""
    w = torch.from_numpy(
        (rng.randn(6, 8, 7, 7) * 0.3).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.randn(2, 6, 7, 7).astype(np.float32)).to(
        dtype).contiguous(memory_format=torch.channels_last)
    wp = conv7x7.pack_weight(w, dtype)
    shape = (2, 8, 13, 13)
    want = conv7x7._input_grad(g, w, shape, dtype, use_pdot)
    got = conv7x7._input_grad(g, wp, shape, dtype, use_pdot)
    assert got.shape == want.shape == shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("dot_free", [False, True], ids=["default",
                                                         "dot-free"])
def test_packed_op_grads_match_unpacked(rng, monkeypatch, dot_free):
    """The kernel's route end to end on the CPU (forced; the kernel's plain
    version runs): forward within 1e-5 of F.conv2d's, and dx and the fp32
    parameter's gradient (back through the pack) equal to the F.conv2d
    route's."""
    dotpolicy.set_dot_free(dot_free)
    x = torch.from_numpy(rng.randn(2, 13, 12, 8).astype(np.float32)).permute(
        0, 3, 1, 2)
    w = torch.from_numpy((rng.randn(6, 8, 7, 7) * 0.3).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 7, 6, 6).astype(np.float32)).permute(
        0, 3, 1, 2)
    out = []
    for on in (False, True):
        monkeypatch.setattr(conv7x7, "igemm_route", lambda x, co, on=on: on)
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        wt = conv7x7.weight_for(xs, ws, torch.float32)
        assert conv7x7.runs_igemm(xs, wt) is on
        y = conv7x7.conv_valid_mmgrad(xs, wt)
        y.backward(g)
        assert ws.grad.shape == w.shape and ws.grad.is_contiguous()
        out.append((y.detach(), xs.grad, ws.grad))
    (y0, dx0, dw0), (y1, dx1, dw1) = out
    torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-5)
    assert torch.equal(dx1, dx0) and torch.equal(dw1, dw0)


def test_model_fc6_on_the_packed_route(monkeypatch):
    """A tiny FCN-32s with the route forced on (here the kernel's plain
    version runs): the `model.fc6` span records `igemm` 1 (0 off the
    route), the heads are within 1e-4 of the F.conv2d route's and every
    parameter's gradient within 1e-4 relative; fc6's weight gradient
    reaches the fp32 parameter in its own layout."""
    from zeroshotsemanticsegmentation_tpu_torch.models import fcn32s
    from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import (
        clear_spans, force_tracing, spans)
    model = fcn32s.FCN32s(8, channel_scale=1 / 16, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(3).rand(
        2, 40, 36, 3).astype(np.float32))
    runs = {}
    for on in (False, True):
        monkeypatch.setattr(conv7x7, "igemm_route", lambda h, co, on=on: on)
        model.zero_grad()
        clear_spans()
        with force_tracing():
            f, s = model(x, mode="raw")
        (f.square().sum() + s.sum()).backward()
        fc6 = [r for r in spans(0, 2 ** 63 - 1) if r.name == "model.fc6"]
        assert [r.work["igemm"] for r in fc6] == [int(on)]
        runs[on] = (f.detach(), s.detach(),
                    {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None})
    clear_spans()
    torch.testing.assert_close(runs[True][0], runs[False][0], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(runs[True][1], runs[False][1], rtol=1e-4,
                               atol=1e-4)
    assert runs[True][2].keys() == runs[False][2].keys()
    assert runs[True][2]["fc6.weight"].stride() == model.fc6.weight.stride()
    for n, want in runs[False][2].items():
        err = (runs[True][2][n] - want).norm() / want.norm().clamp_min(1e-30)
        assert err.item() < 1e-4, (n, err.item())
