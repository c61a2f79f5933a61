"""DeepLab-v2 ResNet-101 with the SZN heads (models/deeplab.py) on the CPU,
at 1/16 of the widths with blocks (1, 1, 2, 1), in fp32, against the plain
reference of tests/torch_deeplab_reference.py on the same seeded weights;
K1's x8 geometry (ops/szn_fused.py); the serving and predict entries."""

import json
import os.path as osp
import time

import numpy as np
import PIL.Image
import pytest
import torch

import torch_deeplab_reference as ref
from zeroshotsemanticsegmentation_tpu_torch.cli import predict as tp
from zeroshotsemanticsegmentation_tpu_torch.cli.train import run_experiment
from zeroshotsemanticsegmentation_tpu_torch.configs import Config, get_config
from zeroshotsemanticsegmentation_tpu_torch.data.transforms import (
    prepare_images)
from zeroshotsemanticsegmentation_tpu_torch.models import (
    DeepLabV2ResNet101, FCN32s)
from zeroshotsemanticsegmentation_tpu_torch.models.deeplab import (
    FrozenBatchNorm2d)
from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels
from zeroshotsemanticsegmentation_tpu_torch.ops import szn_fused as tsz
from zeroshotsemanticsegmentation_tpu_torch.ops.metrics import (
    unseen_mask_vector)
from zeroshotsemanticsegmentation_tpu_torch.serving import make_szn_predictor
from zeroshotsemanticsegmentation_tpu_torch.utils import profiling

torch.set_num_threads(1)

SCALE, BLOCKS = 1 / 16, (1, 1, 2, 1)
# 64^2 and a 500 x 333 VOC image at 1/8 of its sides
SIZES = [(64, 64), (63, 42)]
UNSEEN = [1, 13]
X8 = (8, 16, 4)


def _model(p=None, seed=0):
    m = DeepLabV2ResNet101(20, channel_scale=SCALE, blocks=BLOCKS,
                           generator=torch.Generator().manual_seed(seed),
                           device="cpu")
    if p is not None:
        m.load_state_dict(p, strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def weights():
    return ref.make_weights(1234)


def _images(h, w, n=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, h, w, 3), generator=g,
                         dtype=torch.uint8)


def _embed():
    rng = np.random.RandomState(7)
    return rng.randn(21, 20).astype(np.float32)


def test_published_shape_has_101_layers_and_44m_parameters():
    with torch.device("meta"):
        m = DeepLabV2ResNet101(20, device="meta")
    sd = m.state_dict()
    convs = [k for k in sd if k.endswith("conv1.weight") or k.endswith(
        "conv2.weight") or k.endswith("conv3.weight")]
    # the stem and 33 blocks of three: 100 weighted trunk layers, plus the
    # classifier layer that the ASPP heads replace
    assert len(convs) == 1 + 3 * 33
    n = sum(v.numel() for k, v in sd.items()
            if not k.endswith(("running_mean", "running_var")))
    assert 43.5e6 < n < 44.5e6
    assert set(sd) == set(ref.param_shapes(20))
    assert "layer1.0.downsample.0.weight" in sd
    assert "layer3.7.conv2.weight" in sd


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("mode", ["raw", "both"])
def test_model_matches_the_plain_reference(weights, hw, mode):
    """fp32, BN folded against BN applied: the same sums in another order
    (the fold multiplies the weight before the sum), so agreement to a few
    ulps of the heads' largest value, 1e-5 of it, and not exactly."""
    m = _model(weights)
    img = _images(*hw)
    with torch.no_grad():
        got = m(prepare_images(img), mode=mode)
        want = ref.heads(weights, ref.normalize(img), BLOCKS, mode)
    for g, w in zip(got, want):
        w = w.permute(0, 2, 3, 1)
        assert g.shape == w.shape and g.dtype == torch.float32
        tol = 1e-5 * w.abs().max().item()
        assert (g - w).abs().max().item() <= tol


def test_calibrated_weights_keep_the_trunk_order_one(weights):
    """The seeded statistics keep the last stage's output O(1) (its
    largest value within 100, its mean positive and not vanishing)."""
    with torch.no_grad():
        h = ref.trunk(weights, ref.normalize(_images(64, 64, seed=3)),
                      BLOCKS)
    assert 0.05 < h.mean().item() and h.abs().max().item() < 100


def test_folded_bn_equals_bn_applied():
    """One conv + frozen BN: the fold (fp32 scale into the weight, shift as
    the bias) against F.batch_norm after the conv; fp32 rounding of a
    64-term sum, so 1e-5 of the largest value."""
    g = torch.Generator().manual_seed(1)
    conv = torch.nn.Conv2d(16, 8, 3, padding=2, dilation=2, bias=False)
    bn = FrozenBatchNorm2d(8)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g))
        bn.weight.copy_(torch.rand(8, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(8, generator=g))
        bn.running_mean.copy_(torch.randn(8, generator=g))
        bn.running_var.copy_(torch.rand(8, generator=g) + 0.1)
        x = torch.randn(2, 16, 9, 11, generator=g)
        scale, shift = bn.scale_shift()
        got = torch.nn.functional.conv2d(
            x, conv.weight * scale[:, None, None, None], shift, padding=2,
            dilation=2)
        want = torch.nn.functional.batch_norm(
            conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
            training=False, eps=1e-5)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_one_fold_per_load_and_none_per_request(weights):
    m = _model()
    x = prepare_images(_images(32, 32))
    before = _kernels.launch_counts["bn_folds"]
    m.load_state_dict(weights)
    for _ in range(3):
        m(x, mode="raw")
    assert _kernels.launch_counts["bn_folds"] == before + 1
    predict = make_szn_predictor(m, weights, _embed(), UNSEEN, device="cpu")
    for _ in range(2):
        predict(_images(32, 32))
    assert _kernels.launch_counts["bn_folds"] == before + 2
    m.to("cpu", torch.float32)  # a move refolds at the next forward
    predict(_images(32, 32))
    assert _kernels.launch_counts["bn_folds"] == before + 3
    # a num_batches_tracked key (torchvision's files) is dropped on load
    sd = dict(weights)
    sd["bn1.num_batches_tracked"] = torch.tensor(5)
    m.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("side", [9, 16, 31, 33, 63, 65, 127, 333, 375, 501])
def test_one_eighth_geometry_on_odd_sides(side):
    """The heads' side: ceil(side / 2) after the stem's conv, ceil((s - 3)
    / 2) + 1 after the ceil-mode pool, ceil(s / 2) after layer2; the x8
    upsample of that many rows covers the image."""
    m = DeepLabV2ResNet101(20, channel_scale=1 / 32, blocks=(1, 1, 1, 1),
                           device="cpu")
    s = -(-side // 2)
    s = -(-(s - 3) // 2) + 1
    s = -(-s // 2)
    with torch.no_grad():
        f, g = m(torch.zeros(1, side, 17, 3), mode="raw")
        assert f.shape[1] == s and g.shape[1] == s
        assert (s - 1) * 8 + 16 - 4 >= side
        up, _ = m(torch.zeros(1, side, 17, 3), mode="both")
    assert up.shape[1:3] == (side, 17)


@pytest.mark.parametrize("lo,hi", [(8, 128), (128, 256), (256, 384),
                                   (384, 513)])
def test_x8_tap_tables_pass_k1_checks(lo, hi):
    """Every output length 8-512 with the 1/8 side the trunk gives it: two
    adjacent taps a row, a run of 4 outputs over at most 3 tap columns
    (`_tap_table` raises otherwise), the taps equal to the matrix."""
    for out in range(lo, hi):
        s = -(-(-(-out // 2) - 3) // 2) + 1
        s = -(-s // 2)
        i0, w = tsz._tap_table(s, out, X8)
        m = tsz._matrix(s, out, "cpu", X8).numpy()
        o = np.arange(out)
        assert np.array_equal(m[o, i0], w[0])
        assert np.all(w.sum(axis=0) <= 1.0 + 1e-6)


@pytest.mark.parametrize("hw", SIZES)
def test_predictor_labels_match_the_reference(weights, hw):
    """make_szn_predictor (K1's plain version at x8 on the CPU) against the
    reference's stitched labels of its upsampled heads: fp32 on both sides,
    so a label may differ only where a class or the gate ties within
    rounding, at most 1 pixel in 1000."""
    m = _model()
    emb = _embed()
    predict = make_szn_predictor(m, weights, emb, UNSEEN, device="cpu")
    img = _images(*hw, n=3, seed=5)
    got = predict(img)
    with torch.no_grad():
        s, g = ref.heads(weights, ref.normalize(img), BLOCKS)
    want = ref.stitched_labels(s, g, torch.from_numpy(emb), UNSEEN)
    assert got.shape == want.shape and got.dtype == torch.int32
    assert (got != want).float().mean().item() <= 1e-3


def test_fcn32s_labels_unchanged_by_the_geometry_argument():
    """FCN-32s's K1 labels with the geometry at its default and given as
    (32, 64, 19) are bit-equal, from the same tap tables and plan."""
    rng = np.random.RandomState(3)
    score = torch.from_numpy(rng.randn(2, 17, 16, 20).astype(np.float32))
    sm = torch.from_numpy(rng.randn(2, 17, 16, 2).astype(np.float32))
    emb = _embed()
    uv = unseen_mask_vector(21, UNSEEN)
    a = tsz.infer_labels_szn_fused(score, sm, emb, uv, (512, 500))
    b = tsz.infer_labels_szn_fused(score, sm, emb, uv, (512, 500), None,
                                   tsz.FCN32S_GEOMETRY)
    assert tsz.FCN32S_GEOMETRY == (32, 64, 19)
    assert torch.equal(a, b)
    for n, out in ((17, 512), (16, 500)):
        t0 = tsz._tap_table(n, out)
        t1 = tsz._tap_table(n, out, (32, 64, 19))
        assert np.array_equal(t0[0], t1[0]) and np.array_equal(t0[1], t1[1])
    # another geometry gives other labels from the same heads
    c = tsz.infer_labels_szn_fused(score, sm, emb, uv, (128, 120), None, X8)
    assert c.shape == (2, 128, 120)


def test_spans_carry_each_stage_s_shapes(weights):
    m = _model(weights)
    img = _images(64, 48, n=2)
    predict = make_szn_predictor(m, None, _embed(), UNSEEN, device="cpu")
    profiling.clear_spans()
    t0 = time.time_ns()
    with profiling.force_tracing():
        tp.predict_arrays(predict, list(img.numpy()), bucket=(64, 64),
                          batch_size=2)
    recs = profiling.spans(t0, time.time_ns())
    by = {r.name: r for r in recs}
    # the 64 x 64 bucket: 32 after the stem's conv, 16 after its pool
    want = {"model.stem": (16, 16, 1), "model.layer1": (16, 16, 1),
            "model.layer2": (8, 8, 1), "model.layer3": (8, 8, 2),
            "model.layer4": (8, 8, 4)}
    root = by["serve.request"].id
    for name, (h, w, d) in want.items():
        r = by[name]
        assert r.work == {"batch": 2, "h": h, "w": w, "dilation": d}, name
        assert r.trace == root and by["model.forward"].id == r.parent
    a = by["model.aspp"].work
    assert (a["batch"], a["h"], a["w"]) == (2, 8, 8)
    assert tuple(a["dilation"]) == (6, 12, 18, 24)


@pytest.mark.parametrize("kw", [dict(int8=True), dict(mesh=object()),
                                dict(spatial=True)])
def test_predictor_refuses_int8_mesh_and_spatial(weights, kw):
    with pytest.raises(ValueError, match="DeepLabV2ResNet101"):
        make_szn_predictor(_model(), weights, _embed(), UNSEEN,
                           device="cpu", **kw)


def test_int8_guard_keys_on_fcn32s():
    """int8 stays FCN-32s's: its predictor builds; the guard names it."""
    m = FCN32s(20, channel_scale=1 / 32, device="cpu")
    make_szn_predictor(m, None, _embed(), UNSEEN, device="cpu", int8=True)


CFG = dict(dataset="pascal", embed_dim=20, val_unseen=(1, 13),
           bucket=(64, 64), compute_dtype="float32", channel_scale=SCALE,
           arch="deeplabv2_r101", num_viz=0)


def test_predict_cli_serves_deeplab(tmp_path, monkeypatch):
    """`run_predict` on PNGs from a file of the model's state dict (all 33
    blocks at 1/16 of the widths, under `model_state_dict`, with
    torchvision's `num_batches_tracked`) writes the labels
    `predict_arrays` gives; `--arch deeplabv2_r101` reaches it through
    `main`."""
    full_depth = ref.make_weights(99, blocks=ref.BLOCKS)
    ckpt = tmp_path / "best"
    torch.save({"model_state_dict": {**full_depth,
                                     "bn1.num_batches_tracked":
                                     torch.tensor(0)}}, ckpt)
    (tmp_path / "imgs").mkdir()
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 255, s + (3,)).astype(np.uint8)
            for s in ((40, 64), (64, 48), (56, 56))]
    for i, im in enumerate(imgs):
        PIL.Image.fromarray(im).save(tmp_path / "imgs" / f"img{i}.png")
    cfg = Config(**CFG)
    paths = tp.run_predict(cfg, checkpoint=str(ckpt),
                           images=str(tmp_path / "imgs"),
                           out_dir=str(tmp_path / "out"), batch_size=2,
                           verbose=False, device="cpu")
    got = [np.asarray(PIL.Image.open(p)) for p in paths]
    predict, names, trained = tp.build_predictor(cfg, str(ckpt),
                                                 device="cpu")
    want = tp.predict_arrays(predict, imgs, bucket=(64, 64), batch_size=2)
    assert len(names) == 21 and trained is False
    for g, w, im in zip(got, want, imgs):
        assert g.shape == im.shape[:2] and np.array_equal(g, w)
    seen = {}
    monkeypatch.setattr(tp, "run_predict",
                        lambda c, **k: seen.setdefault("arch", c.arch) and [])
    tp.main(["-c", "15", "--checkpoint", str(ckpt), "--images",
             str(tmp_path / "imgs"), "--out", str(tmp_path / "o2"),
             "--arch", "deeplabv2_r101", "--device", "cpu"])
    assert seen["arch"] == "deeplabv2_r101"


def test_predictor_refuses_a_bucket_off_the_output_stride(tmp_path,
                                                          weights):
    ckpt = tmp_path / "best"
    torch.save(weights, ckpt)
    with pytest.raises(ValueError, match="multiples of 8"):
        tp.build_predictor(Config(**{**CFG, "bucket": (60, 64)}), str(ckpt),
                           device="cpu")


def test_presets_take_the_arch_and_the_trainers_refuse_it():
    cfg = get_config(15, arch="deeplabv2_r101", load_fcn_path="x")
    assert cfg.arch == "deeplabv2_r101"
    with pytest.raises(ValueError, match="serves only"):
        run_experiment(Config(**CFG), synthetic=True, verbose=False,
                       device="cpu")


def test_benchmark_configuration_matches_the_model():
    """The benchmark's configuration states the model's published numbers."""
    with open(osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                       "benchmark", "configs",
                       "deeplabv2-r101-voc.json")) as f:
        cfg = json.load(f)
    from zeroshotsemanticsegmentation_tpu_torch.models import deeplab as d
    assert tuple(cfg["blocks"]) == d.BLOCKS
    assert tuple(map(tuple, cfg["widths"])) == d.WIDTHS
    assert tuple(cfg["dilations"]) == d.DILATIONS
    assert tuple(cfg["strides"]) == d.STRIDES
    assert tuple(cfg["aspp_rates"]) == d.ASPP_RATES
    assert tuple(cfg["upsample"]) == DeepLabV2ResNet101.UPSAMPLE
    assert cfg["stem_channels"] == d.STEM and cfg["reduced"] == []
