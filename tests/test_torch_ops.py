"""PyTorch port ops vs the JAX package, fp32 on the CPU.

Inputs come from a numpy seed and go through the JAX function and its
counterpart in zeroshotsemanticsegmentation_tpu_torch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotsemanticsegmentation_tpu import ops as jops
from zeroshotsemanticsegmentation_tpu.data import assets as jassets
from zeroshotsemanticsegmentation_tpu.data import transforms as jtf
from zeroshotsemanticsegmentation_tpu.models import FCN32s as JFCN32s
from zeroshotsemanticsegmentation_tpu.models.ref_import import CONV_MODULES
from zeroshotsemanticsegmentation_tpu.ops import metrics as jmetrics
from zeroshotsemanticsegmentation_tpu.ops import nne as jnne
from zeroshotsemanticsegmentation_tpu_torch.data import assets as tassets
from zeroshotsemanticsegmentation_tpu_torch.data import transforms as ttf
from zeroshotsemanticsegmentation_tpu_torch.models import fcn32s as tfcn
from zeroshotsemanticsegmentation_tpu_torch.models.jax_weights import (
    load_jax_params, state_dict_from_jax_params)
from zeroshotsemanticsegmentation_tpu_torch.ops import bilinear as tbil
from zeroshotsemanticsegmentation_tpu_torch.ops import metrics as tmetrics
from zeroshotsemanticsegmentation_tpu_torch.ops import nne as tnne

torch.set_num_threads(1)

T = torch.from_numpy


def test_weight_bridge_strict():
    """A flax FCN32s tree loads into the port with strict=True: no missing,
    no unexpected keys; layouts land where the reference puts them."""
    model = JFCN32s(num_classes=8, channel_scale=1 / 16)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                        mode="both")["params"]
    tree = jax.tree.map(np.asarray, params)
    port = tfcn.FCN32s(8, channel_scale=1 / 16, device="cpu")
    res = port.load_state_dict(state_dict_from_jax_params(tree), strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    assert tfcn.CONV_MODULES == CONV_MODULES
    np.testing.assert_array_equal(
        port.conv1_2.weight.detach().numpy(),
        tree["conv1_2"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        port.seenmask_upscore.weight.detach().numpy(),
        tree["seenmask_upscore"]["kernel"].transpose(2, 3, 0, 1))
    del tree["fc7"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_params(port, tree)


@pytest.mark.parametrize("in_len,out_len", [(5, 96), (17, 512), (4, 70),
                                            (16, 500), (12, 375)])
def test_upsample_matrix_identical(in_len, out_len):
    np.testing.assert_array_equal(
        tbil.upsample_matrix(in_len, 32, 64, 19, out_len),
        jops.bilinear.upsample_matrix(in_len, 32, 64, 19, out_len))
    np.testing.assert_array_equal(tbil.bilinear_upsampling_kernel(3, 64),
                                  jops.bilinear_upsampling_kernel(3, 64))


@pytest.mark.parametrize("shape,out", [((2, 5, 5, 3), (96, 96)),
                                       ((1, 4, 6, 2), (70, 130))])
def test_upsample_bilinear_cropped(rng, shape, out):
    x = rng.randn(*shape).astype(np.float32)
    kw = dict(stride=32, kernel_size=64, crop_offset=19, out_h=out[0],
              out_w=out[1])
    want = np.asarray(jops.upsample_bilinear_cropped(jnp.asarray(x), **kw))
    got = tbil.upsample_bilinear_cropped(T(x), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_upscore_conv_transpose_trained(rng):
    """Trained (non-bilinear) seenmask upscore: the port's ConvTranspose2d
    on the IOHW weight == the JAX phase-matmul form on the HWIO kernel."""
    from zeroshotsemanticsegmentation_tpu.ops.bilinear import (
        upscore_conv_transpose_cropped as jup)
    x = rng.randn(2, 4, 5, 2).astype(np.float32)
    k = (jops.bilinear_upsampling_kernel(2, 64)
         + rng.randn(64, 64, 2, 2).astype(np.float32))
    kw = dict(stride=32, crop_offset=19, out_h=70, out_w=100)
    want = np.asarray(jup(jnp.asarray(x), jnp.asarray(k), **kw))
    got = tbil.upscore_conv_transpose_cropped(
        T(x), T(k.transpose(2, 3, 0, 1).copy()), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _nne_inputs(rng):
    score = rng.randn(2, 6, 7, 8).astype(np.float32)
    score[0, :2] = 0.0                                   # zero-norm pixels
    embed = rng.randn(9, 8).astype(np.float32)
    embed /= np.linalg.norm(embed, axis=1, keepdims=True)
    embed[3] = 0.0                                       # zeroed class row
    uv = jmetrics.unseen_mask_vector(9, [3, 7])
    sm = rng.randn(2, 6, 7, 2).astype(np.float32)
    return score, embed, uv, sm


def test_cosine_similarities(rng):
    score, embed, _, _ = _nne_inputs(rng)
    want = np.asarray(jnne.cosine_similarities(jnp.asarray(score),
                                               jnp.asarray(embed)))
    got = tnne.cosine_similarities(T(score), T(embed)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_infer_labels_exact(rng):
    """infer_labels / _stitched / _szn labels are exact, including the
    masked-to-0.0 quirk (all-negative sims pick a masked class)."""
    score, embed, uv, sm = _nne_inputs(rng)
    neg = -np.abs(score)
    for s in (score, neg):
        js, je, juv = jnp.asarray(s), jnp.asarray(embed), jnp.asarray(uv)
        ts, te, tuv = T(s), T(embed), T(uv)
        np.testing.assert_array_equal(
            tnne.infer_labels(ts, te).numpy(),
            np.asarray(jnne.infer_labels(js, je)))
        np.testing.assert_array_equal(
            tnne.infer_labels(ts, te, tuv).numpy(),
            np.asarray(jnne.infer_labels(js, je, juv)))
        pix = rng.rand(*s.shape[:-1]) < 0.5
        np.testing.assert_array_equal(
            tnne.infer_labels_stitched(ts, te, tuv, T(pix)).numpy(),
            np.asarray(jnne.infer_labels_stitched(js, je, juv,
                                                  jnp.asarray(pix))))
        np.testing.assert_array_equal(
            tnne.infer_labels_szn(ts, T(sm), te, tuv).numpy(),
            np.asarray(jnne.infer_labels_szn(js, jnp.asarray(sm), je, juv)))


def test_prepare_images_exact(rng):
    raw = rng.randint(0, 256, (2, 9, 11, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        ttf.prepare_images(T(raw)).numpy(),
        np.asarray(jtf.prepare_images(jnp.asarray(raw))))
    f = rng.randn(1, 4, 4, 3).astype(np.float32)
    np.testing.assert_array_equal(ttf.prepare_images(T(f)).numpy(), f)
    np.testing.assert_array_equal(ttf.transform_image(raw[0]),
                                  jtf.transform_image(raw[0]))
    np.testing.assert_array_equal(ttf.MEAN_BGR, jtf.MEAN_BGR)


def test_host_copies_match():
    """The port's own copies of JAX-free host helpers agree with the JAX
    package's: unseen masks, class names, bundled embeddings."""
    np.testing.assert_array_equal(tmetrics.unseen_mask_vector(21, [1, 13]),
                                  jmetrics.unseen_mask_vector(21, [1, 13]))
    np.testing.assert_array_equal(tmetrics.unseen_mask_vector(5, []),
                                  jmetrics.unseen_mask_vector(5, []))
    assert tassets.PASCAL_CLASS_NAMES == jassets.PASCAL_CLASS_NAMES
    assert tassets.CONTEXT_CLASS_NAMES == jassets.CONTEXT_CLASS_NAMES
    assert tassets.CONTEXT59_CLASS_NAMES == jassets.CONTEXT59_CLASS_NAMES
    for dataset, dim, one_hot in (("pascal", 20, False),
                                  ("pascal", 21, True),
                                  ("context", 50, False)):
        np.testing.assert_array_equal(
            tassets.load_class_embeddings(dataset, dim, one_hot=one_hot),
            jassets.load_class_embeddings(dataset, dim, one_hot=one_hot))
