"""The port's data layer vs the JAX package's: transforms, the datasets on
tiny VOC/SBD/Context trees written here (JPEG, PNG, .mat), and
`BatchLoader` batches byte for byte (the JAX loader on its Python decode
path, `use_native=False`)."""

import numpy as np
import PIL.Image
import pytest
import torch

from zeroshotsemanticsegmentation_tpu import data as jd
from zeroshotsemanticsegmentation_tpu_torch import data as pd

torch.set_num_threads(1)


def _batches(loader, epoch):
    loader.set_epoch(epoch)
    return list(loader)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in ("image", "label", "sizes"):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            assert g[k].tobytes() == w[k].tobytes(), k
        assert g["ids"] == w["ids"] and g["num_real"] == w["num_real"]


@pytest.mark.parametrize("n,bs,shuffle,compact,drop", [
    (7, 3, False, False, False),   # ragged tail: one real sample + dummies
    (7, 3, True, True, False),
    (7, 3, True, False, True),     # drop_remainder
    (8, 4, True, True, True),
    (5, 2, False, True, False),
], ids=["plain-tail", "shuffle-compact-tail", "shuffle-drop",
        "shuffle-compact-even", "compact-tail"])
def test_synthetic_batches_equal_jax(n, bs, shuffle, compact, drop):
    kw = dict(num_classes=21, size_range=(20, 40), seed=3)
    bucket = (48, 40)
    jl = jd.BatchLoader(jd.SyntheticDataset(n, **kw), bs, bucket_hw=bucket,
                        shuffle=shuffle, seed=11, drop_remainder=drop,
                        use_native=False, compact=compact, num_threads=2)
    pl = pd.BatchLoader(pd.SyntheticDataset(n, **kw), bs, bucket_hw=bucket,
                        shuffle=shuffle, seed=11, drop_remainder=drop,
                        compact=compact, num_threads=2)
    assert len(pl) == len(jl)
    for epoch in (0, 1):
        got, want = _batches(pl, epoch), _batches(jl, epoch)
        _assert_batches_equal(got, want)
        last = got[-1]
        if not drop and n % bs:
            assert last["num_real"] == n % bs
            assert (last["label"][n % bs:] == -1).all()
            assert last["ids"][n % bs:] == [""] * (bs - n % bs)
    if shuffle:
        assert [b["ids"] for b in _batches(pl, 0)] != \
            [b["ids"] for b in _batches(pl, 1)]


def test_transforms_equal_jax(rng):
    img = rng.randint(0, 256, (17, 23, 3)).astype(np.uint8)
    lbl = rng.randint(-1, 21, (17, 23)).astype(np.int32)
    t = pd.transform_image(img)
    np.testing.assert_array_equal(t, jd.transform_image(img))
    np.testing.assert_array_equal(pd.untransform_image(t),
                                  jd.untransform_image(t))
    np.testing.assert_array_equal(pd.untransform_image(t), img)
    for a, b in zip(pd.pad_to_bucket(t, lbl, (32, 24)),
                    jd.pad_to_bucket(t, lbl, (32, 24))):
        assert a.tobytes() == b.tobytes() and a.dtype == b.dtype
    from zeroshotsemanticsegmentation_tpu.data.transforms import (
        batch_image_rgb as jrgb)
    from zeroshotsemanticsegmentation_tpu_torch.data.transforms import (
        DEFAULT_BUCKET, batch_image_rgb)
    assert DEFAULT_BUCKET == jd.transforms.DEFAULT_BUCKET
    for x in (img, t):
        np.testing.assert_array_equal(batch_image_rgb(x), jrgb(x))
    with pytest.raises(ValueError):
        pd.pad_to_bucket(t, lbl, (16, 24))


def test_split_ids_and_class_names_equal_jax():
    for ds in ("pascal", "context"):
        for split in ("train", "train_seen", "val"):
            assert pd.load_split_ids(ds, split) == jd.load_split_ids(ds, split)
    for ds, n in (("pascal", None), ("context", 33), ("context", 59)):
        assert pd.class_names(ds, n) == jd.class_names(ds, n)


# ---------------------------------------------------- dataset fixtures

PASCAL_CONTENT = {"img_a": [0, 1], "img_b": [0, 13], "img_c": [0, 2, 255],
                  "img_d": [0, 17], "img_e": [0, 6]}


def _write_label_png(path, lbl):
    PIL.Image.fromarray(lbl.astype(np.uint8), mode="L").save(path)


def _pascal_tree(root, assets):
    import scipy.io
    sbd = root / "pascal" / "benchmark_RELEASE" / "dataset"
    voc = root / "pascal" / "VOCdevkit" / "VOC2012"
    for d in (sbd / "img", sbd / "cls", voc / "JPEGImages",
              voc / "SegmentationClass"):
        d.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    for did, content in PASCAL_CONTENT.items():
        h, w = int(rng.randint(20, 40)), int(rng.randint(20, 40))
        img = rng.randint(0, 255, size=(h, w, 3)).astype(np.uint8)
        lbl = np.zeros((h, w), np.int32)
        for j, c in enumerate(content):
            lbl[:, j::len(content)] = c
        PIL.Image.fromarray(img).save(sbd / "img" / f"{did}.jpg")
        PIL.Image.fromarray(img[::-1]).save(voc / "JPEGImages" / f"{did}.jpg")
        scipy.io.savemat(sbd / "cls" / f"{did}.mat",
                         {"GTcls": {"Segmentation": lbl.astype(np.uint8)}})
        _write_label_png(voc / "SegmentationClass" / f"{did}.png", lbl[::-1])
    (assets / "pascal").mkdir(parents=True, exist_ok=True)
    for split in ("train", "val"):
        (assets / "pascal" / f"{split}.txt").write_text(
            "\n".join(PASCAL_CONTENT) + "\n")


def _context_tree(root, assets, n_classes):
    voc = root / "pascal" / "VOCdevkit" / "VOC2012" / "JPEGImages"
    ctx = root / "context" / f"{n_classes}_context_labels"
    voc.mkdir(parents=True, exist_ok=True)
    ctx.mkdir(parents=True, exist_ok=True)
    content = {"c1": [1, 5], "c2": [0, 3], "c3": [2, 17], "c4": [7, 33]}
    rng = np.random.RandomState(1)
    for did, vals in content.items():
        img = rng.randint(0, 255, size=(24, 30, 3)).astype(np.uint8)
        PIL.Image.fromarray(img).save(voc / f"{did}.jpg")
        lbl = np.zeros((24, 30), np.int32)
        for j, c in enumerate(vals):
            lbl[:, j::len(vals)] = c
        _write_label_png(ctx / f"{did}.png", lbl)
    (assets / "context").mkdir(parents=True, exist_ok=True)
    for split in ("train", "val"):
        (assets / "context" / f"{split}.txt").write_text(
            "\n".join(content) + "\n")


@pytest.mark.parametrize("split", ["train", "train_seen", "val"])
@pytest.mark.parametrize("compact", [False, True])
def test_pascal_batches_equal_jax(tmp_path, split, compact):
    _pascal_tree(tmp_path / "data", tmp_path / "assets")
    kw = dict(data_dir=str(tmp_path / "data"),
              assets_dir=str(tmp_path / "assets"),
              train_unseen=[1], val_unseen=[13], use_presence_cache=False)
    jds, pds = jd.PascalVOC(split, **kw), pd.PascalVOC(split, **kw)
    assert pds.ids == jds.ids and len(pds) > 0
    for i in range(len(pds)):
        g, w = pds[i], jds[i]
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])
        assert g["id"] == w["id"] and g["size"] == w["size"]
    lkw = dict(bucket_hw=(48, 48), shuffle=True, seed=5, compact=compact)
    _assert_batches_equal(
        list(pd.BatchLoader(pds, 2, **lkw)),
        list(jd.BatchLoader(jds, 2, use_native=False, **lkw)))


@pytest.mark.parametrize("n_classes", [33, 59])
def test_context_batches_equal_jax(tmp_path, n_classes):
    _context_tree(tmp_path / "data", tmp_path / "assets", n_classes)
    kw = dict(data_dir=str(tmp_path / "data"),
              assets_dir=str(tmp_path / "assets"), n_classes=n_classes,
              val_unseen=[16], use_presence_cache=False)
    for split in ("train", "val"):
        jds, pds = jd.PascalContext(split, **kw), \
            pd.PascalContext(split, **kw)
        assert pds.ids == jds.ids
        _assert_batches_equal(
            list(pd.BatchLoader(pds, 3, bucket_hw=(32, 32))),
            list(jd.BatchLoader(jds, 3, bucket_hw=(32, 32),
                                use_native=False)))


def test_loader_refusals():
    ds = pd.SyntheticDataset(4, size_range=(8, 8))
    # the native decoder needs a dataset with native_label_kwargs
    with pytest.raises(RuntimeError, match="native_label_kwargs"):
        pd.BatchLoader(ds, 2, use_native=True)
    pd.BatchLoader(ds, 2, compact=True)
    with pytest.raises(ValueError, match="compact"):
        pd.BatchLoader(ds, 2, compact=False)

    class Wide:
        raw_images = False

        def __len__(self):
            return 1

        def __getitem__(self, i):
            return {"image": np.zeros((4, 4, 3), np.uint8),
                    "label": np.full((4, 4), 200, np.int32), "id": "w",
                    "size": (4, 4)}

    with pytest.raises(ValueError, match="int8"):
        list(pd.BatchLoader(Wide(), 1, bucket_hw=(8, 8), compact=True))

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise OSError("decode exploded")

    with pytest.raises(OSError, match="decode exploded"):
        list(pd.BatchLoader(Broken(), 2, bucket_hw=(8, 8)))


def test_abandoned_iterator_stops_its_producer():
    import threading
    before = threading.active_count()
    loader = pd.BatchLoader(pd.SyntheticDataset(64, size_range=(8, 8)), 1,
                            bucket_hw=(8, 8), prefetch=1)
    it = iter(loader)
    next(it)
    it.close()
    for _ in range(100):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before
