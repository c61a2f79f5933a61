"""The port's native decoder (csrc/zss_loader.cc, data/native.py) against
the JAX package's (native/libzss_loader.so through its own binding) on the
same files: float and compact images, PNG and MAT labels, batches, error
codes; the port's `BatchLoader` on it vs the JAX loader's native batches and
the port's Python path; the native presence scan vs the PIL/scipy one; the
train CLI on a VOC-layout tree vs the JAX CLI; the committed JPEG
fixtures vs their script."""

import importlib.util
import os
import os.path as osp
import threading

import numpy as np
import PIL.Image
import pytest
import scipy.io
import torch

from tests.test_torch_pipeline import (
    _assert_batches_equal, _context_tree, _pascal_tree)
from zeroshotsemanticsegmentation_tpu import data as jd
from zeroshotsemanticsegmentation_tpu.data.native import (
    NativeLoader as JaxNativeLoader)
from zeroshotsemanticsegmentation_tpu_torch import data as pd
from zeroshotsemanticsegmentation_tpu_torch.data import native
from zeroshotsemanticsegmentation_tpu_torch.data.transforms import (
    transform_image)
from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels

torch.set_num_threads(1)

_ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_make_decode_fixtures",
    osp.join(_ROOT, "scripts", "torch_make_decode_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)


@pytest.fixture(scope="module")
def nl():
    return native.NativeLoader.get()


@pytest.fixture(scope="module")
def jl():
    loader = JaxNativeLoader.get()
    assert loader is not None, "the JAX package's libzss_loader.so"
    return loader


@pytest.fixture
def files(tmp_path):
    rng = np.random.RandomState(1337)
    img = rng.randint(0, 255, size=(37, 53, 3)).astype(np.uint8)
    img_path = str(tmp_path / "img.jpg")
    PIL.Image.fromarray(img).save(img_path, quality=95)
    lbl = rng.randint(0, 21, size=(37, 53)).astype(np.uint8)
    lbl[::7, ::5] = 255
    lbl_path = str(tmp_path / "lbl.png")
    PIL.Image.fromarray(lbl, mode="L").save(lbl_path)
    return img_path, lbl_path, lbl


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def test_decode_image_equals_jax_and_pil(nl, jl, files):
    img_path, _, _ = files
    got, size = nl.decode_image(img_path, (64, 64))
    want, jsize = jl.decode_image(img_path, (64, 64))
    assert size == jsize == (37, 53) and _same(got, want)
    decoded = np.asarray(PIL.Image.open(img_path).convert("RGB"), np.uint8)
    # the same libjpeg-turbo decode and transform as Pillow's here
    assert _same(got[:37, :53], transform_image(decoded))
    assert (got[37:] == 0).all() and (got[:, 53:] == 0).all()


# (depth, palette, interlace) of the PNG labels written by the fixtures
# script's stdlib writer: every filter, 1/2/4/8-bit gray and palette, Adam7
PNG_CASES = [(8, False, False), (8, True, False), (1, False, False),
             (2, False, False), (4, False, False), (1, True, False),
             (2, True, False), (4, True, False), (8, False, True),
             (4, True, True), (1, False, True)]


@pytest.mark.parametrize("depth,palette,interlace", PNG_CASES,
                         ids=lambda v: str(v))
def test_png_labels_equal_jax(nl, jl, tmp_path, depth, palette, interlace):
    n_values = min(2 ** depth, 21)
    lbl = fx.label_array(depth * 10 + palette, 45, 61, n_values,
                         boundary=255 if depth == 8 else n_values - 1)
    path = str(tmp_path / "l.png")
    fx.write_png(path, lbl, depth=depth, palette=palette,
                 interlace=interlace, seed=depth)
    values = fx.png_values(lbl, depth, palette)
    for kw in ({"map255_to_ignore": True},
               {"value_offset": -1, "map255_to_ignore": False}):
        got, size = nl.decode_label(path, (64, 72), **kw)
        want, jsize = jl.decode_label(path, (64, 72), **kw)
        assert size == jsize == (45, 61) and _same(got, want)
        exp = values + kw.get("value_offset", 0)
        if kw["map255_to_ignore"]:
            exp = np.where(values == 255, -1, exp)
        np.testing.assert_array_equal(got[:45, :61], exp)
        assert (got[45:] == -1).all() and (got[:, 61:] == -1).all()


@pytest.mark.parametrize("depth,interlace", [(8, False), (8, True),
                                              (2, False)])
def test_png_noise_equals_jax(nl, jl, tmp_path, depth, interlace):
    """Uniform noise: every filter's predictor sees unequal neighbours
    (flat label regions hide the Paeth tie rule)."""
    vals = np.random.RandomState(depth).randint(0, 2 ** depth, (53, 47))
    path = str(tmp_path / "noise.png")
    fx.write_png(path, vals, depth=depth, interlace=interlace, seed=9)
    got, size = nl.decode_label(path, (64, 64), map255_to_ignore=False)
    want, _ = jl.decode_label(path, (64, 64), map255_to_ignore=False)
    assert size == (53, 47) and _same(got, want)
    np.testing.assert_array_equal(got[:53, :47],
                                  fx.png_values(vals, depth, False))


@pytest.mark.parametrize("mode", ["L", "P"])
def test_pil_png_labels_equal_jax(nl, jl, tmp_path, mode):
    lbl = np.random.RandomState(3).randint(0, 21, (20, 33)).astype(np.uint8)
    im = PIL.Image.fromarray(lbl, mode=mode)
    if mode == "P":
        im.putpalette([c for i in range(256) for c in (i, 0, 255 - i)])
    path = str(tmp_path / "pil.png")
    im.save(path)
    got, _ = nl.decode_label(path, (20, 33))
    want, _ = jl.decode_label(path, (20, 33))
    assert _same(got, want)
    np.testing.assert_array_equal(got, np.asarray(PIL.Image.open(path),
                                                  np.int32))


@pytest.mark.parametrize("compress", [False, True])
def test_mat_labels_equal_jax_and_scipy(nl, jl, tmp_path, compress):
    lbl = fx.label_array(7, 37, 53)
    path = str(tmp_path / f"l{int(compress)}.mat")
    scipy.io.savemat(path, {"GTcls": {
        "Segmentation": lbl, "CategoriesPresent": np.unique(lbl)}},
        do_compression=compress)
    got, size = nl.decode_label(path, (64, 64))
    want, jsize = jl.decode_label(path, (64, 64))
    assert size == jsize == (37, 53) and _same(got, want)
    exp = scipy.io.loadmat(path)["GTcls"][0]["Segmentation"][0].astype(
        np.int32)
    exp[exp == 255] = -1
    np.testing.assert_array_equal(got[:37, :53], exp)


@pytest.mark.parametrize("compact", [False, True])
def test_load_batch_equals_jax(nl, jl, files, tmp_path, compact):
    img_path, lbl_path, _ = files
    mat = str(tmp_path / "l.mat")
    scipy.io.savemat(mat, {"GTcls": {"Segmentation": fx.label_array(
        1, 37, 53)}}, do_compression=True)
    imgs = [img_path] * 7
    lbls = [lbl_path, mat, None, lbl_path, mat, lbl_path, None]
    got = nl.load_batch(imgs, lbls, (40, 56), num_threads=3,
                        compact=compact)
    want = jl.load_batch(imgs, lbls, (40, 56), num_threads=3,
                         compact=compact)
    for g, w in zip(got, want):
        assert _same(g, w)
    # into caller-owned rows: the same bytes
    bufs = tuple(np.full_like(a, 7) for a in got)
    out = nl.load_batch(imgs, lbls, (40, 56), num_threads=8,
                        compact=compact, out=bufs)
    assert all(o is b for o, b in zip(out, bufs))
    for g, b in zip(got, bufs):
        assert _same(g, b)
    with pytest.raises(ValueError, match="C-contiguous"):
        nl.load_batch(imgs, lbls, (40, 56), compact=compact,
                      out=(bufs[0][:, ::2], bufs[1], bufs[2]))


def _corrupt_files(tmp, img_path, lbl_path):
    """name -> (path, kind): files the decoders must refuse (or, for a
    truncated JPEG, may partly decode) without crashing."""
    png = open(lbl_path, "rb").read()
    out = {}

    def put(name, data, kind="label"):
        p = str(tmp / name)
        with open(p, "wb") as f:
            f.write(data)
        out[name] = (p, kind)

    put("sig_only.png", b"\x89PNG\r\n\x1a\n" + b"\x00" * 40)
    bad_crc = bytearray(png)
    bad_crc[30] ^= 0xff  # inside IHDR's data: its CRC no longer holds
    put("bad_crc.png", bytes(bad_crc))
    put("short_idat.png", png[:len(png) - 40])
    put("bad_sig.png", b"\x89PX" + png[3:])
    lbl = fx.label_array(3, 9, 11)
    for name, kw in (("gray16.png", {}), ("rgb.png", {})):
        fx.write_png(str(tmp / name), lbl, **kw)
    raw = bytearray(open(tmp / "gray16.png", "rb").read())
    raw[24] = 16  # bit depth 16 (the CRC is rewritten below)
    raw[25:26] = b"\x00"
    import struct
    import zlib
    raw[29:33] = struct.pack(">I", zlib.crc32(bytes(raw[12:29])))
    put("gray16.png", bytes(raw))
    raw[24], raw[25] = 8, 2  # RGB
    raw[29:33] = struct.pack(">I", zlib.crc32(bytes(raw[12:29])))
    put("rgb.png", bytes(raw))
    header = b"MATLAB 5.0 MAT-file" + b" " * (124 - 19) + b"\x00\x01" + b"IM"
    put("garbage.mat", header + b"\xff" * 64)
    scipy.io.savemat(str(tmp / "noseg.mat"), {"GTcls": {"Boundaries": lbl}})
    out["noseg.mat"] = (str(tmp / "noseg.mat"), "label")
    put("unknown.lbl", b"GIF89a" + b"\x00" * 40)
    big = fx.label_array(4, 70, 20)
    fx.write_png(str(tmp / "big.png"), big)
    out["big.png"] = (str(tmp / "big.png"), "label")
    wide = np.full((8, 8), 300, np.uint16)
    scipy.io.savemat(str(tmp / "wide.mat"), {"GTcls": {"Segmentation": wide}})
    out["wide.mat"] = (str(tmp / "wide.mat"), "label")
    jpg = open(img_path, "rb").read()
    put("truncated.jpg", jpg[:len(jpg) // 4], "image")
    put("not_a.jpg", b"\xff\xd8" + b"\x00" * 64, "image")
    out["missing.jpg"] = (str(tmp / "missing.jpg"), "image")
    out["missing.png"] = (str(tmp / "missing.png"), "label")
    return out


CORRUPT = ["sig_only.png", "bad_crc.png", "short_idat.png", "bad_sig.png",
           "gray16.png", "rgb.png", "garbage.mat", "noseg.mat",
           "unknown.lbl", "big.png", "wide.mat", "truncated.jpg",
           "not_a.jpg", "missing.jpg", "missing.png"]


@pytest.mark.parametrize("name", CORRUPT)
def test_error_codes_equal_jax(nl, jl, files, tmp_path, name):
    img_path, lbl_path, _ = files
    path, kind = _corrupt_files(tmp_path, img_path, lbl_path)[name]

    def rc_of(loader, *args, **kw):
        try:
            loader(*args, **kw)
            return 0
        except IOError as e:
            return int(str(e).rsplit("rc=", 1)[1])

    if kind == "image":
        single = [rc_of(n.decode_image, path, (64, 64)) for n in (nl, jl)]
        pair = ([path], [lbl_path])
    else:
        single = [rc_of(n.decode_label, path, (40, 64)) for n in (nl, jl)]
        pair = ([img_path], [path])
    assert single[0] == single[1]
    for compact in (False, True):
        rcs = [rc_of(n.load_batch, *pair, (40, 64), compact=compact)
               for n in (nl, jl)]
        assert rcs[0] == rcs[1], (compact, rcs)
    if name == "wide.mat":
        assert single[0] == 0 and rcs[0] == -5  # 300 does not fit int8
    elif name != "truncated.jpg":  # libjpeg may recover a partial image
        assert single[0] < 0
    if name == "big.png":
        with pytest.raises(native.DecodeError) as e:
            nl.decode_label(path, (40, 64))
        assert e.value.rc == -2 and e.value.size == (70, 20)


def test_label_list_of_the_wrong_length(nl, files):
    img_path, lbl_path, _ = files
    with pytest.raises(ValueError, match="label_paths"):
        nl.load_batch([img_path, img_path], [lbl_path], (64, 64))


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("compact", [False, True])
def test_pascal_loader_equals_jax_native(tmp_path, split, compact):
    """SBD .mat (train) and VOC PNG (val) labels; five images at B=2: a
    short last batch of one image and one dummy."""
    _pascal_tree(tmp_path / "data", tmp_path / "assets")
    kw = dict(data_dir=str(tmp_path / "data"),
              assets_dir=str(tmp_path / "assets"), val_unseen=[],
              use_presence_cache=False)
    pds, jds = pd.PascalVOC(split, **kw), jd.PascalVOC(split, **kw)
    assert pds.native_label_kwargs() == jds.native_label_kwargs()
    lkw = dict(bucket_hw=(48, 48), shuffle=True, seed=5, compact=compact)
    before = _kernels.launch_counts["native_batches"]
    loader = pd.BatchLoader(pds, 2, **lkw)
    assert loader.decoder == "native" and len(loader) == 3
    got = list(loader)
    assert _kernels.launch_counts["native_batches"] == before + 3
    assert got[-1]["num_real"] == 1 and got[-1]["ids"][1] == ""
    want = list(jd.BatchLoader(jds, 2, use_native=True, **lkw))
    _assert_batches_equal(got, want)
    py = pd.BatchLoader(pd.PascalVOC(split, **kw), 2, use_native=False,
                        **lkw)
    assert py.decoder == "python"
    _assert_batches_equal(got, list(py))


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("n_classes", [33, 59])
def test_context_loader_equals_jax_native(tmp_path, n_classes, compact):
    _context_tree(tmp_path / "data", tmp_path / "assets", n_classes)
    kw = dict(data_dir=str(tmp_path / "data"),
              assets_dir=str(tmp_path / "assets"), n_classes=n_classes,
              val_unseen=[16], use_presence_cache=False)
    for split in ("train", "val"):
        pds, jds = pd.PascalContext(split, **kw), jd.PascalContext(split, **kw)
        assert pds.ids == jds.ids
        lkw = dict(bucket_hw=(32, 32), compact=compact)
        got = list(pd.BatchLoader(pds, 3, **lkw))
        _assert_batches_equal(got, list(jd.BatchLoader(
            jds, 3, use_native=True, **lkw)))
        _assert_batches_equal(got, list(pd.BatchLoader(
            pd.PascalContext(split, **kw), 3, use_native=False, **lkw)))


def test_use_native_choices(tmp_path, monkeypatch):
    _pascal_tree(tmp_path / "data", tmp_path / "assets")
    ds = pd.PascalVOC("val", data_dir=str(tmp_path / "data"),
                      assets_dir=str(tmp_path / "assets"))
    assert pd.BatchLoader(ds, 2, use_native=True).decoder == "native"
    with pytest.raises(RuntimeError, match="native_label_kwargs"):
        pd.BatchLoader(pd.SyntheticDataset(2), 2, use_native=True)
    assert pd.BatchLoader(pd.SyntheticDataset(2), 2).decoder == "python"
    # a failed build raises with the compiler's output, never falls back
    monkeypatch.setattr(native.NativeLoader, "_instance", None)
    monkeypatch.setattr(native, "SOURCE", str(tmp_path / "missing.cc"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(OSError):  # the source cannot be read
        pd.BatchLoader(ds, 2)
    broken = tmp_path / "broken.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(broken))
    with pytest.raises(RuntimeError, match="building the native decoder"):
        pd.BatchLoader(ds, 2)


def test_concurrent_builds(tmp_path, monkeypatch):
    """Threads (as xdist workers are processes) building into one empty
    build directory at once all get a library that loads."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    paths, errors = [], []

    def run():
        try:
            paths.append(native.build())
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(paths)) == 1 and len(paths) == 4
    assert os.listdir(tmp_path / "build") == [osp.basename(paths[0])]
    native.NativeLoader(paths[0]).build_info()


@pytest.mark.parametrize("dataset", ["pascal", "context33", "context59"])
def test_presence_scan_equals_pil(tmp_path, monkeypatch, dataset):
    """The native scan's presence matrix is the PIL/scipy readers'; a
    label larger than the scan's first bucket is read again at its size."""
    data, assets = tmp_path / "data", tmp_path / "assets"
    if dataset == "pascal":
        _pascal_tree(data, assets)
        big = np.zeros((530, 600), np.uint8)
        big[500:, 580:] = 13
        scipy.io.savemat(data / "pascal" / "benchmark_RELEASE" / "dataset"
                         / "cls" / "img_e.mat", {"GTcls": {
                             "Segmentation": big}})
        mk = lambda: pd.PascalVOC(  # noqa: E731
            "train", data_dir=str(data), assets_dir=str(assets),
            val_unseen=[13], use_presence_cache=False)
    else:
        n = int(dataset[-2:])
        _context_tree(data, assets, n)
        mk = lambda: pd.PascalContext(  # noqa: E731
            "val", data_dir=str(data), assets_dir=str(assets), n_classes=n,
            use_presence_cache=False)
    ds = mk()
    ids = ds.ids if dataset != "pascal" else \
        pd.load_split_ids("pascal", "train", assets_dir=str(assets))
    got = ds._presence_matrix(ids, use_cache=False)
    monkeypatch.setattr(type(ds), "_scan_label", type(ds)._load_label)
    want = ds._presence_matrix(ids, use_cache=False)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)
    if dataset == "pascal":
        assert got[ids.index("img_e"), 14] and "img_e" not in ds.ids
        assert mk().ids == ds.ids


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_nvjpeg_host_path_equals_libjpeg(tmp_path, subsampling):
    """The nvJPEG branch's host half (libjpeg's fancy chroma upsampling and
    YCbCr -> RGB over the planes) compiled here against stub CUDA headers
    and run on libjpeg's own planes: the RGB equals libjpeg's bit for bit
    (tests/torch_nvjpeg_host/host_path.cc), odd and tiny sizes included."""
    import subprocess
    here = osp.join(_ROOT, "tests", "torch_nvjpeg_host")
    exe = str(tmp_path / "host_path")
    subprocess.run(["g++", "-O1", "-std=c++17", "-DZSS_JPEG_NVJPEG",
                    f"-I{here}", "-include", native.SOURCE,
                    osp.join(here, "host_path.cc"), "-o", exe, "-ljpeg",
                    "-lz", "-lpthread"], check=True, capture_output=True,
                   timeout=300)
    rng = np.random.default_rng(subsampling)
    paths = []
    for h, w in [(37, 53), (2, 2), (17, 16), (1, 9), (9, 1), (375, 500)]:
        p = str(tmp_path / f"{h}x{w}.jpg")
        PIL.Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            p, quality=90, subsampling=subsampling)
        paths.append(p)
    if subsampling != 1:
        paths += [osp.join(fx.FIXTURE_DIR, f"{n}.jpg") for n in fx.SPECS
                  if fx.SPECS[n][4] == subsampling and fx.SPECS[n][5] == "RGB"]
    proc = subprocess.run([exe, *paths], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("differ=0 max=0") == len(paths)


def test_nvjpeg_pool_threads_bind_the_feed_device(tmp_path):
    """The nvJPEG branch against stub CUDA / nvJPEG entry points that
    record the device of every call (tests/torch_nvjpeg_host/
    device_path.cc): with two ordinals in one process, then the caller's
    current device, every pool thread binds the batch's device before its
    first nvJPEG or stream call, each device gets its own handle and
    contexts, a single-image decode leaves the caller's device alone,
    `zss_build_info` names the last decode's device and an ordinal the
    machine lacks is refused (-8)."""
    import subprocess
    here = osp.join(_ROOT, "tests", "torch_nvjpeg_host")
    exe = str(tmp_path / "device_path")
    subprocess.run(["g++", "-O1", "-std=c++17", "-DZSS_JPEG_NVJPEG",
                    f"-I{here}", "-include", native.SOURCE,
                    osp.join(here, "device_path.cc"), "-o", exe, "-lz",
                    "-lpthread"], check=True, capture_output=True,
                   timeout=300)
    paths = []
    for i in range(9):  # the stub decoder reads any non-empty file
        paths.append(str(tmp_path / f"{i}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(b"\xff\xd8stub")
    proc = subprocess.run([exe, *paths], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("batch of 9 on device") == 6
    assert "violations=0" in proc.stdout


def test_libjpeg_build_ignores_the_device(nl, files, tmp_path):
    """The libjpeg backend takes a device and ignores it; build_info names
    no device. A loader on the CPU has no card to bind."""
    img_path, lbl_path = files[:2]
    want = nl.load_batch([img_path], [lbl_path], (64, 64), compact=True)
    got = nl.load_batch([img_path], [lbl_path], (64, 64), compact=True,
                        device=3)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert nl.build_info()["jpeg"] == "libjpeg"
    assert nl.build_info()["device"] is None
    ds = pd.SyntheticDataset(num_images=2, size_range=(16, 16))
    assert pd.BatchLoader(ds, 2, device="cpu").cuda_ordinal is None


def test_fixtures_match_their_script():
    assert fx.check() == []


@pytest.mark.parametrize("name", sorted(fx.SPECS))
def test_fixture_decodes(nl, jl, name):
    """The committed JPEGs decode here to Pillow's recorded pixels (the
    same libjpeg-turbo), to the JAX library's bytes, and within the
    recorded error of their seeded source."""
    rec = fx.load_record()[name]
    path = osp.join(fx.FIXTURE_DIR, rec["file"])
    h, w = rec["hw"]
    imgs, _, sizes = nl.load_batch([path], [None], (512, 512), compact=True)
    jimgs, _, _ = jl.load_batch([path], [None], (512, 512), compact=True)
    assert _same(imgs, jimgs) and sizes[0].tolist() == [h, w]
    dec = imgs[0, :h, :w]
    assert fx.sha256(dec.tobytes()) == rec["decode_sha256"]
    np.testing.assert_array_equal(dec, fx.libjpeg_decode(name))
    err = np.abs(dec.astype(np.int32) - fx.as_rgb(fx.source_image(name)))
    assert err.max() == rec["decode_max_abs_err"]


def test_train_cli_on_a_voc_tree_equals_jax(tmp_path, monkeypatch, capfd):
    """`run_experiment` through the train CLI on a VOC/SBD-layout tree
    (native decoder), at test widths, against the JAX CLI's run of the
    same command on the same tree (its native decoder too)."""
    import zeroshotsemanticsegmentation_tpu.cli.train as jcli
    import zeroshotsemanticsegmentation_tpu.data.assets as jassets
    import zeroshotsemanticsegmentation_tpu_torch.cli.train as cli
    import zeroshotsemanticsegmentation_tpu_torch.data.assets as passets
    from tests.test_torch_cli import _rows
    data, assets = tmp_path / "data", tmp_path / "assets"
    _pascal_tree(data, assets)
    os.symlink(osp.join(_ROOT, "assets", "pascal", "embeddings"),
               assets / "pascal" / "embeddings")
    monkeypatch.setattr(passets, "_ASSETS_DIR", str(assets))
    monkeypatch.setattr(jassets, "_ASSETS_DIR", str(assets))
    # both CLIs fetch the VGG16 of a fresh real-data run: no test reaches
    # the network, so the fetch fails here and each run warns and goes on
    import urllib.request

    def no_network(url, path):
        raise OSError(f"no network in the tests: {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    # stage 1 alone: random weights may score no IoU on these labels, and
    # then no run writes the `best` that stage 2 starts from
    argv = ["-c", "14", "-ve", "1", "-se", "0", "--bucket", "64",
            "--channel_scale", "0.03125", "-dir", str(data)]
    real = cli.run_experiment
    monkeypatch.setattr(cli, "run_experiment",
                        lambda cfg, **kw: real(cfg.replace(num_viz=0), **kw))
    jreal = jcli.run_experiment
    monkeypatch.setattr(jcli, "run_experiment",
                        lambda cfg, **kw: jreal(cfg.replace(num_viz=0), **kw))
    out = cli.main(argv + ["--device", "cpu", "-n", "port"])
    printed = capfd.readouterr().out
    assert "decoded by the native decoder (zss_loader; JPEG by libjpeg" in \
        printed
    assert "WARNING: VGG16 auto-download failed" in printed
    want = jcli.main(argv + ["-n", "jax"])
    pdir, jdir = out["log_dir"], want["log_dir"]
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    for name in ("counts.csv", "train_log.csv", "val_log.csv"):
        got, exp = _rows(osp.join(pdir, name)), _rows(osp.join(jdir, name))
        assert len(got) == len(exp) and got[0] == exp[0], name
    # the scan: val_unseen 17 and 6 drop img_d and img_e from train,
    # train_unseen 1 and 13 img_a and img_b from train_seen
    assert _rows(osp.join(pdir, "counts.csv")) == \
        _rows(osp.join(jdir, "counts.csv")) == \
        [["train_seen", "train_unseen", "val"], ["1", "2", "5"]]
