"""The port's context-59 label tool (scripts/torch_make_context59_labels.py)
and its PNG writer (`utils/png.py`), on the CPU.

Same fixtures through the port's tool and the JAX package's
scripts/make_context59_labels.py: equal pixels with both outputs decoded
(Pillow and the port's native decoder). Each refusal of the JAX tool
(missing name, raw id beyond the LabelMap range, a missing `--mat-key`, an
out-of-range raw id in a `.mat`, no `.mat` at all); the PNG writer
round-tripping through `NativeLoader.decode_label` and Pillow; the output
read by `PascalContext(n_classes=59)`; and the tool run with neither JAX
nor Pillow importable.
"""

import importlib.util
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import PIL.Image
import pytest
import scipy.io

from zeroshotsemanticsegmentation_tpu_torch.data.assets import (
    CONTEXT59_CLASS_NAMES)
from zeroshotsemanticsegmentation_tpu_torch.data.context import PascalContext
from zeroshotsemanticsegmentation_tpu_torch.data.native import NativeLoader
from zeroshotsemanticsegmentation_tpu_torch.utils.png import (
    encode_gray8, write_gray8)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, osp.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tool = _script("torch_make_context59_labels")
jax_tool = _script("make_context59_labels")


def _native(path, shape, **kw):
    lbl, size = NativeLoader.get().decode_label(str(path), shape, **kw)
    assert tuple(size) == tuple(shape)
    return lbl


@pytest.fixture
def fixtures(tmp_path):
    """labels.txt with the 59 names at scattered raw ids and extras, and
    three uint16 .mat LabelMaps of odd sizes, one compressed."""
    rng = np.random.RandomState(0)
    raw_ids = rng.permutation(np.arange(2, 500))[:59]
    lines = [f"{rid}: {name}" for rid, name in zip(raw_ids,
                                                   CONTEXT59_CLASS_NAMES)]
    lines += ["1: somethingrare", "", "500: anotherextra"]
    labels_txt = tmp_path / "labels.txt"
    labels_txt.write_text("\n".join(lines) + "\n")
    mat_dir = tmp_path / "trainval"
    mat_dir.mkdir()
    pool = np.concatenate([raw_ids, [0, 1, 500, 501 - 1]])
    maps = {}
    for i, (h, w) in enumerate([(10, 12), (37, 23), (64, 5)]):
        raw = pool[rng.randint(0, len(pool), (h, w))].astype(np.uint16)
        raw[0, 0] = raw_ids[10]
        did = f"2008_{i:06d}"
        scipy.io.savemat(mat_dir / f"{did}.mat", {"LabelMap": raw},
                         do_compression=bool(i % 2))
        maps[did] = raw
    (mat_dir / "readme.txt").write_text("not a mat file")
    lut = np.zeros(501, np.int64)
    lut[raw_ids] = np.arange(1, 60)
    return {"labels_txt": str(labels_txt), "mat_dir": str(mat_dir),
            "raw_ids": raw_ids, "maps": maps,
            "want": {d: lut[m] for d, m in maps.items()}}


def test_matches_jax_tool(fixtures, tmp_path):
    out, jout = tmp_path / "port", tmp_path / "jax"
    n = tool.convert(fixtures["labels_txt"], fixtures["mat_dir"], str(out))
    jn = jax_tool.convert(fixtures["labels_txt"], fixtures["mat_dir"],
                          str(jout))
    assert n == jn == 3
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
    for did, want in fixtures["want"].items():
        got_pil = np.asarray(PIL.Image.open(out / f"{did}.png"))
        ref_pil = np.asarray(PIL.Image.open(jout / f"{did}.png"))
        assert got_pil.dtype == np.uint8 and got_pil.shape == want.shape
        np.testing.assert_array_equal(got_pil, ref_pil)
        np.testing.assert_array_equal(got_pil, want)
        got_nat = _native(out / f"{did}.png", want.shape,
                          map255_to_ignore=False)
        ref_nat = _native(jout / f"{did}.png", want.shape,
                          map255_to_ignore=False)
        np.testing.assert_array_equal(got_nat, ref_nat)
        np.testing.assert_array_equal(got_nat, want)
    # the spot values of the JAX package's own converter test
    png = np.asarray(PIL.Image.open(out / "2008_000000.png"))
    assert png[0, 0] == 11


def test_main_cli(fixtures, tmp_path, capsys):
    out = tmp_path / "cli"
    assert tool.main(["--labels-txt", fixtures["labels_txt"], "--mat-dir",
                      fixtures["mat_dir"], "--out-dir", str(out)]) == 0
    assert "wrote 3 59-class label PNGs" in capsys.readouterr().out


@pytest.mark.parametrize("case", ["missing-name", "raw-beyond-range",
                                  "missing-key", "out-of-range-id",
                                  "no-mat", "unparseable"])
def test_refusals_match_jax_tool(fixtures, tmp_path, case):
    lt, md = fixtures["labels_txt"], fixtures["mat_dir"]
    if case == "missing-name":
        with pytest.raises(ValueError, match="missing"):
            tool.build_lut({"aeroplane": 3}, max_raw_id=10)
        with pytest.raises(ValueError, match="missing"):
            jax_tool.build_lut({"aeroplane": 3}, max_raw_id=10)
        return
    if case == "raw-beyond-range":
        names = {n: i + 2 for i, n in enumerate(CONTEXT59_CLASS_NAMES)}
        for t in (tool, jax_tool):
            with pytest.raises(ValueError, match="exceeds LabelMap"):
                t.build_lut(names, max_raw_id=30)
        return
    if case == "unparseable":
        bad = tmp_path / "bad.txt"
        bad.write_text("3: aeroplane\nnot a line\n")
        for t in (tool, jax_tool):
            with pytest.raises(ValueError, match="unparseable"):
                t.parse_labels_txt(str(bad))
        return
    if case == "missing-key":
        kw, err, match = {"mat_key": "Nope"}, KeyError, "Nope"
    elif case == "out-of-range-id":
        scipy.io.savemat(osp.join(md, "2009_000000.mat"),
                         {"LabelMap": np.full((4, 4), 777, np.uint16)})
        kw, err, match = {}, ValueError, "out of labels.txt range"
    else:
        md = str(tmp_path / "empty")
        os.makedirs(md)
        kw, err, match = {}, FileNotFoundError, "no .mat"
    for t, name in ((tool, "port"), (jax_tool, "jax")):
        with pytest.raises(err, match=match):
            t.convert(lt, md, str(tmp_path / name), **kw)


@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (31, 64), (200, 133)])
def test_png_writer_round_trip(tmp_path, shape):
    rng = np.random.RandomState(shape[0])
    values = rng.randint(0, 256, shape).astype(np.uint8)
    values.flat[0] = 255
    path = tmp_path / "x.png"
    write_gray8(str(path), values)
    img = PIL.Image.open(path)
    assert img.mode == "L" and img.size == (shape[1], shape[0])
    np.testing.assert_array_equal(np.asarray(img), values)
    np.testing.assert_array_equal(
        _native(path, shape, map255_to_ignore=False), values)
    got = _native(path, shape, value_offset=-1, map255_to_ignore=True)
    want = values.astype(np.int32) - 1
    want[values == 255] = -1
    np.testing.assert_array_equal(got, want)
    assert path.read_bytes() == encode_gray8(values)


def test_png_writer_refuses():
    with pytest.raises(ValueError, match="uint8"):
        encode_gray8(np.zeros((4, 4), np.int32))
    with pytest.raises(ValueError, match="uint8"):
        encode_gray8(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="one pixel"):
        encode_gray8(np.zeros((0, 4), np.uint8))


def test_pascal_context_reads_output(fixtures, tmp_path):
    root = tmp_path / "data"
    out = root / "context" / "59_context_labels"
    tool.convert(fixtures["labels_txt"], fixtures["mat_dir"], str(out))
    assets = tmp_path / "assets" / "context"
    assets.mkdir(parents=True)
    ids = sorted(fixtures["want"])
    for split in ("train", "val"):
        (assets / f"{split}.txt").write_text("\n".join(ids) + "\n")
    kw = dict(data_dir=str(root), assets_dir=str(tmp_path / "assets"),
              n_classes=59)
    ds = PascalContext("val", **kw)
    assert ds.ids == ids  # no invalid-image drop at 59
    for did in ids:
        want = fixtures["want"][did] - 1  # 1-indexed -> 0-indexed, 0 -> -1
        np.testing.assert_array_equal(ds._scan_label(did), want)
        np.testing.assert_array_equal(ds._load_label(did), want)
    # the presence scan (native) drops the train images holding class 10
    tr = PascalContext("train", val_unseen=[10], use_presence_cache=False,
                       **kw)
    assert tr.ids == [d for d in ids
                      if not (fixtures["want"][d] == 11).any()]


def test_runs_without_jax_or_pillow(fixtures, tmp_path):
    out = tmp_path / "bare"
    script = osp.join(ROOT, "scripts", "torch_make_context59_labels.py")
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'PIL',\n"
        "          'zeroshotsemanticsegmentation_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.argv = ['t', '--labels-txt', {fixtures['labels_txt']!r},\n"
        f"            '--mat-dir', {fixtures['mat_dir']!r},\n"
        f"            '--out-dir', {str(out)!r}]\n"
        "import runpy\n"
        f"runpy.run_path({script!r},\n"
        "               run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    for did, want in fixtures["want"].items():
        np.testing.assert_array_equal(
            np.asarray(PIL.Image.open(out / f"{did}.png")), want)


def test_chip_smoke_context59_phase(tmp_path):
    """chip_smoke.py phase 26 (b) on the CPU: the same checks the card's
    machine runs (the CLI in a fresh process, `convert` with PIL hidden,
    the native decoder and PascalContext on the output)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", osp.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    def require(cond, msg):
        assert cond, msg
    out = cs.context59_checks(str(tmp_path), lambda m: None, require)
    assert out["files"] == len(cs.CONTEXT59_SHAPES)
    assert out["pixels"] == sum(h * w for h, w in cs.CONTEXT59_SHAPES)
    assert out["classes_present"] == 60 and out["pillow_importable"]
