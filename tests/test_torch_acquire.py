"""The port's dataset and VGG16 acquisition (`data/download.py`,
`models/pretrained.py`), as tests/test_pretrained.py holds the JAX
package's: md5, the cached file, a bad md5, idempotent fetches, archives
untarred once, a member that escapes the directory refused; and the train
CLI's calls. `urllib.request.urlretrieve` is replaced by a copy of local
files in every test: no test reaches the network."""

import hashlib
import io
import os.path as osp
import shutil
import tarfile
import urllib.request

import pytest
import torch

from zeroshotsemanticsegmentation_tpu.data import download as j_download
from zeroshotsemanticsegmentation_tpu.models import pretrained as j_pretrained
from zeroshotsemanticsegmentation_tpu_torch.cli import train as cli
from zeroshotsemanticsegmentation_tpu_torch.configs import get_config
from zeroshotsemanticsegmentation_tpu_torch.data import download as dl
from zeroshotsemanticsegmentation_tpu_torch.models import pretrained as pt

torch.set_num_threads(1)


@pytest.fixture
def served(monkeypatch):
    """{url: local file}: urlretrieve copies from it; every URL fetched is
    appended to the returned dict's "fetched" list, an unknown URL
    raises."""
    files = {"fetched": []}

    def retrieve(url, path):
        files["fetched"].append(url)
        if url not in files:
            raise OSError(f"no network in the tests: {url}")
        shutil.copyfile(files[url], path)
        return path, None

    monkeypatch.setattr(urllib.request, "urlretrieve", retrieve)
    return files


def _tar(path, members: dict) -> str:
    """A .tar at `path` holding {name: bytes}."""
    with tarfile.open(path, "w") as tar:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return str(path)


def test_sources_equal_the_jax_packages():
    assert (dl.SBD_URL, dl.VOC2012_URL, dl.CONTEXT_LABELS_URL) == (
        j_download.SBD_URL, j_download.VOC2012_URL,
        j_download.CONTEXT_LABELS_URL)
    assert (pt.VGG16_URL, pt.VGG16_MD5) == (j_pretrained.VGG16_URL,
                                            j_pretrained.VGG16_MD5)


def test_md5sum(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(b"hello world")
    assert pt.md5sum(str(p)) == "5eb63bbbe01eeed093cb22bb8f5acdc3"
    p.write_bytes(b"x" * (3 << 20))  # several read chunks
    assert pt.md5sum(str(p), chunk=1 << 20) == \
        hashlib.md5(b"x" * (3 << 20)).hexdigest()


def test_cached_download_uses_existing_file(tmp_path, served):
    target = tmp_path / "weights.pth"
    target.write_bytes(b"cached")
    out = pt.cached_download("http://example.invalid/w.pth", str(target),
                             md5=pt.md5sum(str(target)))
    assert out == str(target) and served["fetched"] == []


def test_cached_download_md5_mismatch_raises(tmp_path, served):
    target = tmp_path / "weights.pth"
    target.write_bytes(b"corrupted")
    with pytest.raises(IOError, match="md5 mismatch"):
        pt.cached_download("http://example.invalid/w.pth", str(target),
                           md5="0" * 32)
    assert served["fetched"] == []


def test_cached_download_fetches_and_verifies(tmp_path, served):
    src = tmp_path / "src.bin"
    src.write_bytes(b"fresh weights")
    served["http://example.invalid/w.pth"] = str(src)
    served["http://example.invalid/w2.pth"] = str(src)
    target = str(tmp_path / "sub" / "w.pth")
    out = pt.cached_download("http://example.invalid/w.pth", target,
                             md5=hashlib.md5(b"fresh weights").hexdigest())
    assert out == target and open(target, "rb").read() == b"fresh weights"
    with pytest.raises(IOError, match="failed md5"):
        pt.cached_download("http://example.invalid/w2.pth",
                           str(tmp_path / "bad.pth"), md5="1" * 32)
    assert not osp.exists(tmp_path / "bad.pth")
    assert not osp.exists(tmp_path / "bad.pth.part")


def test_vgg16_lands_in_the_data_dir_once(tmp_path, served, monkeypatch):
    src = tmp_path / "vgg.pth"
    torch.save({"features.0.weight": torch.ones(2)}, src)
    served[pt.VGG16_URL] = str(src)
    monkeypatch.setattr(pt, "VGG16_MD5", pt.md5sum(str(src)))
    data = tmp_path / "data"
    path = pt.cached_download_vgg16(str(data))
    assert path == str(data / "models" / "vgg16_from_caffe.pth")
    assert pt.cached_download_vgg16(str(data)) == path
    assert served["fetched"] == [pt.VGG16_URL]


def test_dataset_download_idempotent(tmp_path, served):
    """Existing markers skip every fetch."""
    (tmp_path / "pascal" / "benchmark_RELEASE").mkdir(parents=True)
    (tmp_path / "pascal" / "VOCdevkit" / "VOC2012").mkdir(parents=True)
    (tmp_path / "context" / "33_context_labels").mkdir(parents=True)
    dl.download_pascal(str(tmp_path))
    dl.download_context(str(tmp_path))
    assert served["fetched"] == []


def test_archives_are_fetched_and_untarred_once(tmp_path, served):
    src = tmp_path / "src"
    src.mkdir()
    served[dl.SBD_URL] = _tar(src / "benchmark.tgz", {
        "benchmark_RELEASE/dataset/train.txt": b"2008_000002\n"})
    served[dl.VOC2012_URL] = _tar(src / "voc.tar", {
        "VOCdevkit/VOC2012/ImageSets/Segmentation/val.txt": b"a\n"})
    served[dl.CONTEXT_LABELS_URL] = _tar(src / "ctx.tar.gz", {
        "33_context_labels/2008_000002.png": b"png"})
    data = tmp_path / "data"
    dl.download_pascal(str(data))
    dl.download_context(str(data))  # VOC2012 is there: one more archive
    assert served["fetched"] == [dl.SBD_URL, dl.VOC2012_URL,
                                 dl.CONTEXT_LABELS_URL]
    assert (data / "pascal" / "benchmark_RELEASE" / "dataset" /
            "train.txt").read_bytes() == b"2008_000002\n"
    assert (data / "context" / "33_context_labels" /
            "2008_000002.png").exists()
    # the archives are removed after extraction; a second call fetches none
    assert not (data / "pascal" / "benchmark.tgz").exists()
    dl.download_pascal(str(data))
    dl.download_context(str(data))
    assert len(served["fetched"]) == 3


def test_a_member_that_escapes_the_directory_is_refused(tmp_path, served):
    src = tmp_path / "src"
    src.mkdir()
    served[dl.SBD_URL] = _tar(src / "evil.tar", {
        "benchmark_RELEASE/ok.txt": b"ok", "../escaped.txt": b"evil"})
    with pytest.raises((tarfile.FilterError, RuntimeError)):
        dl.download_pascal(str(tmp_path / "data"))
    assert not (tmp_path / "escaped.txt").exists()
    assert not (tmp_path / "data" / "escaped.txt").exists()


def test_train_cli_fetches_the_datasets_and_goes_on_when_it_fails(
        tmp_path, served, capfd):
    """A real-data run fetches the missing archives at startup; the failed
    fetch logs the JAX CLI's warning, pointing at the README, and the
    dataset constructor then raises its own error."""
    cfg = get_config(14, channel_scale=1 / 32, bucket=(64, 64), num_viz=0)
    with pytest.raises(OSError):
        cli.run_experiment(cfg, data_dir=str(tmp_path), device="cpu")
    out = capfd.readouterr().out
    assert served["fetched"] == [dl.SBD_URL]
    assert "WARNING: dataset auto-download failed" in out
    assert "README.md" in out and "egress_runbook" not in out
