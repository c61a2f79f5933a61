"""Pretrained-weight acquisition (the JAX package's models/pretrained.py;
reference models.py:195-210).

The reference fetches a caffe-converted torchvision VGG16 state dict through
``fcn.data.cached_download`` (URL + md5). This does the same without the
``fcn`` dependency: download once into ``data_dir/models/``, check the md5,
reuse the cached file afterwards. On a machine without network, place the
file at that path and no download is tried.

    path = cached_download_vgg16(data_dir)
    state = load_vgg16_into_params(model.state_dict(), path)  # vgg_import
"""

from __future__ import annotations

import hashlib
import os
import os.path as osp
import urllib.request

# reference models.py:205-210 (caffe-converted VGG16, torchvision layout)
VGG16_URL = "http://drive.google.com/uc?id=0B9P1L--7Wd2vLTJZMXpIRkVVRFk"
VGG16_MD5 = "aa75b158f4181e7f6230029eb96c1b13"


def md5sum(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for b in iter(lambda: f.read(chunk), b""):
            h.update(b)
    return h.hexdigest()


def cached_download(url: str, path: str, md5: str | None = None) -> str:
    """Download `url` to `path` unless a file with the right md5 exists
    there; a file with another md5 raises. The download lands under a
    temporary name and is renamed only after its md5 checks out."""
    if osp.exists(path):
        if md5 is None or md5sum(path) == md5:
            return path
        raise IOError(f"{path} exists but md5 mismatch (expected {md5})")
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    tmp = path + ".part"
    urllib.request.urlretrieve(url, tmp)
    if md5 is not None and md5sum(tmp) != md5:
        os.remove(tmp)
        raise IOError(f"downloaded {url} failed md5 check")
    os.replace(tmp, path)
    return path


def cached_download_vgg16(data_dir: str) -> str:
    return cached_download(
        VGG16_URL, osp.join(data_dir, "models", "vgg16_from_caffe.pth"),
        VGG16_MD5)
