"""Dataset acquisition (the JAX package's data/download.py; reference
pascal_dataset.py:156-182, context_dataset.py:161-186).

Downloads the SBD / VOC2012 / PASCAL-Context label archives into
``data_dir/{pascal,context}``, once per archive: a marker directory already
there skips its fetch, so pre-provisioned data (a machine without network)
is never touched. Never calls ``os.chdir``. Archive members that would land
outside the destination (``../`` or absolute paths; two mirrors are plain
http) are refused.
"""

from __future__ import annotations

import os
import os.path as osp
import tarfile
import urllib.request

SBD_URL = ("http://www.eecs.berkeley.edu/Research/Projects/CS/vision/"
           "grouping/semantic_contours/benchmark.tgz")
VOC2012_URL = ("http://host.robots.ox.ac.uk/pascal/VOC/voc2012/"
               "VOCtrainval_11-May-2012.tar")
CONTEXT_LABELS_URL = ("https://cs.stanford.edu/~roozbeh/pascal-context/"
                      "33_context_labels.tar.gz")


def _fetch_and_untar(url: str, dest_dir: str, marker: str) -> None:
    if osp.exists(osp.join(dest_dir, marker)):
        return
    os.makedirs(dest_dir, exist_ok=True)
    archive = osp.join(dest_dir, osp.basename(url))
    urllib.request.urlretrieve(url, archive)
    with tarfile.open(archive) as tar:
        try:
            # Python 3.12+ (and backports) refuse escaping members here
            tar.extractall(dest_dir, filter="data")
        except TypeError:  # no extraction filters: vet member paths
            base = osp.realpath(dest_dir)
            for m in tar.getmembers():
                target = osp.realpath(osp.join(dest_dir, m.name))
                if not (target == base or target.startswith(base + os.sep)):
                    raise RuntimeError(
                        f"archive member escapes dest_dir: {m.name!r}")
            tar.extractall(dest_dir)
    os.remove(archive)


def download_pascal(data_dir: str) -> None:
    pascal_dir = osp.join(data_dir, "pascal")
    _fetch_and_untar(SBD_URL, pascal_dir, "benchmark_RELEASE")
    _fetch_and_untar(VOC2012_URL, pascal_dir, osp.join("VOCdevkit", "VOC2012"))


def download_context(data_dir: str) -> None:
    _fetch_and_untar(CONTEXT_LABELS_URL, osp.join(data_dir, "context"),
                     "33_context_labels")
    _fetch_and_untar(VOC2012_URL, osp.join(data_dir, "pascal"),
                     osp.join("VOCdevkit", "VOC2012"))
