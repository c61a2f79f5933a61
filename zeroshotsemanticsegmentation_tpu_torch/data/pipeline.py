"""Batched, prefetched host pipeline feeding static-shape batches (the JAX
package's data/pipeline.py).

The reference's DataLoader(batch_size=1, num_workers=8) over variable-size
images (train.py:81-84) becomes: samples decoded on a thread pool, padded to
one bucket, stacked into (B, H, W, ·) batches and handed over while the
next batch decodes in the background. Partial final batches are padded with
all-ignore dummy samples (label -1 everywhere), so every step sees one shape;
the masked losses and metrics count nothing for them.

Two decoders: the native one (`data/native.py`, C++ on its own thread pool,
the batch written in place; taken by default for every dataset with
`native_label_kwargs`) and the Python one (the dataset's `__getitem__` on a
thread pool: PIL and scipy, or `SyntheticDataset`). The batches are numpy
arrays; the trainers copy them to the card
(`train.trainer_fcn.prefetch_to_device`). With `pin_memory` the native
decoder writes into pinned host tensors, carried in the batch under
"pinned" (the arrays are views of them), which the copy takes as they are.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from zeroshotsemanticsegmentation_tpu_torch import PAD_LABEL
from zeroshotsemanticsegmentation_tpu_torch.data.native import NativeLoader
from zeroshotsemanticsegmentation_tpu_torch.data.transforms import (
    DEFAULT_BUCKET, pad_to_bucket)
from zeroshotsemanticsegmentation_tpu_torch.ops import _kernels

# `native_batches`, the batches the native decoder wrote, counts beside the
# kernels' launches (`_kernels.launch_counts`); the loaders' producer
# threads add to it
_count_lock = threading.Lock()


class BatchLoader:
    """Iterates dict batches: image (B,bh,bw,3) f32, label (B,bh,bw) i32,
    ids (list[str], '' for dummies), sizes (B,2) i32, num_real (int).
    With `compact`, images are uint8 RGB and labels int8 (normalized on the
    device by the steps): 4x fewer host-to-device bytes.

    `use_native`: None takes the native decoder wherever the dataset has
    `native_label_kwargs`, True requires it (RuntimeError for a dataset
    without it), False decodes in Python. A native build that fails
    raises. `decoder` says which one was taken. `pin_memory` (set when the
    loader feeds a card): the native decoder writes each batch into pinned
    host tensors."""

    def __init__(self, dataset, batch_size: int, *,
                 bucket_hw: tuple[int, int] = DEFAULT_BUCKET,
                 shuffle: bool = False, seed: int = 1337,
                 drop_remainder: bool = False,
                 num_threads: int = 4, prefetch: int = 2,
                 use_native: bool | None = None,
                 compact: bool = False, pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.bucket_hw = bucket_hw
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.epoch = 0
        self.compact = compact
        self.pin_memory = pin_memory
        self._native = None
        if use_native and not hasattr(dataset, "native_label_kwargs"):
            raise RuntimeError(
                f"use_native=True but dataset {type(dataset).__name__} has "
                "no native decode support (no native_label_kwargs)")
        if use_native is not False and hasattr(dataset,
                                               "native_label_kwargs"):
            self._native = (NativeLoader.get(),
                            dataset.native_label_kwargs())
        self.decoder = "python" if self._native is None else "native"
        if self._native is None:
            # the sample format is a property of the DATASET instance (its
            # __getitem__ branches on raw_images), so two Python-path
            # loaders with different compact settings over one dataset
            # would corrupt each other's feed; native loaders never call
            # __getitem__
            prev = getattr(dataset, "_batchloader_compact", None)
            if prev is not None and prev != compact:
                raise ValueError(
                    f"dataset instance already driven by a BatchLoader("
                    f"compact={prev}); compact={compact} would change its "
                    "sample format under that loader — use separate dataset "
                    "instances")
            dataset.raw_images = compact
            dataset._batchloader_compact = compact

    def set_epoch(self, epoch: int) -> None:
        """Reseeds the shuffle (deterministic per epoch)."""
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        return np.random.RandomState(self.seed + self.epoch).permutation(n)

    def _assemble(self, samples) -> dict:
        bh, bw = self.bucket_hw
        b = self.batch_size
        img_dtype = np.uint8 if self.compact else np.float32
        lbl_dtype = np.int8 if self.compact else np.int32
        image = np.zeros((b, bh, bw, 3), img_dtype)
        label = np.full((b, bh, bw), PAD_LABEL, lbl_dtype)
        sizes = np.zeros((b, 2), np.int32)
        ids = [""] * b
        for i, s in enumerate(samples):
            img, lbl = pad_to_bucket(s["image"], s["label"], self.bucket_hw)
            if self.compact and lbl.size and (
                    lbl.max() > 127 or lbl.min() < -1):
                # int8 narrowing must keep every value (ids < 128, ignore
                # -1): a wrapped value would become a wrong class
                raise ValueError(
                    f"sample {s['id']!r}: label range [{lbl.min()}, "
                    f"{lbl.max()}] does not fit the compact int8 feed")
            image[i], label[i] = img, lbl
            sizes[i] = s["size"]
            ids[i] = s["id"]
        return {"image": image, "label": label, "sizes": sizes, "ids": ids,
                "num_real": len(samples)}

    def _assemble_native(self, loader, label_kwargs, chunk) -> dict:
        ids = [self.dataset.ids[i] for i in chunk]
        n, b = len(chunk), self.batch_size
        bh, bw = self.bucket_hw
        img_dtype = torch.uint8 if self.compact else torch.float32
        lbl_dtype = torch.int8 if self.compact else torch.int32
        shapes = {"image": ((b, bh, bw, 3), img_dtype),
                  "label": ((b, bh, bw), lbl_dtype),
                  "sizes": ((b, 2), torch.int32)}
        # pinned: the caching host allocator's blocks; the copy to the card
        # is issued on these tensors, so the allocator's events keep a block
        # from reuse until its copy is done
        host = {k: torch.empty(shape, dtype=dtype,
                               pin_memory=self.pin_memory)
                for k, (shape, dtype) in shapes.items()}
        arrays = {k: t.numpy() for k, t in host.items()}
        loader.load_batch(
            [self.dataset.image_path(d) for d in ids],
            [self.dataset.label_path(d) for d in ids], self.bucket_hw,
            num_threads=self.num_threads, compact=self.compact,
            out=tuple(arrays[k][:n] for k in ("image", "label", "sizes")),
            **label_kwargs)
        # pad with all-ignore dummies (static shapes)
        arrays["image"][n:] = 0
        arrays["label"][n:] = PAD_LABEL
        arrays["sizes"][n:] = 0
        with _count_lock:
            _kernels.launch_counts["native_batches"] += 1
        batch = {**arrays, "ids": ids + [""] * (b - n), "num_real": n}
        if self.pin_memory:
            batch["pinned"] = host
        return batch

    def __iter__(self):
        order = self._order()
        if self.drop_remainder:
            order = order[:len(order) - len(order) % self.batch_size]
        chunks = [order[i:i + self.batch_size]
                  for i in range(0, len(order), self.batch_size)]

        out: queue.Queue = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()

        def _put(item) -> bool:
            # a bounded put that observes stop: a consumer that abandons the
            # iteration sets stop, and a producer parked on a full queue
            # would otherwise never see it
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # any decode error must reach the consumer: a dead producer with
            # no sentinel would deadlock the training loop
            try:
                if self._native is not None:
                    loader, kwargs = self._native
                    for chunk in chunks:
                        if stop.is_set():
                            return
                        if not _put(self._assemble_native(loader, kwargs,
                                                          chunk)):
                            return
                else:
                    with ThreadPoolExecutor(
                            max_workers=self.num_threads) as pool:
                        for chunk in chunks:
                            if stop.is_set():
                                return
                            samples = list(pool.map(
                                self.dataset.__getitem__, chunk))
                            if not _put(self._assemble(samples)):
                                return
            except BaseException as e:  # noqa: BLE001 — re-raised below
                _put(e)
                return
            _put(None)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                batch = out.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()


class SyntheticDataset:
    """Deterministic random dataset for tests and measurements.

    Images and labels follow the real datasets' contract (float32 HWC
    around 0, or uint8 RGB when `raw_images`; int32 labels with some -1
    ignore pixels) without touching disk; the draws equal the JAX
    package's SyntheticDataset for the same seed and index.
    """

    dataset_name = "synthetic"
    raw_images = False  # set by BatchLoader(compact=True): emit uint8 RGB

    def __init__(self, num_images: int = 64, *, num_classes: int = 21,
                 size_range: tuple[int, int] = (320, 500), seed: int = 0,
                 class_names: tuple[str, ...] | None = None):
        self.num_images = num_images
        self.num_classes = num_classes
        self.size_range = size_range
        self.seed = seed
        self.class_names = class_names or tuple(
            f"class_{i}" for i in range(num_classes))

    def __len__(self) -> int:
        return self.num_images

    def __getitem__(self, index: int) -> dict:
        rng = np.random.Generator(
            np.random.SFC64(self.seed * 100003 + int(index)))
        lo, hi = self.size_range
        h = int(rng.integers(lo, hi + 1))
        w = int(rng.integers(lo, hi + 1))
        if self.raw_images:
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        else:
            img = rng.standard_normal((h, w, 3), dtype=np.float32) * 40.0
        # blocky labels (coarse random class regions) + sparse ignore pixels
        ch = rng.integers(0, self.num_classes, size=(8, 8))
        lbl = np.kron(ch, np.ones((-(-h // 8), -(-w // 8)), np.int64))[:h, :w]
        lbl = lbl.astype(np.int32)
        ign = rng.integers(0, h * w, size=h * w // 50)
        lbl.ravel()[ign] = -1
        return {"image": img, "label": lbl, "id": f"synthetic_{index}",
                "size": (h, w)}
