"""ctypes binding of the port's native data path (`csrc/zss_loader.cc`; the
JAX package's data/native.py).

The C++ library fuses JPEG/PNG/MAT decode, the BGR mean-subtraction
transform, the label remaps and pad-to-bucket assembly, and decodes a batch
on a thread pool without the GIL, writing it into the caller's buffers.
It is host code, built at first use with the host compiler,

    g++ -O3 -std=c++17 -fPIC -shared -march=native -Wall <jpeg flags>
        -o _build/zss_loader-<hash>.so csrc/zss_loader.cc <jpeg libs> -lz
        -lpthread

keyed by a hash of the source, the flags and the compiler's version, into
the package's git-ignored `_build/` (compiled to a temporary name and
renamed into place, so processes that build at once do not collide). JPEG
goes through libjpeg where the compiler finds `jpeglib.h`, else through
nvJPEG from the CUDA toolkit (`$CUDA_HOME`, default /usr/local/cuda); PNG
and MAT labels through the library's own readers over zlib.

With nvJPEG the JPEGs of a batch decode on the CUDA device the caller
names (`load_batch(..., device=ordinal)`, the device the loader feeds: a
rank's own card on a mesh); every pool thread binds it before its first
nvJPEG call, and an ordinal that cannot be set raises. `build_info()`'s
"device" is the ordinal of the process's latest nvJPEG decode. The libjpeg
backend ignores the device.

Unlike the JAX binding, which reports a missing library as
`available() == False` and lets its callers decode with PIL, a build that
fails raises with the compiler's output: a loader asked for the native
path never falls back quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import os.path as osp
import shutil
import subprocess
import threading
import time

import numpy as np

_PKG_DIR = osp.dirname(osp.dirname(osp.abspath(__file__)))
SOURCE = osp.join(_PKG_DIR, "csrc", "zss_loader.cc")
BUILD_DIR = osp.join(_PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-march=native",
             "-Wall")


class DecodeError(IOError):
    """A negative return code of the library (`rc`); for -2 (larger than
    the bucket) `size` is the file's (h, w)."""

    def __init__(self, msg: str, rc: int, size: tuple[int, int] | None = None):
        super().__init__(msg)
        self.rc = rc
        self.size = size


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("the native decoder needs a C++ compiler: no g++ "
                           "on PATH and CXX is not set")
    return cxx


def _finds_header(cxx: str, header: str) -> bool:
    proc = subprocess.run([cxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                          input=f"#include <{header}>\n", text=True,
                          capture_output=True, timeout=60)
    return proc.returncode == 0


def _backend(cxx: str) -> tuple[list[str], list[str]]:
    """(compile flags, link flags) of the JPEG backend: libjpeg where the
    compiler finds jpeglib.h, else nvJPEG; raises when neither is there."""
    if _finds_header(cxx, "jpeglib.h"):
        return ["-DZSS_JPEG_LIBJPEG"], ["-ljpeg"]
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if not osp.isfile(osp.join(cuda, "include", "nvjpeg.h")):
        raise RuntimeError(
            "the native decoder needs a JPEG decoder: the compiler finds no "
            f"jpeglib.h and there is no {cuda}/include/nvjpeg.h (set "
            "CUDA_HOME)")
    lib = osp.join(cuda, "lib64")
    return (["-DZSS_JPEG_NVJPEG", f"-I{osp.join(cuda, 'include')}"],
            [f"-L{lib}", f"-Wl,-rpath,{lib}", "-lnvjpeg", "-lcudart"])


build_log: dict = {"command": None, "output": "", "seconds": 0.0}


def build() -> str:
    """Builds the library unless it is built already; returns its path.
    Raises RuntimeError with the compiler's output when the build fails."""
    cxx = _cxx()
    cflags, libs = _backend(cxx)
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    digest = hashlib.sha256(
        " ".join([*CXX_FLAGS, *cflags, *libs, version]).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    out = osp.join(BUILD_DIR, f"zss_loader-{digest.hexdigest()[:16]}.so")
    if osp.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cxx, *CXX_FLAGS, *cflags, "-o", tmp, SOURCE, *libs, "-lz",
           "-lpthread"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    build_log.update(command=" ".join(cmd),
                     output=proc.stdout + proc.stderr,
                     seconds=time.perf_counter() - t0)
    if proc.returncode:
        if osp.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building the native decoder failed:\n"
                           f"{build_log['command']}\n{build_log['output']}")
    os.replace(tmp, out)
    return out


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeLoader:
    _instance = None
    _lock = threading.Lock()

    def __init__(self, lib_path: str):
        self.path = lib_path
        self._lib = lib = ctypes.CDLL(lib_path)
        lib.zss_decode_image.restype = ctypes.c_int
        lib.zss_decode_image.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.zss_decode_label.restype = ctypes.c_int
        lib.zss_decode_label.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        batch_args = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        for fn in (lib.zss_load_batch, lib.zss_load_batch_compact):
            fn.restype = ctypes.c_int
            fn.argtypes = batch_args
        lib.zss_build_info.restype = ctypes.c_int
        lib.zss_build_info.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.zss_set_device.restype = ctypes.c_int
        lib.zss_set_device.argtypes = [ctypes.c_int]

    @classmethod
    def get(cls) -> "NativeLoader":
        """The process's loader, built on first use; raises when the build
        fails."""
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls(build())
            return cls._instance

    def build_info(self) -> dict:
        """The toolchain the library was built with (compiler, JPEG
        backend and version, PNG reader, zlib) and "device", the CUDA
        ordinal of the latest nvJPEG decode (None before the first and with
        libjpeg)."""
        buf = ctypes.create_string_buffer(1024)
        rc = self._lib.zss_build_info(buf, len(buf))
        if rc != 0:
            raise RuntimeError(f"zss_build_info failed rc={rc}")
        return json.loads(buf.value.decode())

    # ------------------------------------------------------------------

    def set_device(self, device: int | None) -> None:
        """The CUDA ordinal this thread's later decodes run on (nvJPEG);
        None: the thread's current device when a decode starts. Raises for
        an ordinal the machine does not have."""
        ordinal = -1 if device is None else int(device)
        rc = self._lib.zss_set_device(ordinal)
        if rc != 0:
            raise RuntimeError(f"zss_set_device({ordinal}) failed rc={rc}: "
                               "the decoder cannot run on that device")

    def decode_image(self, path: str, bucket_hw: tuple[int, int]
                     ) -> tuple[np.ndarray, tuple[int, int]]:
        bh, bw = bucket_hw
        out = np.empty((bh, bw, 3), np.float32)
        size = (ctypes.c_int * 2)()
        rc = self._lib.zss_decode_image(path.encode(),
                                        _ptr(out, ctypes.c_float), bh, bw,
                                        size)
        if rc != 0:
            raise DecodeError(f"zss_decode_image({path!r}) failed rc={rc}",
                              rc)
        return out, (size[0], size[1])

    def decode_label(self, path: str, bucket_hw: tuple[int, int], *,
                     value_offset: int = 0, map255_to_ignore: bool = True
                     ) -> tuple[np.ndarray, tuple[int, int]]:
        bh, bw = bucket_hw
        out = np.empty((bh, bw), np.int32)
        size = (ctypes.c_int * 2)()
        rc = self._lib.zss_decode_label(
            path.encode(), _ptr(out, ctypes.c_int32), bh, bw, value_offset,
            int(map255_to_ignore), size)
        if rc != 0:
            raise DecodeError(
                f"zss_decode_label({path!r}) failed rc={rc}", rc,
                (size[0], size[1]) if rc == -2 else None)
        return out, (size[0], size[1])

    def load_batch(self, image_paths: list[str], label_paths: list[str],
                   bucket_hw: tuple[int, int], *, value_offset: int = 0,
                   map255_to_ignore: bool = True, num_threads: int = 4,
                   compact: bool = False, out=None, device: int | None = None
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """compact=True: uint8 RGB images + int8 labels (device-side
        normalization, 4x fewer feed bytes). `out`, optional: the
        (images, labels, sizes) arrays to decode into, C-contiguous, one
        row a path, of the dtypes the call returns (the loader passes
        views of pinned buffers); a label slot whose path is None is
        filled with -1. `device`: the CUDA ordinal nvJPEG decodes on (as
        in `set_device`)."""
        n = len(image_paths)
        if len(label_paths) != n:
            # a shorter list would silently pad the ctypes array with NULLs,
            # which the C worker treats as "no label" → all-ignore samples
            raise ValueError(f"label_paths has {len(label_paths)} entries "
                             f"for {n} images")
        bh, bw = bucket_hw
        img_dtype, lbl_dtype = ((np.uint8, np.int8) if compact
                                else (np.float32, np.int32))
        if out is None:
            images = np.zeros((n, bh, bw, 3), img_dtype)
            labels = np.full((n, bh, bw), -1, lbl_dtype)
            sizes = np.zeros((n, 2), np.int32)
        else:
            images, labels, sizes = out
            for a, shape, dtype in ((images, (n, bh, bw, 3), img_dtype),
                                    (labels, (n, bh, bw), lbl_dtype),
                                    (sizes, (n, 2), np.int32)):
                if (a.shape != shape or a.dtype != dtype
                        or not a.flags.c_contiguous or not a.flags.writeable):
                    raise ValueError(
                        f"out array {a.dtype}{a.shape} is not a writable "
                        f"C-contiguous {np.dtype(dtype)}{shape}")
            for i, p in enumerate(label_paths):
                if not p:
                    labels[i] = -1
        self.set_device(device)
        img_arr = (ctypes.c_char_p * n)(*[p.encode() for p in image_paths])
        lbl_arr = (ctypes.c_char_p * n)(
            *[p.encode() if p else None for p in label_paths])
        fn = (self._lib.zss_load_batch_compact if compact
              else self._lib.zss_load_batch)
        rc = fn(img_arr, lbl_arr, n, images.ctypes.data, labels.ctypes.data,
                _ptr(sizes, ctypes.c_int), bh, bw, value_offset,
                int(map255_to_ignore), num_threads)
        if rc != 0:
            raise DecodeError(f"zss_load_batch failed rc={rc}", rc)
        return images, labels, sizes
