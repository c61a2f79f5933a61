"""Builds the CUDA sources under `csrc/` and binds them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use into its own shared library,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

keyed by a hash of the source, the shared headers (`csrc/*.cuh`) and the
flags, so an edited source rebuilds and an unchanged one loads at once. `build()` starts one `nvcc` per source,
all together. Pointers go in as `c_void_p`, ints as `c_int`, and the stream
is PyTorch's current stream. Every C entry point returns
`cudaGetLastError()`; `check` raises when it is not 0.

`launch_counts` counts, per kernel, the launches its wrapper made: the
wrapper adds one where it launches its kernel and nowhere else, so a run can
show that a path went through the kernel. A library may hold more than one
kernel (`block1_train`: K3 forward and K4 backward; `costail_fused`: K5 and
K6), so the counts have keys of their own; the keys of the one-kernel
libraries `conv1_1` (K8), `pool_bwd` (K9), `rowdot` (K10b) and
`conv7x7_igemm` (fc6's forward) are the wrappers' names; `ring_pad` holds
two, counted as `ring_pad` (the pad) and `ring_sum` (its constant's
gradient). K7 (`pdot`) counts every launch under `pdot` and each
variant's under `pdot_<variant>` as well. `native_batches` is no
kernel's: it counts the batches the native decoder (`data/native.py`)
wrote, added by `data.pipeline.BatchLoader`;
nor is `bn_folds`: the frozen batch norms `models.deeplab` folded into
its convolutions, one a load of weights.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = osp.dirname(osp.dirname(osp.abspath(__file__)))
CSRC_DIR = osp.join(_PKG_DIR, "csrc")
BUILD_DIR = osp.join(_PKG_DIR, "_build")
KERNELS = ("szn_fused", "block1_fused", "block1_train", "costail_fused",
           "pdot", "conv1_1", "pool_bwd", "rowdot", "conv7x7_igemm",
           "ring_pad")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launch_counts = {name: 0 for name in (
    "szn_fused", "block1_fused", "block1_train_fwd", "block1_train_bwd",
    "costail_fwd", "costail_bwd", "pdot", "pdot_fp32", "pdot_fp32_narrow",
    "pdot_fp32_scalar", "pdot_fp32_narrow_scalar", "pdot_wmma",
    "pdot_tma", "pdot_narrow", "conv1_1_pairs", "pool_bwd", "rowdot",
    "conv7x7_igemm", "ring_pad", "ring_sum", "native_batches",
    "bn_folds")}
build_logs: dict[str, str] = {}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), osp.join(cuda_home, "bin", "nvcc")):
        if cand and osp.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in (f"{name}.cu", *headers):
        with open(osp.join(CSRC_DIR, f), "rb") as fh:
            digest.update(fh.read())
    return osp.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names=KERNELS) -> dict[str, float]:
    """Compiles every named kernel that is not built yet, one `nvcc` process
    per source, all started together. Returns the wall seconds each build
    took (0.0 for a library already built)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    seconds = {name: 0.0 for name in names}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if osp.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               osp.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def function(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point `fn_name` of kernel library `lib_name`, built and
    loaded on first use, with its argument types declared."""
    with _lock:
        lib = _libs.get(lib_name)
        if lib is None:
            build((lib_name,))
            lib = ctypes.CDLL(_lib_path(lib_name))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[lib_name] = lib
    fn = getattr(lib, fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(lib_name: str, rc: int) -> None:
    if rc != 0:
        msg = _libs[lib_name].kernel_error_string(rc).decode()
        raise RuntimeError(f"{lib_name}: CUDA error {rc} at launch: {msg}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
