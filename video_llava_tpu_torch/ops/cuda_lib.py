"""Build, load and launch the port's CUDA kernels.

Each source under ``video_llava_tpu_torch/csrc`` compiles with its own
``nvcc`` process, all started together, and the objects link into one
shared library with a plain C interface, bound with ctypes. Without
PyTorch's headers the build takes seconds. The library is built
at first use into ``video_llava_tpu_torch/build/`` under a name that
hashes the sources and flags, so an edited source rebuilds and nothing
stale is loaded. ``ptxas -v`` output (registers, shared memory, spills
per kernel) is kept beside it as ``<name>.log``.

Every C entry point launches on the stream it is given, allocates
nothing and returns ``cudaGetLastError()``; :func:`launch` raises when
that is not 0 and counts the launch in :data:`LAUNCHES` otherwise.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> successful launches since the last reset_launch_counts()
LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point (all return int: a cudaError_t).
_SIGNATURES = {
    "vlt_flash_bhsd": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "vlt_spatio_temporal_pool": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "vlt_pool_rows_per_block": (),
    "vlt_decode_attention": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P,
    ),
    "vlt_w4a8_matvec": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "vlt_w4a8_block": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}

_lib = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _sources():
    return sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cu"))
        + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    )


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required "
                           "to build the kernels")
    return path


def build() -> str:
    """Compile csrc/ into the shared library (if not built yet) and
    return its path."""
    sources = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    out = os.path.join(BUILD_DIR, f"libvlt_kernels_{h.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    cu = [s for s in sources if s.endswith(".cu")]
    objs, procs = [], []
    for src in cu:
        obj = f"{tmp}.{os.path.basename(src)}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]  # every build runs to its end
    failed = [(src, log) for src, log, p in zip(cu, logs, procs)
              if p.returncode != 0]
    link = None
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed or link.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{src}:\n{log}" for src, log in failed) + (
                "" if link is None else link.stdout + link.stderr))
    with open(out[:-3] + ".log", "w") as f:
        f.write("".join(logs) + link.stdout + link.stderr)
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.vlt_error_string.argtypes = [ctypes.c_int]
            lib.vlt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry point `entry` on `device`'s current stream (appended
    as the last argument), raise on a CUDA error, count one launch of
    `kernel`."""
    lib = library()
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"{kernel}: CUDA error {rc}: {lib.vlt_error_string(rc).decode()}"
        )
    LAUNCHES[kernel] += 1


def require(t: torch.Tensor, name: str, dtype, shape=None,
            device=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor (on `device` when
    given) of `dtype` (and `shape`), 16-byte aligned, as every kernel
    reads it."""
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a tensor on "
                         f"{device or 'a CUDA device'}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")
